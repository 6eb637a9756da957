"""The port's control DSL (dummy remote) and nemesis grudge math. The
JAX package's cases (``tests/test_control_nemesis.py``, after the
reference's nemesis_test.clj and control_test.clj) run against
``jepsen_tpu_torch``; the last tests hold the grudges (same seed) and
the partitioners' command logs on the dummy remote against the JAX
package's (exact equality)."""

import random

import pytest

from jepsen_tpu import control as jc
from jepsen_tpu import nemesis as jn
from jepsen_tpu import net as jnet
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import net
from jepsen_tpu_torch import nemesis as n
from jepsen_tpu_torch.util import majority


def dummy_test(nodes=("n1", "n2", "n3", "n4", "n5")):
    return {"nodes": list(nodes), "ssh": {"dummy?": True},
            "net": net.iptables}


# -- shell escaping ----------------------------------------------------------

def test_escape():
    assert c.escape("simple") == "simple"
    assert c.escape("with space") == "'with space'"
    assert c.escape("") == "''"
    assert c.escape(None) == ""
    assert c.escape(c.lit("a | b")) == "a | b"
    assert c.escape(["a", "b c"]) == "a 'b c'"
    assert "$" not in c.escape("foo$bar").strip("'") or \
        c.escape("foo$bar").startswith("'")


# -- dummy control flow ------------------------------------------------------

def test_on_nodes_parallel_exec():
    test = dummy_test()
    with c.ssh_scope(test):
        def probe(t, node):
            return c.exec_("hostname")
        res = c.on_nodes(test, probe)
    assert set(res.keys()) == set(test["nodes"])
    log = test["dummy-log"]
    assert len(log) == 5
    assert all(cmd == "hostname" for _, cmd in log)


def test_su_and_cd_scope():
    test = dummy_test(["n1"])
    with c.ssh_scope(test):
        def go(t, node):
            with c.su(), c.cd("/tmp"):
                c.exec_("ls")
        c.on_nodes(test, go)
    host, cmd = test["dummy-log"][0]
    assert "sudo" in cmd and "cd /tmp" in cmd and "ls" in cmd


# -- grudges -----------------------------------------------------------------

def test_bisect():
    assert n.bisect([1, 2, 3, 4]) == [[1, 2], [3, 4]]
    assert n.bisect([1, 2, 3, 4, 5]) == [[1, 2], [3, 4, 5]]


def test_split_one():
    loner, rest = n.split_one(["a", "b", "c"], loner="b")
    assert loner == ["b"]
    assert rest == ["a", "c"]


def test_complete_grudge():
    g = n.complete_grudge([["a", "b"], ["c"]])
    assert g["a"] == {"c"}
    assert g["b"] == {"c"}
    assert g["c"] == {"a", "b"}


def test_bridge():
    nodes = ["a", "b", "c", "d", "e"]
    g = n.bridge(nodes)
    # bridge node (first of second half) is not in the grudge
    assert "c" not in g
    # the others drop the far side but never the bridge
    assert g["a"] == {"d", "e"}
    assert g["d"] == {"a", "b"}


@pytest.mark.parametrize("size", [3, 4, 5, 7, 9])
def test_majorities_ring(size):
    random.seed(42)
    nodes = [f"n{i}" for i in range(size)]
    g = n.majorities_ring(nodes)
    m = majority(size)
    for node in nodes:
        dropped = g.get(node, set())
        visible = size - len(dropped)
        assert visible >= m, f"{node} sees only {visible} < majority {m}"


def test_partitioner_via_dummy_net():
    test = dummy_test()
    nem = n.partition_halves()
    with c.ssh_scope(test):
        nem = nem.setup(test)
        out = nem.invoke(test, {"type": "info", "f": "start",
                                "process": "nemesis", "value": None})
        assert out["value"][0] == "isolated"
        heal = nem.invoke(test, {"type": "info", "f": "stop",
                                 "process": "nemesis", "value": None})
        assert heal["value"] == "network-healed"
    cmds = [cmd for _, cmd in test["dummy-log"]]
    assert any("iptables -A INPUT -s" in cmd for cmd in cmds)
    assert any("iptables -F" in cmd for cmd in cmds)


def test_compose_reflection_routing():
    class A(n.Nemesis):
        def invoke(self, test, op):
            return {**op, "type": "info", "value": "a"}

        def fs(self):
            return {"a1", "a2"}

    class B(n.Nemesis):
        def invoke(self, test, op):
            return {**op, "type": "info", "value": "b"}

        def fs(self):
            return {"b1"}

    nem = n.compose([A(), B()])
    assert nem.fs() == {"a1", "a2", "b1"}
    out = nem.invoke({}, {"f": "b1", "type": "info", "process": "nemesis"})
    assert out["value"] == "b"
    with pytest.raises(ValueError):
        nem.invoke({}, {"f": "nope", "type": "info", "process": "nemesis"})


def test_compose_explicit_specs():
    class P(n.Nemesis):
        def invoke(self, test, op):
            return {**op, "type": "info", "value": op["f"]}

        def fs(self):
            return {"start", "stop"}

    # set spec: f passes through unchanged
    nem = n.compose({frozenset({"start", "stop"}): P()})
    out = nem.invoke({}, {"f": "start", "type": "info",
                          "process": "nemesis"})
    assert out["f"] == "start" and out["value"] == "start"

    # dict spec: f is renamed before reaching the child
    nem2 = n.compose({n.frozendict({"split-start": "start",
                                    "split-stop": "stop"}): P()}) \
        if hasattr(n, "frozendict") else None
    # dict keys must be hashable; plain dicts aren't, so Compose accepts
    # a tuple-of-pairs instead? No: use the callable spec.
    nem3 = n.compose({(lambda f: {"split-start": "start",
                                  "split-stop": "stop"}.get(f)): P()})
    out3 = nem3.invoke({}, {"f": "split-start", "type": "info",
                            "process": "nemesis"})
    assert out3["f"] == "split-start" and out3["value"] == "start"


def test_f_map_lifts():
    p = n.partition_halves()
    lifted = n.f_map({"start": "part-start", "stop": "part-stop"}, p)
    assert lifted.fs() == {"part-start", "part-stop"}


def test_invert_grudge():
    g = n.invert_grudge(["a", "b", "c"], {"a": {"a", "b"}})
    assert g["a"] == {"c"}
    assert g["b"] == {"a", "b", "c"}


# -- parity with the JAX package ------------------------------------------

NODES = ["n1", "n2", "n3", "n4", "n5"]

#: name -> grudge(nemesis package) under a seeded ``random``
GRUDGES = {
    "complete_bisect": lambda p: p.complete_grudge(p.bisect(NODES)),
    "complete_bisect_odd": lambda p: p.complete_grudge(
        p.bisect(NODES + ["n6", "n7"])),
    "bridge": lambda p: p.bridge(NODES),
    "split_one": lambda p: p.complete_grudge(p.split_one(NODES)),
    "majorities_ring": lambda p: p.majorities_ring(NODES),
    "majorities_ring_7": lambda p: p.majorities_ring(
        [f"n{i}" for i in range(7)]),
    "invert": lambda p: p.invert_grudge(NODES, {"n1": {"n2"}}),
}


@pytest.mark.parametrize("seed", [1, 45100])
@pytest.mark.parametrize("name", sorted(GRUDGES))
def test_grudges_equal_jax(name, seed):
    random.seed(seed)
    ours = GRUDGES[name](n)
    random.seed(seed)
    theirs = GRUDGES[name](jn)
    assert ours == theirs


PARTITIONERS = ("partition_halves", "partition_random_halves",
                "partition_random_node", "partition_majorities_ring")


def _command_log(pkg_c, pkg_n, pkg_net, name, seed):
    test = {"nodes": list(NODES), "ssh": {"dummy?": True},
            "net": pkg_net.iptables}
    random.seed(seed)
    nem = getattr(pkg_n, name)()
    outs = []
    with pkg_c.ssh_scope(test):
        nem = nem.setup(test)
        for f in ("start", "stop", "start", "stop"):
            outs.append(nem.invoke(test, {"type": "info", "f": f,
                                          "process": "nemesis",
                                          "value": None})["value"])
        nem.teardown(test)
    log = test["dummy-log"]
    per_host = {h: [cmd for h2, cmd in log if h2 == h]
                for h in sorted({h for h, _ in log})}
    return outs, per_host


@pytest.mark.parametrize("name", PARTITIONERS)
def test_partitioner_command_log_equals_jax(name):
    """Each node's commands on the dummy remote, in order, and the
    nemesis's completions equal the JAX package's."""
    ours = _command_log(c, n, net, name, 7)
    theirs = _command_log(jc, jn, jnet, name, 7)
    assert ours[1], "no commands recorded"
    assert any("iptables" in cmd for cmds in ours[1].values()
               for cmd in cmds)
    assert ours == theirs

