"""The port's suites (``jepsen_tpu_torch.suites.etcd``,
``jepsen_tpu_torch.suites.txn``) and the demo's test maps against the
JAX package's.

The etcd stub runs end to end through the port's ``core.run`` with
``device="cpu"``; the partition nemesis's and ``EtcdDB``'s command
streams on the dummy remote, the ``test-all`` matrix and every demo
test map (workload x bug x nemesis) equal the JAX package's, apart from
the device routing (the ``device`` key, the checkers' and the monitor's
``device``) and the objects' identities. The txn suite runs clean,
caught and under the contained clock nemesis. One subprocess proves the
etcd suite's hard time limit at the real process boundary. Tolerance:
equality."""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import control as jc
from jepsen_tpu import demo as jdemo
from jepsen_tpu import net as jnet
from jepsen_tpu import store as jstore
from jepsen_tpu.suites import etcd as jetcd
from jepsen_tpu.suites import txn as jtxn
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core, demo, net, store
from jepsen_tpu_torch.suites import etcd, txn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU searches run small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jstore"))


def _opts(**kw):
    opts = {"nodes": ["n1", "n2", "n3"], "stub": True, "concurrency": 12,
            "time-limit": 1, "name": None, "device": "cpu"}
    opts.update(kw)
    return opts


# ---------------------------------------------------------------------------
# etcd

def test_register_workload_stub_end_to_end():
    random.seed(45100)
    done = core.run(etcd.etcd_test(_opts(workload="register")))
    res = done["results"]
    assert res["valid"] is True
    assert res["workload"]["valid"] is True
    assert any(o for o in done["history"]
               if o.get("f") in ("read", "write", "cas"))
    d = store.path(done)
    assert os.path.exists(os.path.join(d, "results.json"))
    assert os.path.exists(os.path.join(d, "timeline.html"))


def test_set_workload_stub_end_to_end():
    random.seed(45100)
    done = core.run(etcd.etcd_test(_opts(workload="set",
                                         **{"op-count": 30})))
    assert done["results"]["workload"]["valid"] is True
    assert done["results"]["workload"]["lost-count"] == 0


def test_partition_run_heals_at_the_end():
    random.seed(45100)
    done = core.run(etcd.etcd_test(_opts(
        workload="set", nemesis=["partition"],
        **{"nemesis-interval": 0.3, "time-limit": 1, "op-count": 30})))
    assert any("iptables" in cmd for _, cmd in done.get("dummy-log", []))
    nem_fs = [o["f"] for o in done["history"]
              if o.get("process") == "nemesis"]
    assert "start-partition" in nem_fs and nem_fs[-1] == "stop-partition"


def _partition_stream(side):
    mod, ctl, nt = (etcd, c, net) if side == "torch" \
        else (jetcd, jc, jnet)
    random.seed(45100)
    opts = _opts(workload="set", nemesis=["partition"])
    if side == "jax":
        opts.pop("device")
    test = mod.etcd_test(opts)
    test = {**test, "ssh": {"dummy?": True}, "net": nt.iptables}
    out = []
    with ctl.ssh_scope(test):
        nem = test["nemesis"].setup(test)
        for spec in ("one", "majority", "majorities-ring",
                     "minority-third"):
            done = nem.invoke(test, {"type": "info", "process": "nemesis",
                                     "f": "start-partition",
                                     "value": spec})
            out.append((done["f"], repr(done["value"])))
            out.append(nem.invoke(test, {"type": "info",
                                         "process": "nemesis",
                                         "f": "stop-partition"})["value"])
        nem.teardown(test)
    return out, sorted(cmd for _, cmd in test["dummy-log"])


def test_partition_nemesis_stream_matches_jax():
    ours, theirs = _partition_stream("torch"), _partition_stream("jax")
    assert ours == theirs
    assert any("iptables" in cmd for cmd in ours[1])


def _db_stream(side):
    mod, ctl = (etcd, c) if side == "torch" else (jetcd, jc)
    test = {"nodes": ["n1", "n2"], "ssh": {"dummy?": True}}
    db = mod.EtcdDB()
    with ctl.ssh_scope(test), ctl.on("n1"):
        out = [db.start(test, "n1"), db.kill(test, "n1"),
               db.pause(test, "n1"), db.resume(test, "n1"),
               db.log_files(test, "n1")]
        for step in (db.setup, db.teardown):
            try:
                step(test, "n1")
            except Exception as exc:  # noqa: BLE001 - compared
                out.append(type(exc).__name__)
    return out, [cmd for _, cmd in test["dummy-log"]]


def test_etcd_db_command_stream_matches_jax():
    ours = _db_stream("torch")
    assert ours == _db_stream("jax")
    cmds = ours[1]
    assert any("--initial-cluster" in x
               and "n1=http://n1:2380,n2=http://n2:2380" in x for x in cmds)
    assert any("STOP" in x for x in cmds) and any("CONT" in x for x in cmds)


def _matrix(tests):
    return [(t["name"], sorted(t["nemesis"].fs()), t["concurrency"],
             sorted(k for k in t if k != "device")) for t in tests]


def test_all_tests_matrix_matches_jax():
    ours = _matrix(etcd.all_tests(_opts()))
    theirs = _matrix(jetcd.all_tests({k: v for k, v in _opts().items()
                                      if k != "device"}))
    assert ours == theirs
    assert len(ours) == 2 * (1 + len(etcd.NEMESES)) \
        and etcd.NEMESES == jetcd.NEMESES


def test_stub_create_is_atomic():
    from jepsen_tpu_torch.independent import tuple_ as T
    a = etcd.StubRegisterClient().open({}, "n1")
    assert a.invoke({}, {"f": "create", "value": T(0, "x")})["type"] == "ok"
    assert a.invoke({}, {"f": "create", "value": T(0, "y")})["type"] \
        == "fail"
    assert a.invoke({}, {"f": "read", "value": T(0, None)})["value"][1] \
        == "x"


def test_cli_main_stub():
    random.seed(45100)
    with pytest.raises(SystemExit) as exc:
        etcd.main(["test", "--stub", "--node", "n1", "--node", "n2",
                   "--workload", "register", "--time-limit", "1",
                   "--device", "cpu"])
    assert exc.value.code == 0
    assert store.latest()["results"]["valid"] is True


def test_hard_time_limit_salvages_at_the_process_boundary(tmp_path):
    # one intra-op thread, as the in-process tests run
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.etcd", "test",
         "--stub", "--no-ssh", "--node", "n1", "--node", "n2", "--node",
         "n3", "--workload", "register", "--time-limit", "60",
         "--hard-time-limit", "2", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    d = tmp_path / "store" / "latest"
    with open(d / "results.json") as f:
        res = json.load(f)
    assert res["salvaged"] is True and res["abort-reason"] == "time-limit"
    assert not (d / "history.jsonl.journal").exists()
    assert r.returncode == {True: 0, False: 1}.get(res["valid"], 2), \
        r.stderr[-2000:]


# ---------------------------------------------------------------------------
# txn

def _txn_run(**kw):
    random.seed(45100)
    opts = {"nodes": ["n1"], "time-limit": 1, "device": "cpu",
            "ssh": {"dummy?": True}}
    opts.update(kw)
    return core.run(txn.txn_test(opts))


@pytest.mark.parametrize("workload", ["append", "wr"])
def test_txn_workloads_valid(workload):
    done = _txn_run(workload=workload)
    assert done["results"]["valid"] is True
    assert [o for o in done["history"] if o.get("f") == "txn"]


def test_txn_future_read_caught_mid_run():
    done = _txn_run(workload="append", bug="future-read",
                    monitor={"chunk": 8}, **{"time-limit": 5})
    res = done["results"]
    assert res["abort-reason"] == "monitor-violation"
    assert res["valid"] is False and res["monitor"]["verdict"] is False
    assert any(a.startswith("G1c")
               for a in res["workload"]["anomaly_types"])


def test_txn_faketime_nemesis_is_contained():
    done = _txn_run(workload="append", nemesis="faketime")
    nem = [o for o in done["history"] if o.get("process") == "nemesis"]
    assert done["results"]["valid"] is True
    assert nem and all(o["type"] == "info" for o in nem)
    assert any(isinstance(o.get("value"), list)
               and o["value"][0] == "nemesis-unavailable" for o in nem)


# ---------------------------------------------------------------------------
# the demo's test maps

def _plain(x):
    """A test map's values with the objects' identities taken out: an
    object is its class name and its plain attributes."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(repr(_plain(v)) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return type(x).__name__


def _demo_map(mod, **kw):
    random.seed(45100)
    t = mod.demo_test({"nodes": ["n1", "n2"], "time-limit": 5, **kw})
    keep = {k: _plain(v) for k, v in t.items()
            if k not in ("generator", "checker", "db", "client",
                         "nemesis", "os", "device")}
    keep["classes"] = [type(t[k]).__name__ for k in
                       ("db", "client", "nemesis", "os")]
    mon = keep.get("monitor")
    if isinstance(mon, dict):
        mon.pop("engine-opts", None)
    return keep


@pytest.mark.parametrize("workload", sorted(jdemo.WORKLOADS))
def test_demo_test_maps_match_jax(workload):
    for bug in (None, "lost-write", "dirty-read", "stale-read",
                "future-read"):
        for nemesis in (None, "none", "faketime", "charybdefs"):
            for monitor in (None, {"chunk": 8}):
                kw = {"workload": workload, "bug": bug, "nemesis": nemesis,
                      "monitor": monitor}
                theirs = _demo_map(jdemo, **kw)
                ours = _demo_map(demo, device="cpu", **kw)
                assert ours == theirs, kw
    assert sorted(demo.WORKLOADS) == sorted(jdemo.WORKLOADS)
    assert demo.TXN_WORKLOADS == jdemo.TXN_WORKLOADS


def test_demo_routes_the_device():
    reg = demo.demo_test({"nodes": ["n1"], "workload": "register",
                          "device": "cpu", "monitor": True})
    assert reg["device"] == "cpu"
    assert reg["monitor"]["engine-opts"] == {"device": "cpu"}
    app = demo.demo_test({"nodes": ["n1"], "workload": "append",
                          "device": "cpu", "monitor": {"chunk": 8}})
    assert app["monitor"] == {"chunk": 8, "family": "txn",
                              "workload": "append",
                              "engine-opts": {"device": "cpu"}}
    assert "device" not in demo.demo_test({"nodes": ["n1"],
                                           "workload": "noop"})


def test_txn_test_maps_match_jax():
    for wname in sorted(jtxn.WORKLOADS):
        for bug in (None, "future-read", "dirty-read"):
            for nemesis in ("none", "faketime", "charybdefs"):
                kw = {"nodes": ["n1"], "workload": wname, "bug": bug,
                      "nemesis": nemesis, "monitor": True,
                      "skew-bound-s": 0.5}
                random.seed(45100)
                t = jtxn.txn_test(dict(kw))
                random.seed(45100)
                o = txn.txn_test(dict(kw, device="cpu"))
                o["monitor"].pop("engine-opts")
                assert sorted(k for k in o if k != "device") == sorted(t)
                assert o["name"] == t["name"]
                assert o["monitor"] == t["monitor"]
                assert o["concurrency"] == t["concurrency"]
                assert type(o["nemesis"]).__name__ \
                    == type(t["nemesis"]).__name__
