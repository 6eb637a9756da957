"""The port's ``independent`` checker (jepsen_tpu_torch/independent.py)
against the JAX package's, both on the CPU: the cases of
tests/test_independent.py that need no generator, store or checkpoint,
run on the port; equal per-key verdicts to ``jepsen_tpu.independent`` on
the same keyed histories; and a failure of the batched device path
raises instead of falling back to per-key checks. Every comparison is on
verdicts and counts: tolerance zero."""

import random

import pytest
import torch

from jepsen_tpu import checker as jcc
from jepsen_tpu import independent as jind
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu.simulate import corrupt, random_history
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import independent, parallel
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as cc

inv = h.invoke_op
ok = h.ok_op
T = independent.tuple_
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lin(algorithm="jax-wgl", **opts):
    return ck.linearizable({"model": "cas-register", "algorithm": algorithm,
                            "engine_opts": dict(CPU), **opts})


def _keyed_history(keys, bad_keys=()):
    """Valid (or corrupted) per-key cas-register histories interleaved."""
    hist = []
    for i, k in enumerate(keys):
        p = i % 3
        hist += [
            inv(p, "write", T(k, 1)),
            ok(p, "write", T(k, 1)),
            inv(p, "read", T(k, None)),
            ok(p, "read", T(k, 99 if k in bad_keys else 1)),
        ]
    return hist


def _counting(monkeypatch):
    calls = []
    real = parallel.check_batch_encoded

    def counting(spec, pairs, **kw):
        calls.append(len(pairs))
        return real(spec, pairs, **kw)

    monkeypatch.setattr(parallel, "check_batch_encoded", counting)
    return calls


def test_tuple():
    t = T("k", 5)
    assert independent.is_tuple(t)
    assert t.key == "k" and t.value == 5
    assert not independent.is_tuple(("k", 5))
    assert not independent.is_tuple([1, 2])
    assert list(t) == ["k", 5]   # serializes like a 2-list
    assert repr(t) == repr(jind.tuple_("k", 5))


def test_history_keys_and_subhistory():
    hist = [
        inv(0, "w", T("a", 1)),
        h.op("info", "nemesis", "start", "whoops"),
        ok(0, "w", T("a", 1)),
        inv(1, "w", T("b", 2)),
        ok(1, "w", T("b", 2)),
    ]
    assert independent.history_keys(hist) == {"a", "b"}
    sub = independent.subhistory("a", hist)
    # unkeyed nemesis op appears; key b's ops don't; values unwrapped
    assert [o.get("value") for o in sub] == [1, "whoops", 1]


def test_independent_checker_splits_and_merges():
    c = independent.checker(_lin("wgl"))
    r = cc.check(c, {}, _keyed_history(["a", "b", "c"], bad_keys={"b"}))
    assert r["valid"] is False
    assert r["failures"] == ["b"]
    assert r["results"]["a"]["valid"] is True
    assert r["results"]["b"]["valid"] is False
    assert r["results"]["c"]["valid"] is True


def test_independent_checker_all_valid():
    c = independent.checker(_lin("wgl"))
    r = cc.check(c, {}, _keyed_history(list(range(4))))
    assert r["valid"] is True
    assert r["failures"] == []


def test_independent_batched_single_device_call(monkeypatch):
    """With a device-engine Linearizable inner checker, ALL keys go to
    parallel.check_batch_encoded in ONE call."""
    calls = _counting(monkeypatch)
    c = independent.checker(_lin())
    keys = list(range(6))
    r = cc.check(c, {}, _keyed_history(keys, bad_keys={2, 4}))
    assert calls == [6]        # one batched call for all six keys
    assert r["valid"] is False
    assert sorted(r["failures"]) == [2, 4]
    for k in keys:
        assert r["results"][k]["valid"] is (k not in (2, 4))
        assert r["results"][k]["valid?"] is r["results"][k]["valid"]


def test_independent_batched_through_compose(monkeypatch):
    """A Linearizable composed with another checker: the batched path
    still batches the linearizable member and runs the other members per
    key (the JAX package's case composes timeline, which the port does
    not carry; any per-key checker stands in)."""
    calls = _counting(monkeypatch)
    seen = []

    def probe(test, hist, opts):
        seen.append(opts.get("history-key"))
        return {"valid": True}

    c = independent.checker(cc.compose({"linearizable": _lin(),
                                        "probe": probe,
                                        "ok": cc.unbridled_optimism()}))
    keys = ["a", "b", "c"]
    r = cc.check(c, {}, _keyed_history(keys, bad_keys={"b"}))
    assert calls == [3]
    assert sorted(seen) == keys
    assert r["valid"] is False
    assert r["failures"] == ["b"]
    for k in keys:
        kr = r["results"][k]
        assert kr["linearizable"]["valid"] is (k != "b")
        assert kr["probe"]["valid"] is True
        assert kr["ok"]["valid"] is True
        assert kr["valid"] is (k != "b")


def test_independent_nonlinearizable_inner_uses_pmap(monkeypatch):
    """A non-Linearizable inner checker, and a Linearizable on the CPU
    oracle, go through the per-key path."""
    calls = _counting(monkeypatch)
    seen = []

    class Probe(cc.Checker):
        def check(self, test, hist, opts=None):
            seen.append(opts.get("history-key"))
            return {"valid": True}

    r = cc.check(independent.checker(Probe()), {},
                 _keyed_history(["x", "y"]))
    assert r["valid"] is True
    assert sorted(seen) == ["x", "y"]
    cc.check(independent.checker(_lin("wgl")), {}, _keyed_history(["x"]))
    assert calls == []


def test_direct_and_batched_paths_filter_identically():
    """The direct Linearizable.check and the batched independent path
    select the same client ops, so a nemesis-laced history with init ops
    gets identical verdicts on both paths."""
    keys = ["a", "b", "c"]
    hist = _keyed_history(keys, bad_keys={"b"})
    laced = [h.op("info", "nemesis", "start-partition", "part")]
    for i, o in enumerate(hist):
        laced.append(o)
        if i % 3 == 0:
            laced.append(h.op("info", "nemesis", "kill", None))
    laced.append(h.op("info", "logger", "snarf", "n1.log"))
    init = {"init-ops": [{"f": "write", "value": 1}]}
    batched = cc.check(independent.checker(_lin(**init)), {}, laced)
    for k in keys:
        direct = cc.check(_lin("wgl", **init), {},
                          independent.subhistory(k, laced))
        assert batched["results"][k]["valid"] == direct["valid"], k
    assert batched["failures"] == ["b"]


def _hard_keyed_history(keys, module):
    """Per-key 100-op corrupt-but-in-range cas histories (the search, not
    the state abstraction, must decide them), values wrapped in the
    given module's independent tuples with disjoint per-key processes."""
    hist = []
    idx = 0
    for k in keys:
        sub = corrupt(random.Random(100 + k),
                      random_history(random.Random(k), "cas-register", 6,
                                     100, 0.05))
        for o in sub:
            if o["type"] == "ok" and o["f"] == "read" \
                    and o.get("value") is not None:
                o["value"] = o["value"] % 4
        for o in sub:
            o = dict(o)
            o["process"] = o["process"] + 10 * k
            o["value"] = module.tuple_(k, o.get("value"))
            o["index"] = idx
            idx += 1
            hist.append(o)
    return hist


def test_batched_verdicts_equal_jax():
    """Harder keys decided by the search: the port's batched verdicts,
    failures and per-key search counts equal jepsen_tpu.independent's."""
    keys = list(range(5))
    got = cc.check(independent.checker(_lin()), {},
                   _hard_keyed_history(keys, independent))
    want = jcc.check(
        jind.checker(jck.linearizable({"model": "cas-register",
                                       "algorithm": "jax-wgl"})),
        {}, _hard_keyed_history(keys, jind))
    assert got["valid"] == want["valid"]
    assert got["failures"] == want["failures"]
    for k in keys:
        g, w = got["results"][k], want["results"][k]
        assert g["valid"] == w["valid"], k
        assert g.get("engine") == w.get("engine"), k


def test_batched_failure_raises(monkeypatch):
    """A failure inside the batched device path raises out of the check:
    no per-key or CPU fallback hides it."""
    def broken(spec, pairs, **kw):
        raise RuntimeError("device batch failed")

    monkeypatch.setattr(parallel, "check_batch_encoded", broken)
    c = independent.checker(_lin())
    with pytest.raises(RuntimeError, match="device batch failed"):
        cc.check(c, {}, _keyed_history(["a", "b"]))
    # an engine option the batch does not take is an error too
    c = independent.checker(ck.linearizable(
        {"model": "cas-register",
         "engine_opts": {**CPU, "rollout_kernel": "scan"}}))
    monkeypatch.undo()
    with pytest.raises(TypeError, match="rollout_kernel"):
        cc.check(c, {}, _keyed_history(["a"]))


def test_batched_path_defaults_to_cuda(monkeypatch):
    """The batched path runs on the card by default: without one it
    raises rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = independent.checker(ck.linearizable({"model": "cas-register"}))
    with pytest.raises(RuntimeError, match="CUDA"):
        cc.check(c, {}, _keyed_history(["a", "b"]))
