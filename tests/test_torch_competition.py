"""The port's default linearizability gate, "competition"
(jepsen_tpu_torch/checker/checkers.py), against the JAX package's, both
on the CPU: the same verdicts on valid and invalid histories; the race's
semantics (tests/test_checkers.py:525-560: an unknown winner defers to a
definite loser, all-unknown stays unknown) with the port's engines
monkeypatched; a raising racer raises out of the check, or out of
``join_racers`` when it raises after the verdict; "batch" races on a
single history and batches under ``independent``, where a key the batch
leaves unknown is raced per key. Tolerance zero: verdicts only."""

import random
import threading
import time

import pytest
import torch

from jepsen_tpu import checker as jcc
from jepsen_tpu import history as jh
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import independent, parallel, simulate
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as cc
from jepsen_tpu_torch.checker import linear, torch_wgl, wgl

CPU = {"device": "cpu"}
inv = h.invoke_op
ok = h.ok_op

GOOD_CAS = [inv(0, "write", 1), ok(0, "write", 1), inv(1, "read"),
            ok(1, "read", 1), inv(0, "cas", [1, 2]), ok(0, "cas", [1, 2]),
            inv(1, "read"), ok(1, "read", 2)]
BAD_CAS = [inv(0, "write", 1), ok(0, "write", 1), inv(1, "read"),
           ok(1, "read", 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _join():
    """Every test leaves no racer running behind it."""
    yield
    ck.join_racers()


def _random(model, seed, bad):
    rng = random.Random(seed)
    hist = simulate.random_history(rng, model, 3, 24, 0.05)
    if bad:
        hist = simulate.corrupt(rng, hist)
    return hist


CASES = [("canned-good", "cas-register", lambda: GOOD_CAS),
         ("canned-bad", "cas-register", lambda: BAD_CAS)] + [
    (f"{model}-{'bad' if bad else 'good'}", model,
     lambda model=model, bad=bad: _random(model, 3, bad))
    for model in ("register", "cas-register", "mutex")
    for bad in (False, True)]


@pytest.mark.parametrize("name,model,build", CASES,
                         ids=[c[0] for c in CASES])
def test_default_gate_equals_jax(name, model, build):
    """``linearizable({"model": m})`` races in both packages and decides
    alike; the winner is one of the three racers."""
    hist = build()
    port = ck.linearizable({"model": model, "engine_opts": dict(CPU)})
    assert port.algorithm == "competition"
    got = cc.check(port, {}, h.ensure_indexed([dict(o) for o in hist]))
    want = jcc.check(jck.linearizable({"model": model}), {},
                     jh.ensure_indexed([dict(o) for o in hist]))
    assert got["valid"] == want["valid"], name
    assert got["valid"] in (True, False)
    assert got["valid?"] == got["valid"]
    assert got["engine"] in ("wgl", "linear", "jax-wgl")
    races = ck.join_racers()
    assert len(races) == 1 and races[0]["winner"] == got["engine"]
    assert set(races[0]["racers"]) == {"wgl", "linear", "jax-wgl"}


def _patch(monkeypatch, device, cpu_linear, cpu_wgl):
    monkeypatch.setattr(torch_wgl, "check_encoded", device)
    monkeypatch.setattr(linear, "check_encoded", cpu_linear)
    monkeypatch.setattr(wgl, "check_encoded", cpu_wgl)


def _unknown(spec, e, init_state, **kw):
    return {"valid": "unknown", "error": "budget"}


def test_competition_unknown_winner_defers_to_loser(monkeypatch):
    """If the first engine to finish returns unknown, competition waits
    for another and takes its definite verdict (checker.clj:199-202)."""
    real = wgl.check_encoded

    def slow_definite(spec, e, init_state, **kw):
        time.sleep(0.05)
        return real(spec, e, init_state)

    _patch(monkeypatch, _unknown, _unknown, slow_definite)
    r = ck.linearizable({"model": "cas-register"}).check({}, GOOD_CAS)
    assert r["valid"] is True and r["engine"] == "wgl"


def test_competition_all_unknown(monkeypatch):
    _patch(monkeypatch, _unknown, _unknown, _unknown)
    r = ck.linearizable({"model": "cas-register"}).check({}, GOOD_CAS)
    assert r["valid"] == "unknown"


@pytest.mark.parametrize("when", ["before", "after"])
def test_device_racer_fault_raises(monkeypatch, when):
    """An exception in the device racer is never turned into "unknown"
    while a CPU racer's verdict is returned: raised out of ``check`` when
    it comes before the race is decided (and joined), out of
    ``join_racers`` when the racer raises only after the verdict."""
    release = threading.Event()

    def broken(spec, e, init_state, **kw):
        if when == "after":
            release.wait(10)
        raise RuntimeError("device racer fault")

    real = wgl.check_encoded
    _patch(monkeypatch, broken, _unknown,
           lambda spec, e, st, **kw: real(spec, e, st))
    lin = ck.linearizable({"model": "cas-register"})
    if when == "before":
        with pytest.raises(RuntimeError, match="device racer fault"):
            lin.check({}, GOOD_CAS)
        assert ck.join_racers()[0]["racers"]["jax-wgl"]["error"] \
            == repr(RuntimeError("device racer fault"))
    else:
        r = lin.check({}, GOOD_CAS)
        assert r["valid"] is True and r["engine"] == "wgl"
        release.set()
        with pytest.raises(RuntimeError, match="device racer fault"):
            ck.join_racers()


def test_batch_algorithm_and_mesh():
    """"batch" is accepted: a single history races like competition;
    ``mesh`` is the one option that is not ported."""
    r = ck.linearizable({"model": "cas-register", "algorithm": "batch",
                         "engine_opts": dict(CPU)}).check({}, BAD_CAS)
    assert r["valid"] is False and r["engine"] in ("wgl", "linear",
                                                   "jax-wgl")
    with pytest.raises(NotImplementedError, match="A.10"):
        ck.linearizable({"model": "cas-register",
                         "engine_opts": {"mesh": object()}})
    with pytest.raises(ValueError, match="unknown algorithm"):
        ck.linearizable({"model": "cas-register", "algorithm": "knossos"})


@pytest.mark.parametrize("algorithm", ["batch", "competition"])
def test_independent_batches_and_races_unknown_keys(monkeypatch, algorithm):
    """Under "batch" and "competition" the independent checker makes one
    batched call; under "competition" a key the batch leaves unknown is
    raced per key, under "batch" it stays unknown."""
    T = independent.tuple_
    hist = []
    for i, k in enumerate(("a", "b")):
        hist += [inv(i, "write", T(k, 1)), ok(i, "write", T(k, 1)),
                 inv(i, "read", T(k, None)),
                 ok(i, "read", T(k, 7 if k == "b" else 1))]
    calls = []

    def all_unknown(spec, pairs, **kw):
        calls.append(len(pairs))
        return [{"valid": "unknown", "error": "budget"} for _ in pairs]

    monkeypatch.setattr(parallel, "check_batch_encoded", all_unknown)
    c = independent.checker(ck.linearizable(
        {"model": "cas-register", "algorithm": algorithm,
         "engine_opts": dict(CPU)}))
    r = cc.check(c, {}, hist)
    assert calls == [2]
    if algorithm == "competition":
        assert r["results"]["a"]["valid"] is True
        assert r["results"]["b"]["valid"] is False
        assert r["failures"] == ["b"]
    else:
        assert r["valid"] == "unknown"
        assert sorted(r["failures"]) == ["a", "b"]


def test_race_switch_interval(monkeypatch):
    """While a race runs, the interpreter switches threads every
    ``RACE_SWITCH_INTERVAL`` (the device racer takes the GIL back at every
    torch call); the caller's interval is restored after it."""
    import sys
    seen = []

    def probe(spec, e, init_state, **kw):
        seen.append(sys.getswitchinterval())
        return {"valid": True}

    before = sys.getswitchinterval()
    _patch(monkeypatch, probe, probe, probe)
    ck.linearizable({"model": "cas-register"}).check({}, GOOD_CAS)
    assert seen and all(v == pytest.approx(ck.RACE_SWITCH_INTERVAL)
                        for v in seen)
    assert sys.getswitchinterval() == before
