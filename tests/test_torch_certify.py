"""The port's verdict certifier (jepsen_tpu_torch/analysis/certify.py)
against the JAX package's (jepsen_tpu/analysis/certify.py), both on the
CPU: the same certificate -- checks, findings, counts, context -- for
results of the port's device search on register, cas-register and mutex
histories (valid and invalid, with the differential sampled), and for a
planned, segmented result; the same VC codes for every tampered
witness; and ``checker.core.check`` certifying a decided Linearizable
verdict once per test. Tolerance zero: certificates compare as dicts."""

import copy
import random

import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.analysis import certify as jcert
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import simulate
from jepsen_tpu_torch.analysis import certify as tcert
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as cc
from jepsen_tpu_torch.checker import torch_wgl

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _history(model, seed, bad):
    rng = random.Random(seed)
    hist = simulate.random_history(rng, model, 3, 20, 0.05)
    if bad:
        hist = simulate.corrupt(rng, hist)
        for o in hist:     # keep bad reads reachable: the search decides
            if o["type"] == "ok" and o["f"] == "read" \
                    and isinstance(o.get("value"), int):
                o["value"] = o["value"] % 4
    return h.ensure_indexed(hist)


def _both(model, client, result, test=None, samples=0):
    """(port certificate, its diag codes), (JAX certificate, codes)."""
    got, gd = tcert.certify_with_diagnostics(
        tm.model_spec(model), client, copy.deepcopy(result), test=test,
        samples=samples, device="cpu")
    want, wd = jcert.certify_with_diagnostics(
        jm.model_spec(model), client, copy.deepcopy(result), test=test,
        samples=samples)
    return (got, sorted(d.code for d in gd)), (want, sorted(d.code
                                                            for d in wd))


def _device_result(model, hist):
    lin = ck.linearizable({"model": model, "algorithm": "jax-wgl",
                           "engine_opts": dict(CPU)})
    client = lin.prepare_history(h.client_ops(hist))
    spec = tm.model_spec(model)
    return client, torch_wgl.check_encoded(spec, *spec.encode(client),
                                           device="cpu")


CASES = [(model, seed, bad) for model in ("register", "cas-register",
                                          "mutex")
         for seed, bad in ((1, False), (2, True))]


@pytest.mark.parametrize("model,seed,bad", CASES,
                         ids=[f"{m}-{'bad' if b else 'good'}"
                              for m, _, b in CASES])
def test_certificate_equals_jax(model, seed, bad):
    hist = _history(model, seed, bad)
    client, r = _device_result(model, hist)
    assert r["valid"] in (True, False)
    samples = 1 if model == "cas-register" and not bad else 0
    (got, gcodes), (want, wcodes) = _both(model, client, r,
                                          samples=samples)
    assert got == want
    assert gcodes == wcodes
    assert not [c for c in gcodes if c not in ("VC009", "VC011")]


def _segmented():
    """tests/test_searchplan.py's quiescent bursts with a stale read:
    planned into segments, invalid in the last."""
    ev = []

    def add(t, p, f, v):
        ev.append({"type": t, "process": p, "f": f, "value": v,
                   "index": len(ev)})
    for j in range(3):
        add("invoke", 0, "write", 10 * j)
        add("invoke", 1, "write", 10 * j + 1)
        add("ok", 0, "write", 10 * j)
        add("ok", 1, "write", 10 * j + 1)
        add("invoke", 0, "write", 10 * j + 5)
        add("ok", 0, "write", 10 * j + 5)
    add("invoke", 2, "read", None)
    add("ok", 2, "read", 0)
    return ev


@pytest.mark.parametrize("stale", [False, True])
def test_segmented_certificate_equals_jax(stale):
    hist = _segmented()
    if not stale:
        hist[-1]["value"] = 25
    test = {"searchplan-min-segment": 1}
    lin = ck.linearizable({"model": "cas-register", "algorithm": "jax-wgl",
                           "engine_opts": dict(CPU)})
    r = lin.check(test, h.ensure_indexed(hist))
    assert r["searchplan"]["segments"] >= 2 and r["valid"] is not stale
    client = lin.prepare_history(h.client_ops(h.ensure_indexed(hist)))
    (got, gcodes), (want, wcodes) = _both("cas-register", client, r,
                                          test=test)
    assert got == want and gcodes == wcodes == []
    names = [c["name"] for c in got["checks"]]
    assert "witness.segment[0]" in names
    if stale:
        cross = [c for c in got["checks"] if c["name"] == "cross-check"]
        assert cross[0]["status"] == "confirmed"
        assert cross[0]["scope"].startswith("segment")


def _tamper_order(r):
    r["witness"]["order"] = list(reversed(r["witness"]["order"]))


def _tamper_verdict(r):
    r["witness"]["verdict"] = not r["witness"]["verdict"]


def _tamper_rows(r):
    r["witness"]["rows"] += 1


def _tamper_missing(r):
    r["witness"]["linearized_rows"] = r["witness"]["linearized_rows"][:-1]
    r["witness"]["order"] = [i for i in r["witness"]["order"]
                             if i in r["witness"]["linearized_rows"]]


def _tamper_schema(r):
    r["witness"]["schema"] = 99


def _tamper_drop(r):
    del r["witness"]


TAMPERS = [("order", _tamper_order), ("verdict", _tamper_verdict),
           ("rows", _tamper_rows), ("missing", _tamper_missing),
           ("schema", _tamper_schema), ("no-witness", _tamper_drop)]


@pytest.mark.parametrize("name,tamper", TAMPERS, ids=[t[0] for t in TAMPERS])
def test_tampered_witness_same_codes(name, tamper):
    hist = _history("cas-register", 1, False)
    client, r = _device_result("cas-register", hist)
    assert r["valid"] is True and len(r["witness"]["order"]) > 2
    tamper(r)
    (got, gcodes), (want, wcodes) = _both("cas-register", client, r)
    assert gcodes == wcodes and gcodes
    assert got == want


def test_tampered_segment_and_lying_engine(monkeypatch):
    """A segment witness with the wrong provenance is VC007 in both; a
    lying device engine in the differential is VC010 in both."""
    hist = h.ensure_indexed(_segmented())
    test = {"searchplan-min-segment": 1}
    lin = ck.linearizable({"model": "cas-register", "algorithm": "jax-wgl",
                           "engine_opts": dict(CPU)})
    r = lin.check(test, hist)
    client = lin.prepare_history(h.client_ops(hist))
    bad = copy.deepcopy(r)
    bad["witnesses"][0]["segment"]["index"] = 5
    (got, gcodes), (want, wcodes) = _both("cas-register", client, bad,
                                          test=test)
    assert gcodes == wcodes and "VC007" in gcodes and got == want

    def liar(spec, e, st, budget, device=None):
        return {"valid": False}

    valid = _segmented()
    valid[-1]["value"] = 25
    r = lin.check(test, h.ensure_indexed(valid))
    assert r["valid"] is True
    client = lin.prepare_history(h.client_ops(h.ensure_indexed(valid)))

    monkeypatch.setitem(tcert.DIFF_ENGINES, "jax-wgl", liar)
    monkeypatch.setitem(jcert.DIFF_ENGINES, "jax-wgl", liar)
    (got, gcodes), (want, wcodes) = _both("cas-register", client, r,
                                          test=test, samples=1)
    assert gcodes == wcodes and "VC010" in gcodes and got == want


def test_core_check_certifies_once():
    """``checker.core.check`` certifies a decided Linearizable verdict
    into the test map, once per test; ``certify?`` False opts out; an
    independent check certifies its first failing key."""
    from jepsen_tpu_torch import independent
    hist = _history("cas-register", 2, True)
    lin = ck.linearizable({"model": "cas-register", "algorithm": "jax-wgl",
                           "engine_opts": dict(CPU)})
    test = {"certify": {"samples": 0}}
    r = cc.check(lin, test, hist)
    cert = test["certificate"]
    assert cert["verdict"] is r["valid"] is False
    assert test["analysis"]["certify"]["counts"]["error"] == 0
    assert test["certify-done?"] is True
    off = {"certify?": False}
    cc.check(lin, off, hist)
    assert "certificate" not in off
    T = independent.tuple_
    keyed = []
    for k, sub in ((0, _history("cas-register", 1, False)), (1, hist)):
        for o in sub:
            keyed.append(dict(o, value=T(k, o.get("value")),
                              process=o["process"] + 10 * k,
                              index=len(keyed)))
    test = {"certify": {"samples": 0}}
    r = cc.check(independent.checker(lin), test, keyed)
    assert r["failures"] == [1]
    assert test["certificate"]["context"]["key"] == 1
    assert test["certificate"]["verdict"] is False
