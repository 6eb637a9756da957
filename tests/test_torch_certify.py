"""The port's verdict certifier (jepsen_tpu_torch/analysis/certify.py)
against the JAX package's (jepsen_tpu/analysis/certify.py), both on the
CPU: the same certificate -- checks, findings, counts, context -- for
results of the port's device search on register, cas-register and mutex
histories (valid and invalid, with the differential sampled), and for a
planned, segmented result; the same VC codes for every tampered
witness; ``checker.core.check`` certifying a decided Linearizable
verdict once per test; and the monitor backstop (``certify_monitor``,
both families, on the evidence each package's monitor parked on the
same stream) and the txn hook (``certify_txn_verdict``, VC013), clean
and tampered. Tolerance zero: certificates compare as dicts."""

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


@pytest.mark.parametrize("bad", [False, True])
def test_sharded_verdict_gets_the_device_differential(bad):
    """``"jax-wgl-sharded"`` is a device engine (the reference's
    ``DEVICE_ENGINES``): its verdict's differential replays through the
    device engine too, and a sharded verdict without a witness is VC006
    -- the same certificates as the JAX certifier's."""
    model = "cas-register"
    client, r = _device_result(model, _history(model, 2 if bad else 1,
                                               bad))
    r["engine"] = "jax-wgl-sharded"
    r["witness"]["engine"] = "jax-wgl-sharded"
    (got, gcodes), (want, wcodes) = _both(model, client, r, samples=1)
    assert got == want and gcodes == wcodes
    diff = [c for c in got["checks"] if c["name"] == "differential"]
    assert diff and "jax-wgl" in diff[0]["verdicts"]
    bare = {k: v for k, v in r.items() if k not in ("witness", "configs")}
    (got, gcodes), (want, wcodes) = _both(model, client, bare)
    assert got == want
    assert "VC006" in gcodes and gcodes == wcodes


# ---------------------------------------------------------------------------
# the monitor backstop (certify_monitor, both families) and the txn hook
# (certify_txn_verdict): the same summaries and VC codes as the JAX
# package's on the same evidence


def _monitor_evidence(engine, keyed):
    """Both packages' Monitors driven on the same falsified stream (as
    tests/test_torch_monitor.py drives them); their parked evidence with
    the spec, as ``finalize`` parks it."""
    from jepsen_tpu import independent as jind
    from jepsen_tpu import monitor as jmonitor
    from jepsen_tpu.robust import ChainedLatch as JLatch
    from jepsen_tpu_torch import independent as tind
    from jepsen_tpu_torch.monitor import core as mcore
    from jepsen_tpu_torch.robust import ChainedLatch
    from test_torch_monitor import _drive, _history, _keyed
    spec, jspec = tm.model_spec("cas-register"), jm.model_spec(
        "cas-register")
    ours = _keyed(tind.tuple_, 4) if keyed else _history(4)
    theirs = _keyed(jind.tuple_, 4) if keyed else _history(4)
    mon = mcore.Monitor(spec, ChainedLatch(), chunk=8, engine=engine,
                        engine_opts=CPU, keyed=keyed)
    jmon = jmonitor.Monitor(jspec, JLatch(), chunk=8, engine=engine,
                            keyed=keyed)
    _drive(mon, ours, 8)
    _drive(jmon, theirs, 8)
    return dict(mon.evidence, spec=spec), dict(jmon.evidence, spec=jspec)


def _codes(diags):
    return sorted(d.code for d in diags)


@pytest.mark.parametrize("keyed", [False, True], ids=["unkeyed", "keyed"])
@pytest.mark.parametrize("engine", ["jax-wgl", "linear", "wgl",
                                    "streamlin"])
def test_certify_monitor_equals_jax(engine, keyed):
    ev, jev = _monitor_evidence(engine, keyed)
    got, gd = tcert.certify_monitor(ev)
    want, wd = jcert.certify_monitor(jev)
    assert got == want and _codes(gd) == _codes(wd) == []
    assert got["confirmed"] is True
    # a linear-engine monitor cross-checks through wgl (independence)
    cross = [c["engine"] for c in got["checks"]
             if c["name"] == "cross-check"]
    assert cross == (["wgl"] if engine == "linear" else ["linear"])


def test_certify_monitor_refutation_equals_jax():
    """A monitor claiming False on a valid prefix: the cross-check
    refutes it (VC008) in both packages."""
    hist = _history("cas-register", 1, False)
    spec, jspec = tm.model_spec("cas-register"), jm.model_spec(
        "cas-register")
    e, st = spec.encode(h.client_ops(hist))
    je, jst = jspec.encode(h.client_ops(hist))
    result = {"valid": False, "engine": "jax-wgl"}
    got, gd = tcert.certify_monitor({"e": e, "init_state": st,
                                     "result": dict(result), "key": None,
                                     "spec": spec})
    want, wd = jcert.certify_monitor({"e": je, "init_state": jst,
                                      "result": dict(result), "key": None,
                                      "spec": jspec})
    assert got == want and _codes(gd) == _codes(wd) == ["VC008"]
    assert got["confirmed"] is False


def _txn_evidence(name):
    """Both packages' TxnMonitors on one violating fixture of
    tests/test_txn_monitor.py at chunk 1: their parked evidence."""
    from jepsen_tpu.monitor import txn as jtxn
    from jepsen_tpu.robust import ChainedLatch as JLatch
    from jepsen_tpu_torch.monitor import txn as ttxn
    from jepsen_tpu_torch.robust import ChainedLatch
    from test_torch_txn_monitor import _drive_monitor
    from test_txn_monitor import _fixtures
    (hist, _, _, kw), = [f[1:] for f in _fixtures() if f[0] == name]
    mon = ttxn.TxnMonitor(ChainedLatch(), chunk=1, device="cpu", **kw)
    jmon = jtxn.TxnMonitor(JLatch(), chunk=1, **kw)
    _drive_monitor(mon, hist, 1)
    _drive_monitor(jmon, hist, 1)
    return mon.evidence, jmon.evidence


TXN_BAD = ["G0", "G1c", "G-single", "G2", "G0-realtime", "G1c-realtime",
           "G-single-realtime", "G2-realtime", "G1c-process", "G2-process"]


@pytest.mark.parametrize("name", TXN_BAD)
def test_certify_monitor_txn_equals_jax(name):
    ev, jev = _txn_evidence(name)
    got, gd = tcert.certify_monitor(ev)
    want, wd = jcert.certify_monitor(jev)
    assert got == want and _codes(gd) == _codes(wd) == []
    assert got["confirmed"] is True and got["family"] == "txn"


def _tamper_cycle(result):
    """Claim the first cycle step's edge is of another type."""
    for ws in result["anomalies"].values():
        for w in ws if isinstance(ws, list) else ():
            if isinstance(w, dict) and isinstance(w.get("steps"), list):
                step = w["steps"][0]
                step["type"] = "ww" if step["type"] != "ww" else "wr"
                return


@pytest.mark.parametrize("name", ["G1c", "G-single-realtime", "G2"])
def test_certify_monitor_txn_tampered_same_codes(name):
    ev, jev = _txn_evidence(name)
    ev, jev = copy.deepcopy(ev), copy.deepcopy(jev)
    _tamper_cycle(ev["result"])
    _tamper_cycle(jev["result"])
    got, gd = tcert.certify_monitor(ev)
    want, wd = jcert.certify_monitor(jev)
    assert got == want and _codes(gd) == _codes(wd)
    assert "VC013" in _codes(gd)


def _txn_cert(pkg_check, cert_mod, hist, workload, opts, tamper=False):
    test = {}
    res = pkg_check(hist)
    if tamper:
        _tamper_cycle(res)
    cert_mod.certify_txn_verdict(test, hist, res, workload=workload,
                                 opts=opts)
    return test


@pytest.mark.parametrize("name,tamper", [
    ("valid", False), ("G1c", False), ("G1c", True),
    ("G-single-realtime", False), ("G-single-realtime", True),
    ("G2-process", False), ("G2-process", True)])
def test_certify_txn_verdict_equals_jax(name, tamper):
    from jepsen_tpu.cycle import append as japp
    from jepsen_tpu_torch.cycle import append as tapp
    from test_txn_monitor import _fixtures
    (hist, valid, _, kw), = [f[1:] for f in _fixtures() if f[0] == name]
    opts = {"anomalies": list(kw.get("anomalies", ())) or None,
            "process": kw.get("process", False)}
    opts = {k: v for k, v in opts.items() if v is not None}
    got = _txn_cert(lambda x: tapp.check(x, opts, device="cpu"), tcert,
                    hist, "append", dict(opts, device="cpu"), tamper)
    want = _txn_cert(lambda x: japp.check(x, opts), jcert, hist, "append",
                     opts, tamper)
    assert got["certificate"] == want["certificate"]
    assert got["analysis"] == want["analysis"]
    codes = [d["code"] for d in got["certificate"]["diagnostics"]]
    assert codes == (["VC013"] if tamper else [])
    assert got["certificate"]["verdict"] is valid


def test_certify_txn_verdict_wr_equals_jax():
    from jepsen_tpu.cycle import wr as jwr
    from jepsen_tpu_torch.cycle import wr as twr
    hist = simulate.txn_wr_history(random.Random(2), 90, 8)
    got = _txn_cert(lambda x: twr.check(x, {}, device="cpu"), tcert, hist,
                    "wr", {"device": "cpu"})
    want = _txn_cert(lambda x: jwr.check(x, {}), jcert, hist, "wr", {})
    assert got["certificate"] == want["certificate"]
    assert got["certificate"]["verdict"] is True


def test_multi_type_edge_witness_certifies_clean():
    """ROADMAP.md C.6, a fault of the JAX package's certifier: a G-single
    cycle whose return path runs over a ``ww+wr+rw`` edge (a dependency
    that is also an anti-dependency) is a valid G-single witness, but the
    JAX certifier counts that edge as a second rw edge and reports
    VC013. The port's certifier lets a multi-type edge serve as any of
    its types. Six txns cut down from a stale-read run of the list-append
    workload under the txn monitor, where the JAX rule failed the smoke's
    certification; both packages' analyses agree on the verdict and the
    witness."""
    from jepsen_tpu.monitor import engine as jeng
    from jepsen_tpu_torch.monitor import engine as teng
    from test_txn_monitor import A, P, R
    x = [23, 24, 27, 25, 26]
    hist = P(
        (0, 100, [R("y", [8]), R("z", [5]), A("y", 3)], 6),
        (70, 170, [R("y", [8, 3]), R("z", [5, 7]), A("x", 23)], 3),
        (110, 180, [R("x", x[:1]), R("z", [5, 7]), A("x", 24)], 7),
        (140, 190, [A("z", 8), R("x", x[:2]), A("z", 9), A("x", 27)], 5),
        (130, 200, [A("x", 25), A("x", 26), R("x", x), R("y", [8])], 1),
        (150, 300, [R("z", [5, 7, 8, 9, 12]), A("z", 10), R("x", x),
                    A("z", 11)], 4))
    result = teng.check_txn_prefix(hist, "append", CPU)
    assert result == jeng.check_txn_prefix(hist, "append", {})
    (w,) = result["anomalies"]["G-single"]
    assert [s["type"] for s in w["steps"]] \
        == ["rw", "wr", "ww+wr", "ww+wr+rw", "ww"]
    ev = {"family": "txn", "workload": "append", "opts": {},
          "history": hist, "result": result}
    got, gd = tcert.certify_monitor(ev)
    want, wd = jcert.certify_monitor(copy.deepcopy(ev))
    assert _codes(wd) == ["VC013"] and _codes(gd) == []
    assert got["confirmed"] is True
    assert {c["class"]: c["status"] for c in got["checks"]} \
        == {"G-single": "confirmed", "G2": "confirmed"}
