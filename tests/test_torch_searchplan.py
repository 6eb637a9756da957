"""The port's search planner (jepsen_tpu_torch/analysis/searchplan.py)
against the JAX package's (jepsen_tpu/analysis/searchplan.py), both on
the CPU:

* ``segment_events``/``plan_segments`` give the same segments, event for
  event, with the same seeds, row counts and estimates, and the same
  info, on the cases of tests/test_searchplan.py (sealed cuts and seeds,
  min-segment coalescing, a crashed write blocking cuts, crashed reads
  elided, no ``seal_fs`` -> no cuts, overlap preventing a seal) and on
  16 keys of the headline batch; ``merge_segment_results`` and
  ``stream_cut`` agree too;
* planned and unplanned verdicts are equal, single-key and keyed, and
  equal to the JAX package's;
* a planner fault raises out of the check (no fall-back).

Tolerance zero: every comparison is on events, integers and verdicts."""

import random

import pytest
import torch

from jepsen_tpu import checker as jcc
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu.analysis import searchplan as jsp
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu_torch import independent
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.analysis import searchplan as tsp
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as cc
from jepsen_tpu_torch.simulate import bench_histories

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Ev:
    """Tiny indexed event-list builder."""

    def __init__(self):
        self.events = []

    def __call__(self, t, p, f, v):
        self.events.append({"type": t, "process": p, "f": f, "value": v,
                            "index": len(self.events)})


def quiescent_hist(bursts=3, stale_read=False, crashed_read=False,
                   crashed_write=False):
    """tests/test_searchplan.py's builder: concurrent write||write bursts
    separated by sealing isolated writes; optional crashed ops and a
    trailing stale read."""
    ev = _Ev()
    for j in range(bursts):
        x = j * 10
        ev("invoke", 0, "write", x)
        ev("invoke", 1, "write", x + 1)
        ev("ok", 0, "write", x)
        ev("ok", 1, "write", x + 1)
        if crashed_read:
            ev("invoke", 100 + j, "read", None)
            ev("info", 100 + j, "read", None)
        if crashed_write and j == 0:
            ev("invoke", 200, "write", 777)
            ev("info", 200, "write", 777)
        ev("invoke", 0, "write", x + 5)
        ev("ok", 0, "write", x + 5)
    ev("invoke", 2, "read", None)
    ev("ok", 2, "read", 0 if stale_read else (bursts - 1) * 10 + 5)
    return ev.events


def keyed_hist(tuple_, nk=2, bad_key=None, crashed_read=False):
    """Independent [k v] register histories, quiescent per key."""
    ev = _Ev()
    for k in range(nk):
        for j in range(3):
            x = j * 10
            ev("invoke", 2 * k, "write", tuple_(k, x))
            ev("ok", 2 * k, "write", tuple_(k, x))
            if crashed_read and j == 1:
                ev("invoke", 100 + k, "read", tuple_(k, None))
                ev("info", 100 + k, "read", tuple_(k, None))
            ev("invoke", 2 * k + 1, "read", tuple_(k, None))
            ev("ok", 2 * k + 1, "read",
               tuple_(k, 999 if (k == bad_key and j == 2) else x))
    return ev.events


def mutex_hist():
    ev = _Ev()
    for _ in range(4):
        ev("invoke", 0, "acquire", None)
        ev("ok", 0, "acquire", None)
        ev("invoke", 0, "release", None)
        ev("ok", 0, "release", None)
    return ev.events


def overlap_hist():
    ev = _Ev()
    ev("invoke", 0, "write", 1)
    ev("invoke", 1, "write", 2)
    ev("ok", 0, "write", 1)
    ev("ok", 1, "write", 2)       # quiescent here, but NOT sealed
    ev("invoke", 0, "read", None)
    ev("ok", 0, "read", 2)
    return ev.events


def _same_segments(got, want):
    segs, info = got
    jsegs, jinfo = want
    assert info == jinfo
    assert len(segs) == len(jsegs)
    for s, j in zip(segs, jsegs):
        assert s.events == j.events
        assert (s.rows, s.seed, s.est_configs) \
            == (j.rows, j.seed, j.est_configs)


#: the segmentation cases of tests/test_searchplan.py:92-168, each with
#: what that file asserts of it
CASES = [
    ("sealed-cuts-seeded", "cas-register", lambda: quiescent_hist(3), 1),
    ("min-segment-1", "cas-register", lambda: quiescent_hist(4), 1),
    ("min-segment-6", "cas-register", lambda: quiescent_hist(4), 6),
    ("crashed-write", "cas-register",
     lambda: quiescent_hist(3, crashed_write=True), 1),
    ("crashed-reads", "cas-register",
     lambda: quiescent_hist(3, crashed_read=True), 1),
    ("no-seal-fs", "mutex", mutex_hist, 1),
    ("overlap", "cas-register", overlap_hist, 1),
    ("stale-crashes", "cas-register",
     lambda: quiescent_hist(3, stale_read=True, crashed_read=True,
                            crashed_write=True), 1),
]


@pytest.mark.parametrize("name,model,build,min_seg", CASES,
                         ids=[c[0] for c in CASES])
def test_segments_equal_jax(name, model, build, min_seg):
    hist = build()
    got = tsp.segment_events(tm.model_spec(model), hist, min_segment=min_seg)
    want = jsp.segment_events(jm.model_spec(model), hist,
                              min_segment=min_seg)
    _same_segments(got, want)
    segs, info = got
    assert len(segs) == info["cuts"] + 1
    if name == "sealed-cuts-seeded":
        assert info["cuts"] >= 2 and segs[0].seed is None
        for seg in segs[1:]:
            assert seg.seed["f"] == "write"
            assert seg.events[0]["index"] == seg.seed["index"]
    elif name == "min-segment-6":
        many, _ = tsp.segment_events(tm.model_spec(model), hist,
                                     min_segment=1)
        assert len(segs) < len(many)
    elif name == "crashed-write":
        clean, _ = tsp.segment_events(tm.model_spec(model),
                                      quiescent_hist(3), min_segment=1)
        assert info["cuts"] < len(clean) - 1 and info["elided"] == 0
    elif name == "crashed-reads":
        _, cinfo = tsp.segment_events(tm.model_spec(model),
                                      quiescent_hist(3), min_segment=1)
        assert info["elided"] == 3 and info["cuts"] == cinfo["cuts"]
    elif name in ("no-seal-fs", "overlap"):
        assert info["cuts"] == 0


def test_batch_keys_plan_equal_jax():
    """16 keys of the headline batch (the 256-key batch's first keys),
    at the default and at a small minimum segment: the same plan."""
    keys, _ = bench_histories(16)
    ts, js = tm.cas_register_spec, jm.cas_register_spec
    split = 0
    for hist in keys:
        for min_seg in (tsp.MIN_SEGMENT_OPS, 2):
            got = tsp.plan_segments(ts, hist, min_seg)
            _same_segments(got, jsp.plan_segments(js, hist, min_seg))
            split += len(got[0]) > 1
    assert split > 0
    # stream_cut on every prefix of one key's encoded history
    hist = keys[6]
    for upto in range(0, len(hist), 25):
        pre = hist[:upto]
        assert tsp.stream_cut(ts, ts.encode(pre)[0]) \
            == jsp.stream_cut(js, js.encode(pre)[0])


def test_merge_segment_results_equal_jax():
    rs = [{"valid": True, "configs_explored": 5, "iterations": 2,
           "witness": {"verdict": True}},
          {"valid": False, "configs_explored": 7, "iterations": 4,
           "op": {"index": 3}, "witness": {"verdict": False}},
          {"valid": "unknown", "error": "timeout", "configs_explored": 1}]
    info = {"cuts": 2, "elided": 1}
    for sub in (rs[:1], rs[:2], rs[::2], rs):
        assert tsp.merge_segment_results(sub, info, 0.25) \
            == jsp.merge_segment_results(sub, info, 0.25)


def _lin(module, **opts):
    return module.linearizable({"model": "cas-register",
                                "algorithm": "jax-wgl", **opts})


HISTORIES = [
    ("valid-single", lambda t: quiescent_hist(3), True),
    ("invalid-single-stale", lambda t: quiescent_hist(3, stale_read=True),
     False),
    ("valid-single-crashes",
     lambda t: quiescent_hist(3, crashed_read=True), True),
    ("invalid-single-crashes",
     lambda t: quiescent_hist(3, stale_read=True, crashed_read=True,
                              crashed_write=True), False),
    ("valid-multikey", lambda t: keyed_hist(t, 2), True),
    ("invalid-multikey", lambda t: keyed_hist(t, 2, bad_key=1), False),
    ("valid-multikey-crashes",
     lambda t: keyed_hist(t, 2, crashed_read=True), True),
]


@pytest.mark.parametrize("name,build,expect", HISTORIES,
                         ids=[x[0] for x in HISTORIES])
def test_verdicts_plan_on_equal_plan_off(name, build, expect):
    """THE equivalence property (tests/test_searchplan.py:189-199) on
    the port, and the same verdicts as the JAX package's."""
    hist = build(independent.tuple_)
    keyed = "multikey" in name
    port = _lin(ck, engine_opts=dict(CPU))
    port = independent.checker(port) if keyed else port
    r_on = cc.check(port, {"searchplan-min-segment": 1}, hist)
    r_off = cc.check(port, {"searchplan?": False}, hist)
    assert r_on["valid"] is expect and r_off["valid"] is expect
    jchk = jind.checker(_lin(jck)) if keyed else _lin(jck)
    want = jcc.check(jchk, {"searchplan-min-segment": 1},
                     build(jind.tuple_))
    assert want["valid"] is expect
    def plan(r):
        return {k: v for k, v in r.get("searchplan", {}).items()
                if k != "plan_s"}

    if keyed:
        assert r_on["results"][0]["searchplan"]["segments"] >= 2
        for k in r_on["results"]:
            got, exp = r_on["results"][k], want["results"][k]
            assert got["valid"] == exp["valid"] and plan(got) == plan(exp)
            assert "searchplan" not in r_off["results"][k]
    else:
        # a crashed write blocks every later cut: one segment, no plan
        assert ("searchplan" in r_on) is (name != "invalid-single-crashes")
        assert "searchplan" not in r_off and plan(r_on) == plan(want)
        if expect is False and "searchplan" in r_on:
            assert "failed_segment" in r_on["searchplan"]
            assert r_on["valid?"] is False


def test_plan_gates():
    """``searchplan?`` and the predicate list gate the cut execution, and
    ``confirm`` makes planning step aside, as in the JAX package."""
    for test in ({}, {"searchplan?": False},
                 {"searchplan-partitions": ["per-key"]},
                 {"searchplan-min-segment": 3}, None):
        assert tsp.segments_enabled(test) == jsp.segments_enabled(test)
        assert tsp.min_segment(test) == jsp.min_segment(test)
    r = cc.check(_lin(ck, engine_opts=dict(CPU)),
                 {"searchplan-min-segment": 1,
                  "searchplan-partitions": ["per-key"]}, quiescent_hist(3))
    assert r["valid"] is True and "searchplan" not in r
    r = cc.check(_lin(ck, engine_opts={**CPU, "confirm": True}),
                 {"searchplan-min-segment": 1},
                 quiescent_hist(3, stale_read=True))
    assert r["valid"] is False and "searchplan" not in r


@pytest.mark.parametrize("keyed", [False, True])
def test_planner_fault_raises(monkeypatch, keyed):
    """A fault of the planner raises out of the check: the JAX package's
    "planner bug -> one segment" and "fall back to the flat search" are
    not carried over."""
    def broken(*a, **kw):
        raise RuntimeError("planner fault")

    monkeypatch.setattr(tsp, "segment_events", broken)
    chk = _lin(ck, engine_opts=dict(CPU))
    hist = quiescent_hist(3)
    if keyed:
        chk = independent.checker(chk)
        hist = keyed_hist(independent.tuple_, 2)
    with pytest.raises(RuntimeError, match="planner fault"):
        cc.check(chk, {"searchplan-min-segment": 1}, hist)
    # with planning off the planner is never consulted
    assert cc.check(chk, {"searchplan?": False}, hist)["valid"] is True


def test_planned_random_keys_equal_oracle():
    """Seeded cas-register keys through the keyed checker: planned and
    unplanned verdicts equal each other and the CPU oracle's."""
    from jepsen_tpu_torch.checker import wgl
    from jepsen_tpu_torch.simulate import corrupt, random_history
    rng = random.Random(5)
    hists = []
    for k in range(3):
        h = random_history(rng, "cas-register", 3, 30, 0.05)
        hists.append(corrupt(rng, h) if k == 2 else h)
    hist = []
    for k, sub in enumerate(hists):
        for o in sub:
            hist.append(dict(o, process=o["process"] + 10 * k,
                             value=independent.tuple_(k, o.get("value")),
                             index=len(hist)))
    chk = independent.checker(_lin(ck, engine_opts=dict(CPU)))
    on = cc.check(chk, {"searchplan-min-segment": 2}, hist)
    off = cc.check(chk, {"searchplan?": False}, hist)
    assert any("searchplan" in r for r in on["results"].values())
    for k, sub in enumerate(hists):
        want = wgl.check_encoded(tm.cas_register_spec,
                                 *tm.cas_register_spec.encode(sub))
        assert on["results"][k]["valid"] == off["results"][k]["valid"] \
            == want["valid"], k
    assert on["failures"] == off["failures"] == [2]


def test_gate_segments_pinned():
    """``chip_smoke.GATE_SEGMENTS``, the per-key segment counts the smoke
    asserts of the port's planner on the card, are the JAX planner's
    counts on the headline batch's first keys (read from the script's
    source: importing it blocks JAX in this process)."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    pinned = None
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "GATE_SEGMENTS"
                for t in node.targets):
            pinned = ast.literal_eval(node.value)
    keys, _ = bench_histories(len(pinned))
    js, ts = jm.cas_register_spec, tm.cas_register_spec
    assert tuple(len(jsp.plan_segments(js, hh)[0]) for hh in keys) \
        == pinned
    assert tuple(len(tsp.plan_segments(ts, hh)[0]) for hh in keys) \
        == pinned
    assert sum(pinned) == 92 and sum(c > 1 for c in pinned) == 21
