"""The port's StreamCheck (jepsen_tpu_torch/monitor/wgl_stream.py) against
the JAX package's (jepsen_tpu/monitor/wgl_stream.py) on the CPU: the same
op streams, checked every 1, 3 and 8 completions, give equal verdicts
and equal fold counters (seal and probe folds, passes, cells), and every
verdict equals the offline check of the same prefix. Also the probe path
with open ops, the sealed-cut carry, slot recycling, the O(window) fold
cost, frontier overflow, violation confirms and the queue fall-back.
Tolerance: equality."""

import pytest

from jepsen_tpu.analysis import searchplan
from jepsen_tpu.models import base as jbase
from jepsen_tpu.monitor import engine as jengine
from jepsen_tpu.monitor.wgl_stream import StreamCheck as JStreamCheck
from jepsen_tpu_torch.checker import streamlin
from jepsen_tpu_torch.models import base as tbase
from jepsen_tpu_torch.monitor import engine as mengine
from jepsen_tpu_torch.monitor.wgl_stream import StreamCheck

from test_monitor import _history
from test_streamlin import _paired

JSPEC = jbase.model_spec("cas-register")
SPEC = tbase.model_spec("cas-register")
COUNTERS = ("checks", "seal_folds", "probe_folds", "fold_passes",
            "fold_cells", "frontier_grows", "window_grows", "flat_checks",
            "probe_overflows", "confirm_mismatches", "sealed_rows",
            "frontier_size", "frontier_peak")


def _pair(opts=None):
    return (StreamCheck(SPEC, opts=opts, device="cpu"),
            JStreamCheck(JSPEC, opts=dict(opts or {}, **{"coalesce?":
                                                         False})))


def _offline(sc):
    e, init = sc.materialize()
    return mengine.check_prefix(SPEC, e, init, engine="jax-wgl",
                                engine_opts={"device": "cpu"})


def _same_counters(sc, jsc):
    for k in COUNTERS:
        assert getattr(sc, k) == getattr(jsc, k), k
    assert sc.fallback == jsc.fallback


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("falsify", [None, 4])
def test_stream_equivalence_chunks(chunk, falsify):
    sc, jsc = _pair()
    verdicts = []
    n = 0
    for i, op in enumerate(_history(falsify_at=falsify)):
        done = sc.offer(op, i)
        assert jsc.offer(op, i) == done
        if done:
            n += 1
            if n % chunk == 0:
                r, jr = sc.check(), jsc.check()
                assert r["valid"] == jr["valid"]
                assert r["valid"] == _offline(sc)["valid"]
                verdicts.append(r["valid"])
                _same_counters(sc, jsc)
    final = sc.check()["valid"]
    assert final == jsc.check()["valid"] == _offline(sc)["valid"]
    verdicts.append(final)
    assert sc.fallback is None
    assert (False in verdicts) == (falsify is not None)


def test_probe_path_open_ops():
    """Checks landing while ops are open run the probe fold; verdicts
    and counters match the JAX package's at every cut."""
    sc, jsc = _pair()
    for i, op in enumerate(_paired(30, overlap=True)):
        sc.offer(op, i)
        jsc.offer(op, i)
        if op["type"] == "invoke" and i % 7 == 0:
            assert sc.check()["valid"] is jsc.check()["valid"] is True
            _same_counters(sc, jsc)
    assert sc.probe_folds > 0
    assert sc.check()["valid"] is _offline(sc)["valid"] is True


def test_sealed_cut_carry_composes():
    """truncate_before at a quiescent cut bounds the flat prefix; the
    device frontier carries on, and a later violation is caught and
    confirmed on the truncated prefix."""
    sc, jsc = _pair()
    i = 0
    for op in _paired(12):
        sc.offer(op, i)
        jsc.offer(op, i)
        i += 1
    assert sc.check()["valid"] is jsc.check()["valid"] is True
    e, _ = jsc.materialize()
    cut = searchplan.stream_cut(JSPEC, e)
    assert cut is not None
    assert sc.truncate_before(*cut) == jsc.truncate_before(*cut) > 0
    for op in _paired(6, bad_at=3):
        sc.offer(op, i)
        jsc.offer(op, i)
        i += 1
    r = sc.check()
    assert r["valid"] is jsc.check()["valid"] is False
    assert r["detected_by"] == "streamlin"
    assert _offline(sc)["valid"] is False
    assert len(sc) == len(jsc)


def test_fold_cost_independent_of_prefix():
    """A small constant number of folds per check, cells that do not
    grow with the prefix, the window at its floor and slots recycled."""
    sc = StreamCheck(SPEC, device="cpu")
    per_check = []
    n = 0
    for i, op in enumerate(_paired(120)):
        sc.offer(op, i)
        if op["type"] != "invoke":
            n += 1
            if n % 8 == 0:
                d0, c0 = sc.solo_folds, sc.fold_cells
                assert sc.check()["valid"] is True
                per_check.append((sc.solo_folds - d0, sc.fold_cells - c0))
    assert sc.fallback is None and sc.flat_checks == 0
    assert len(per_check) >= 20
    assert max(d for d, _ in per_check) <= 3
    cells = [c for _, c in per_check]
    assert max(cells[-4:]) <= max(cells[2:6])
    assert sc.NW == streamlin.WINDOW_FLOOR
    assert sc.sealed_rows > 0


def test_frontier_overflow_contained():
    """frontier-cap 1 cannot hold overlapping writes' configs: the
    stream degrades (or falls back for a chunk) exactly as the JAX
    package's, and keeps returning the offline verdict."""
    for falsify in (None, 3):
        sc, jsc = _pair({"frontier-cap": 1})
        final = None
        for i, op in enumerate(_paired(8, bad_at=falsify, overlap=True)):
            sc.offer(op, i)
            jsc.offer(op, i)
            if op["type"] != "invoke" and i % 5 == 0:
                final = sc.check()["valid"]
                assert final == jsc.check()["valid"]
                _same_counters(sc, jsc)
                if final is False:
                    break
        if final is not False:
            final = sc.check()["valid"]
        assert sc.fallback is not None or sc.flat_checks > 0 \
            or sc.probe_overflows > 0
        assert final == _offline(sc)["valid"]


def test_violation_confirmed_by_the_device_search():
    sc = StreamCheck(SPEC, device="cpu")
    r = None
    for i, op in enumerate(_history(falsify_at=4)):
        if sc.offer(op, i):
            r = sc.check()
            if r["valid"] is False:
                break
    assert r["valid"] is False and r["detected_by"] == "streamlin"
    assert sc.confirm_mismatches == 0 and sc.flat_checks == 0


def test_dynamic_state_size_degrades_to_flat():
    qspec = tbase.model_spec("fifo-queue")
    sc = StreamCheck(qspec, device="cpu")
    assert sc.fallback == "dynamic-state-size"
    ops = [{"type": "invoke", "process": 0, "f": "enqueue", "value": 1},
           {"type": "ok", "process": 0, "f": "enqueue", "value": 1},
           {"type": "invoke", "process": 0, "f": "dequeue",
            "value": None},
           {"type": "ok", "process": 0, "f": "dequeue", "value": 1}]
    for i, op in enumerate(ops):
        sc.offer(op, i)
    assert sc.check()["valid"] is True
    assert sc.flat_checks == 1


def test_engine_dispatch_matches_jax():
    """check_prefix routes every engine as the JAX package's does."""
    sc, jsc = _pair()
    for i, op in enumerate(_history(falsify_at=4)):
        sc.offer(op, i)
        jsc.offer(op, i)
    e, init = sc.materialize()
    je, jinit = jsc.materialize()
    for engine in mengine.ENGINES:
        r = mengine.check_prefix(SPEC, e, init, engine=engine,
                                 engine_opts={"device": "cpu"})
        jr = jengine.check_prefix(JSPEC, je, jinit, engine=engine)
        assert r["valid"] is jr["valid"] is False, engine
    assert mengine.ENGINES == jengine.ENGINES
    assert mengine.TXN_WORKLOADS == jengine.TXN_WORKLOADS
    with pytest.raises(ValueError):
        mengine.check_prefix(SPEC, e, init, engine="nope")
