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


# ---------------------------------------------------------------------------
# the coalescer's fold lane (fleet.service): monitored streams share
# lane-batched folds


#: stream counters that say which path a fold took, not what it found
LANE_FIELDS = ("coalesced_folds", "solo_folds", "batch_peak", "device_s")

#: the fold-lane streams: (rounds, bad round or None, overlapped)
LANE_STREAMS = ((10, None, True), (10, 6, True), (12, None, False),
                (9, 4, False))


@pytest.fixture()
def coalescer():
    from jepsen_tpu_torch.fleet import service
    service.reset()
    yield lambda **kw: service.configure_coalesce(
        enabled=True, device="cpu", **kw)
    service.reset()


def _lane_run(checks, every=3, rounds_barrier=True):
    """Feed each stream its ops from a thread of its own, checking every
    ``every`` completions; the threads meet before each check so their
    folds land in one coalescing window. Returns each stream's verdicts
    and final summary."""
    import threading
    streams = [_paired(n, bad_at=b, overlap=o) for n, b, o in LANE_STREAMS]
    n_checks = min(sum(op["type"] != "invoke" for op in s) // every
                   for s in streams)
    gate = threading.Barrier(len(streams)) if rounds_barrier else None
    out = [None] * len(streams)
    errors = []

    def feed(k):
        try:
            sc, done, verdicts = checks[k], 0, []
            for i, op in enumerate(streams[k]):
                if sc.offer(op, i):
                    done += 1
                    if done % every == 0 and done // every <= n_checks:
                        if gate is not None:
                            gate.wait(timeout=30)
                        verdicts.append(sc.check()["valid"])
            verdicts.append(sc.check()["valid"])
            out[k] = (verdicts, sc.stream_summary())
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)
            if gate is not None:
                gate.abort()

    threads = [threading.Thread(target=feed, args=(k,))
               for k in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _without_lane_fields(summary):
    return {k: v for k, v in summary.items() if k not in LANE_FIELDS}


def test_coalesced_streams_give_the_solo_verdicts_and_summaries(
        coalescer):
    """Four streams behind a live coalescer: every check's verdict and
    the final summaries equal the same streams folded solo (and the JAX
    package's, which the other tests hold the solo path to), apart from
    which path each fold took; folds were batched across streams."""
    solo = _lane_run([StreamCheck(SPEC, device="cpu")
                      for _ in LANE_STREAMS], rounds_barrier=False)
    coalescer(window_ms=100)
    coal = _lane_run([StreamCheck(SPEC, opts={"owner": f"s{k}"},
                                  device="cpu")
                      for k in range(len(LANE_STREAMS))])
    for (sv, ss), (cv, cs), (_n, bad, _o) in zip(solo, coal,
                                                 LANE_STREAMS):
        assert cv == sv
        assert (False in cv) == (bad is not None)
        assert _without_lane_fields(cs) == _without_lane_fields(ss)
        assert ss["coalesced_folds"] == 0 and ss["batch_peak"] == 1
        assert cs["coalesced_folds"] + cs["solo_folds"] \
            == ss["solo_folds"]
    assert all(cs["coalesced_folds"] > 0 for _v, cs in coal)
    assert max(cs["batch_peak"] for _v, cs in coal) >= 2
    jsc = JStreamCheck(JSPEC, opts={"coalesce?": False})
    assert set(jsc.stream_summary()) == set(coal[0][1])


def test_fold_lane_opt_out_and_stopped_coalescer_fold_solo(coalescer):
    """``coalesce?`` off folds solo beside a live coalescer; a stopped
    one hands its folds to the solo path (its submit raises)."""
    coal = coalescer(window_ms=20)
    sc = StreamCheck(SPEC, opts={"coalesce?": False}, device="cpu")
    for i, op in enumerate(_paired(6)):
        sc.offer(op, i)
    assert sc.check()["valid"] is True
    assert sc.coalesced_folds == 0 and sc.solo_folds > 0
    assert coal.stats()["batches"] == 0
    coal.stop()
    sc = StreamCheck(SPEC, device="cpu")
    for i, op in enumerate(_paired(6)):
        sc.offer(op, i)
    assert sc.check()["valid"] is True
    assert sc.coalesced_folds == 0 and sc.solo_folds > 0


def test_a_failed_fold_batch_raises_not_folds_solo(coalescer,
                                                    monkeypatch):
    """Deliberate divergence: the reference's stream folds solo after a
    coalescer error; the port's check raises the batch's error, as a
    failed solo fold already does."""
    from jepsen_tpu_torch.fleet import service

    def boom(jobs, owners=None, e_bucket=None):
        raise RuntimeError("injected fold fault")

    monkeypatch.setattr(streamlin, "batch_fold", boom)
    coalescer(window_ms=10)
    sc = StreamCheck(SPEC, device="cpu")
    for i, op in enumerate(_paired(4)):
        sc.offer(op, i)
    with pytest.raises(service.BatchFailed, match="injected fold fault"):
        sc.check()
    assert sc.solo_folds == 0 and sc.coalesced_folds == 0


def test_fold_lane_spec_and_batch_fold_options_match_jax():
    """The lane is named as the reference's and interned per model;
    ``batch_fold``'s ``e_bucket`` pads the event axis as the reference's
    (the noted plan shape carries it) and ``owners`` is metadata."""
    from jepsen_tpu.campaign import compile_cache as jcc
    from jepsen_tpu.checker import streamlin as jstreamlin
    from jepsen_tpu_torch.campaign import compile_cache as tcc
    from jepsen_tpu_torch.fleet import service
    lane = streamlin.fold_lane_spec(SPEC)
    assert lane is streamlin.fold_lane_spec(SPEC)
    assert lane.name == jstreamlin.fold_lane_spec(JSPEC).name \
        == service.STREAM_LANE_PREFIX + SPEC.name
    assert streamlin.STREAM_LANE_PREFIX == jstreamlin.STREAM_LANE_PREFIX
    jobs = []
    for n, bad, overlap in LANE_STREAMS[:3]:
        sc = StreamCheck(SPEC, device="cpu")
        for i, op in enumerate(_paired(n, bad_at=bad, overlap=overlap)):
            sc.offer(op, i)
        e, init = sc.materialize()
        jobs.append(streamlin.history_job(SPEC, e, init, device="cpu"))
    jjobs = [jstreamlin.FoldJob(JSPEC, j.C, {
        k: (v.numpy() if hasattr(v, "numpy") else v)
        for k, v in j.arrays.items()}, len(j)) for j in jobs]
    tcc.reset()
    jcc.reset()
    got = streamlin.batch_fold(jobs, owners=["a", "b", "a"], e_bucket=256)
    want = jstreamlin.batch_fold(jjobs, owners=["a", "b", "a"],
                                 e_bucket=256)
    for g, w in zip(got, want):
        for k in ("status", "viol_slot", "passes", "steps", "n_live",
                  "batch"):
            assert g[k] == w[k], k
    assert [k[1][6] for k in tcc._seen] == [k[1][6] for k in jcc._seen]
    assert {k[1][6] for k in tcc._seen} == {256}
    tcc.reset()
    jcc.reset()
