"""The port's search hooks against the JAX package's, on the CPU: the same
seeded histories through the JAX engine and the port, each under a
fresh bound registry at ``chunk_iters=1``, give equal series names,
labels and counts, and equal
heartbeats -- for the single-key search, the key batch, ``batch_fold``,
``StreamCheck``, the competition and a certified ``core.check``. Seconds
(phase totals, busy walls) are compared by presence only. The
``compile`` phase is a ``device`` lap to these comparisons: the JAX
package arms it on its compile ledger, the port only on the card.

Also the port's own invariants: unbound, and bound with ``phases?``
off, a search issues the same torch ops and host reads (the loops'
status reads; ``streamlin.syncs`` for the fold) as with obs unbound; the
phase plane's synchronize runs once per chunk and only while phases are
on; a competition straggler writes into its own run's registry only;
certification replays are quiet."""

import contextlib
import random
import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from jepsen_tpu import checker as jcc
from jepsen_tpu import obs as jobs
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu.checker import jax_wgl
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.checker import streamlin as jstreamlin
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu.models import base as jbase
from jepsen_tpu.monitor.wgl_stream import StreamCheck as JStreamCheck
from jepsen_tpu.parallel import keyshard as jkeyshard
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs, simulate
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as cc
from jepsen_tpu_torch.checker import linear, streamlin, torch_wgl, wgl
from jepsen_tpu_torch.models import base as tbase
from jepsen_tpu_torch.monitor.wgl_stream import StreamCheck
from jepsen_tpu_torch.obs import phases as obs_phases
from jepsen_tpu_torch.parallel import keyshard

from test_streamlin import _paired
from test_torch_streamlin import _arrays, _history

MODEL = "cas-register"
JSPEC = jbase.model_spec(MODEL)
SPEC = tbase.model_spec(MODEL)
CPU = {"device": "cpu"}

#: series whose values are seconds: compared by presence only
TIMED = ("wgl.phase_s", "wgl.device_busy_s", "txn.closure_busy_s")
#: heartbeat and summary fields that follow the clock
CLOCKED = ("chunk_s", "device_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _join():
    yield
    ck.join_racers()


def _skip(key):
    """Series one side has for reasons outside this slice: the JAX
    package's compile ledger, and the JAX check's history lint and plan
    report (ROADMAP.md A.11(a))."""
    return (key.startswith("campaign.") or "analyzer=histlint" in key
            or "analyzer=searchplan" in key)


def _series(reg):
    """{(kind, series key): value} of a registry; seconds series map to
    None, histograms to their observation counts."""
    snap = reg.snapshot()
    out = {}
    for kind in ("counters", "gauges"):
        for k, v in snap[kind].items():
            if not _skip(k):
                k = k.replace("phase=compile", "phase=device")
                out[(kind, k)] = None if k.startswith(TIMED) else v
    for k, v in snap["histograms"].items():
        if not _skip(k):
            out[("histograms", k)] = v["count"]
    return out


def _events(tr, prefix=""):
    """The trace's (name, phase, args without clocked fields) in order,
    for the events whose names start with ``prefix``; phase spans reduce
    to their names."""
    out = []
    for e in tr.events():
        name = e["name"].replace("wgl.phase.compile", "wgl.phase.device")
        if not name.startswith(prefix) or name.startswith(
                ("analysis.histlint", "analysis.searchplan")):
            continue
        if e.get("cat") == "phase" or e["ph"] == "X":
            out.append((name, e["ph"]))
            continue
        args = {k: v for k, v in (e.get("args") or {}).items()
                if k not in CLOCKED}
        out.append((name, e["ph"], args))
    return out


def _same(mine, ref, prefix=""):
    """Equal series and equal non-span events; phase span name sets
    equal."""
    (tr, reg), (jtr, jreg) = mine, ref
    assert _series(reg) == _series(jreg)
    pick = [e for e in _events(tr, prefix) if len(e) == 3]
    jpick = [e for e in _events(jtr, prefix) if len(e) == 3]
    assert pick == jpick
    spans = {e for e in _events(tr, prefix) if len(e) == 2}
    jspans = {e for e in _events(jtr, prefix) if len(e) == 2}
    assert spans == jspans


@contextlib.contextmanager
def _bound(mod, test=None):
    """A fresh tracer/registry of ``mod`` bound as a run would bind it."""
    test = {} if test is None else test
    with mod.run_scope(test):
        yield test["obs"]["tracer"], test["obs"]["registry"]


def _hist(seed, n_ops=200, procs=6, bad=False):
    rng = random.Random(seed)
    hist = simulate.random_history(rng, MODEL, procs, n_ops, 0.05)
    if bad:
        # reads kept in range, so the search, not a fast path, decides
        hist = simulate.corrupt(rng, hist)
        for o in hist:
            if o["type"] == "ok" and o["f"] == "read" \
                    and isinstance(o.get("value"), int):
                o["value"] = o["value"] % 4
    return hist


def _encode_both(hist):
    return (JSPEC.encode([dict(o) for o in hist]),
            SPEC.encode([h.Op(o) for o in hist]))


# ---------------------------------------------------------------------------
# series parity

@pytest.mark.parametrize("seed,bad", [(1, False), (2, True), (5, True)])
def test_single_key_series_equal_jax(seed, bad):
    (je, jst), (e, st) = _encode_both(_hist(seed, bad=bad))
    with _bound(jobs) as ref:
        want = jax_wgl.check_encoded(JSPEC, je, jst, chunk_iters=1)
    with _bound(obs) as mine:
        got = torch_wgl.check_encoded(SPEC, e, st, chunk_iters=1, **CPU)
    assert got["valid"] == want["valid"]
    assert got["iterations"] == want["iterations"]
    _same(mine, ref)
    tr, reg = mine
    hb = [e for e in tr.events() if e["name"] == "wgl.heartbeat.jax-wgl"]
    assert len(hb) == reg.counter_value("wgl.chunks", engine="jax-wgl") \
        == want["iterations"]
    depths = [e["args"]["depth"] for e in hb]
    assert depths == sorted(depths)
    assert reg.counter_value("wgl.cells_real", engine="jax-wgl",
                             bucket=str(len(e) and torch_wgl._bucket(
                                 len(e), torch_wgl._n_floor()))) == len(e)


def test_fast_path_reports_nothing_in_either_package():
    """A history the host pre-checks decide: no session, no series."""
    hist = [h.invoke_op(0, "write", 1), h.ok_op(0, "write", 1),
            h.invoke_op(1, "read"), h.ok_op(1, "read", 7)]
    (je, jst), (e, st) = _encode_both(hist)
    with _bound(jobs) as ref:
        jax_wgl.check_encoded(JSPEC, je, jst, chunk_iters=1)
    with _bound(obs) as mine:
        assert torch_wgl.check_encoded(SPEC, e, st, **CPU)["valid"] is False
    _same(mine, ref)
    assert _series(mine[1]) == {}


def test_key_batch_series_equal_jax():
    """Four keys, one corrupted, at chunk_iters=1: the same plan (keys,
    lanes), heartbeats (keys_alive, keys_running, compactions,
    explored, depth) and summary as the JAX batch; explored never
    decreases across a compaction."""
    hists = [_hist(s, n_ops=120, procs=4, bad=(s == 3)) for s in range(4)]
    pairs = [_encode_both(x) for x in hists]
    with _bound(jobs) as ref:
        want = jkeyshard.check_batch_encoded(
            JSPEC, [p[0] for p in pairs], chunk_iters=1)
    with _bound(obs) as mine:
        got = keyshard.check_batch_encoded(
            SPEC, [p[1] for p in pairs], chunk_iters=1, **CPU)
    assert [g["valid"] for g in got] == [w["valid"] for w in want]
    _same(mine, ref)
    hb = [e["args"] for e in mine[0].events()
          if e["name"] == "wgl.heartbeat.jax-wgl-batch"]
    assert hb and {"keys_alive", "keys_running", "compactions", "explored",
                   "depth"} <= set(hb[-1])
    explored = [a["explored"] for a in hb]
    assert explored == sorted(explored)
    assert hb[-1]["compactions"] == got[0]["compactions"] >= 1
    plan = [e["args"] for e in mine[0].events()
            if e["name"] == "wgl.plan.jax-wgl-batch"]
    assert plan[0]["keys"] == 4 and plan[0]["lanes"] == 4


def test_batch_fold_series_equal_jax():
    jobs_ = []
    for seed, corrupt in ((0, False), (1, True), (2, False)):
        arrays, _C, n = _arrays(MODEL, _history(MODEL, seed, corrupt))
        jobs_.append((arrays, n))
    jj = [jstreamlin.FoldJob(JSPEC, 8, a, n) for a, n in jobs_]
    tj = [streamlin.FoldJob(SPEC, 8, a, n, **CPU) for a, n in jobs_]
    with _bound(jobs) as ref:
        jstreamlin.batch_fold(jj)
    streamlin.syncs = 0
    with _bound(obs) as mine:
        streamlin.batch_fold(tj)
    bound_syncs, streamlin.syncs = streamlin.syncs, 0
    streamlin.batch_fold(tj)
    assert streamlin.syncs == bound_syncs
    _same(mine, ref)
    assert mine[1].counter_value("wgl.chunks",
                                 engine="streamlin-batch") == 1


@pytest.mark.parametrize("bad_at", [None, 5])
def test_stream_check_series_equal_jax(bad_at):
    """A stream fed op by op and checked every 3 completions: the same
    ``monitor.*`` counters and gauges, ``streamlin`` plan and
    heartbeats; the sinks are the ones bound at construction."""
    ops = _paired(12, bad_at=bad_at, overlap=True)
    out = {}
    for name, mod, make in (
            ("jax", jobs, lambda: JStreamCheck(JSPEC, opts={
                "coalesce?": False})),
            ("port", obs, lambda: StreamCheck(SPEC, device="cpu"))):
        streamlin.syncs = 0
        with _bound(mod) as sinks:
            sc = make()
        verdicts = []
        done = 0
        with mod.bind(mod.Tracer(), mod.Registry()):
            for i, op in enumerate(ops):
                done += bool(sc.offer(op, i))
                if done and done % 3 == 0:
                    verdicts.append(sc.check()["valid"])
        out[name] = (sinks, verdicts, streamlin.syncs)
    assert out["port"][1] == out["jax"][1]
    _same(out["port"][0], out["jax"][0])
    assert any(k[1].startswith("monitor.") for k in _series(out["port"][0][1]))
    # unbound: the fold makes the same host reads
    streamlin.syncs = 0
    sc = StreamCheck(SPEC, device="cpu")
    done = 0
    for i, op in enumerate(ops):
        done += bool(sc.offer(op, i))
        if done and done % 3 == 0:
            sc.check()
    assert streamlin.syncs == out["port"][2]


def test_competition_series_equal_jax(monkeypatch):
    """The CPU racers give up at once in both packages, so the device
    racer wins: its search series and ``checker.competition_wins`` land
    in the run's registry, equal to the JAX race's."""
    unknown = {"valid": "unknown", "error": "budget"}
    for mod in (jwgl, jlinear, wgl, linear):
        monkeypatch.setattr(mod, "check_encoded",
                            lambda *a, **k: dict(unknown))
    hist = _hist(4)
    with _bound(jobs) as ref:
        want = jck.linearizable({"model": MODEL}).check(
            {}, [dict(o) for o in hist])
    with _bound(obs) as mine:
        got = ck.linearizable({"model": MODEL, "engine_opts": dict(CPU)}
                              ).check({}, [h.Op(o) for o in hist])
        ck.join_racers()
    assert got["valid"] is want["valid"] is True
    assert got["engine"] == want["engine"] == "jax-wgl"
    _same(mine, ref)
    assert mine[1].counter_value("checker.competition_wins",
                                 engine="jax-wgl") == 1


def test_competition_straggler_writes_into_its_own_run_only(monkeypatch):
    """The device racer is held back until the race is decided by
    ``wgl``; a fresh registry is bound for the next run before it
    starts. Its search (one chunk, then the cancel) lands in the first
    run's registry and nothing reaches the next run's."""
    release = threading.Event()
    real = torch_wgl.check_encoded

    def late(*a, **k):
        release.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(torch_wgl, "check_encoded", late)
    monkeypatch.setattr(linear, "check_encoded",
                        lambda *a, **k: {"valid": "unknown"})
    hist = [h.Op(o) for o in _hist(4)]
    with _bound(obs) as (tr_a, reg_a):
        got = ck.linearizable({"model": MODEL, "engine_opts": dict(CPU)}
                              ).check({}, hist)
    assert got["engine"] == "wgl"
    with _bound(obs) as (tr_b, reg_b):
        release.set()
        ck.join_racers()
        obs.inc("next.step")
    assert reg_a.counter_value("wgl.searches", engine="jax-wgl") == 1
    assert reg_a.counter_value("checker.competition_wins",
                               engine="wgl") == 1
    assert _series(reg_b) == {("counters", "next.step"): 1}
    assert not [e for e in tr_b.events() if e["name"].startswith("wgl.")]


def test_certified_check_series_equal_jax_and_replays_are_quiet():
    """``core.check`` certifies the device verdict (witness replay,
    differential replays through every engine): the same series as the
    JAX check's, and the same ``wgl.*`` series as the check with
    certification off -- one logical search."""
    hist = _hist(6, n_ops=80, procs=4)
    lin = {"model": MODEL, "algorithm": "jax-wgl"}
    with _bound(jobs) as ref:
        jtest = {}
        want = jcc.check(jck.linearizable(lin), jtest,
                         [dict(o) for o in hist])
    with _bound(obs) as mine:
        test = {}
        got = cc.check(ck.linearizable({**lin, "engine_opts": dict(CPU)}),
                       test, [h.Op(o) for o in hist])
    with _bound(obs) as plain:
        cc.check(ck.linearizable({**lin, "engine_opts": dict(CPU)}),
                 {"certify?": False}, [h.Op(o) for o in hist])
    assert got["valid"] is want["valid"] is True
    assert test["certificate"]["checks"] == jtest["certificate"]["checks"]
    _same(mine, ref)
    wgl_only = {k: v for k, v in _series(mine[1]).items()
                if k[1].startswith("wgl.")}
    assert wgl_only == {k: v for k, v in _series(plain[1]).items()
                        if k[1].startswith("wgl.")}
    assert mine[1].counter_value("wgl.searches", engine="jax-wgl") == 1
    assert mine[1].counter_value("analysis.certify.runs",
                                 verdict="True") == 1


def test_check_safe_traces_every_checker_like_jax():
    bad = [h.invoke_op(0, "write", 1), h.ok_op(0, "write", 1),
           h.invoke_op(1, "read"), h.ok_op(1, "read", 7)]
    with _bound(jobs) as ref:
        jcc.check_safe(jcc.compose({"a": jcc.unbridled_optimism(),
                                    "b": jcc.noop()}),
                       {"certify?": False}, [dict(o) for o in bad])
    with _bound(obs) as mine:
        cc.check_safe(cc.compose({"a": cc.unbridled_optimism(),
                                  "b": cc.noop()}),
                      {"certify?": False}, bad)
    _same(mine, ref, prefix="checker.")
    assert mine[1].counter_value("checker.checks", checker="Compose",
                                 valid="True") == 1


# ---------------------------------------------------------------------------
# cost invariants: no new op, read or sync unless phases are on

class _Ops(TorchDispatchMode):
    """Counts the torch ops a run issues (views excluded: they launch
    nothing on the card)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _counting(monkeypatch):
    """Count host reads (tolist, numpy, item, bool, int), torch ops, and
    the phase plane's synchronizes that would run (enabled sessions)."""
    got = {"reads": 0, "syncs": 0}
    for name in ("tolist", "numpy", "item", "__bool__", "__int__"):
        real = getattr(torch.Tensor, name)

        def wrap(self, *a, _real=real, **k):
            got["reads"] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrap)
    real_sync = obs_phases.PhaseSession.sync

    def sync(self, *t):
        got["syncs"] += bool(self.enabled)
        return real_sync(self, *t)

    monkeypatch.setattr(obs_phases.PhaseSession, "sync", sync)
    ops = _Ops()
    with ops:
        yield got
    got["ops"] = ops.n
    monkeypatch.undo()


def _modes():
    """unbound, bound with phases off, bound with phases on."""
    return (("unbound", None), ("phases-off", {"phases?": False}),
            ("phases-on", {}))


@pytest.mark.parametrize("what", ["single", "batch"])
def test_bound_search_costs_what_the_unbound_search_costs(what,
                                                          monkeypatch):
    if what == "single":
        (_, _), (e, st) = _encode_both(_hist(2, bad=True))

        def run():
            return torch_wgl.check_encoded(SPEC, e, st, chunk_iters=1,
                                           **CPU)
    else:
        pairs = [SPEC.encode([h.Op(o) for o in _hist(s, n_ops=100,
                                                      procs=4)])
                 for s in range(3)]

        def run():
            return keyshard.check_batch_encoded(SPEC, pairs, chunk_iters=1,
                                                **CPU)
    counts, results = {}, {}
    for mode, test in _modes():
        with contextlib.ExitStack() as stack:
            if test is not None:
                stack.enter_context(obs.run_scope(dict(test)))
            with _counting(monkeypatch) as got:
                results[mode] = run()
        counts[mode] = got
    for mode in ("phases-off", "phases-on"):
        assert counts[mode]["ops"] == counts["unbound"]["ops"], counts
        assert counts[mode]["reads"] == counts["unbound"]["reads"], counts
        assert results[mode] == results["unbound"]
    assert counts["unbound"]["syncs"] == counts["phases-off"]["syncs"] == 0
    # phases on: the h2d bracket plus one per chunk (one iteration each)
    its = max(r.get("iterations") or 0 for r in (
        results["unbound"] if what == "batch" else [results["unbound"]]))
    assert counts["phases-on"]["syncs"] == its + 1
