"""The port's obs core (jepsen_tpu_torch/obs: trace, metrics, the facade,
search sessions, phase sessions) against the JAX package's
(jepsen_tpu/obs) on the CPU: the unit cases of tests/test_obs.py,
tests/test_phases.py and tests/test_introspection.py run against the
port's copies, and where a case yields data (a trace, a snapshot, a
Prometheus text, a journal) the port's output equals the JAX package's
on the same inputs. Tolerance: equality, except wall-clock fields."""

import contextvars
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from jepsen_tpu import obs as jobs
from jepsen_tpu.obs import phases as jphases
from jepsen_tpu.obs import search as jsearch
from jepsen_tpu_torch import obs, store
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import phases as obs_phases
from jepsen_tpu_torch.obs import search as obs_search

#: trace fields that follow the clock, the process or the thread
CLOCKED = ("ts", "dur", "pid", "tid")


def _shape(events):
    """Events without their clocked fields (and the wall-clock anchor's
    epoch), for comparing two tracers fed the same calls."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in CLOCKED}
        if e.get("name") == "trace_meta":
            e["args"] = {k: v for k, v in e["args"].items()
                         if k != "epoch_ns"}
        out.append(e)
    return out


def _phase_events(tr):
    return [e for e in tr.events()
            if e.get("ph") == "X" and e.get("cat") == "phase"]


# ---------------------------------------------------------------------------
# tracer (test_obs.py)

def test_off_by_default():
    assert not obs.enabled()
    assert obs.tracer() is None and obs.registry() is None
    with obs.span("x"):
        obs.instant("i")
        obs.complete("c", 0, 10)
        obs.inc("n")
        obs.observe("h", 0.1)
        obs.set_gauge("g", 1)
        obs.max_gauge("g", 2)
        obs.observe_many("h", [0.1, 0.2])
        obs.counter_track("t", v=1)
        obs.flush()
    assert not obs.enabled()


def test_span_nesting_and_thread_propagation():
    tr = obs.Tracer()
    inner_parent = {}
    with obs.bind(tr, None):
        with tr.span("outer"):
            assert obs.current_span() == "outer"
            ctx = contextvars.copy_context()

            def worker():
                inner_parent["before"] = obs.current_span()
                with tr.span("inner"):
                    pass

            t = threading.Thread(target=ctx.run, args=(worker,))
            t.start()
            t.join()
    evs = {e["name"]: e for e in tr.events() if e["ph"] == "X"}
    assert inner_parent["before"] == "outer"
    assert evs["inner"]["args"]["parent"] == "outer"
    assert "parent" not in (evs["outer"].get("args") or {})
    assert evs["inner"]["tid"] != evs["outer"]["tid"]


def _feed(mod, context=None):
    """The same calls into a tracer of ``mod`` (the port's obs or the JAX
    package's)."""
    tr = mod.Tracer(context=context)
    with tr.span("phase", args={"k": 1}):
        tr.instant("marker", cat="search", args={"n": 2})
        with tr.span("inner", cat="checker"):
            pass
    tr.counter("frontier", {"depth": 3})
    tr.complete("op", 10_000, 2_000, cat="op", args={"f": "read"})
    tr.async_begin("partition", 1, cat="nemesis")
    tr.async_end("partition", 1, cat="nemesis")
    tr.name_thread(7, "worker 7")
    tr.name_thread(7, "worker 7")
    return tr


def test_trace_dump_is_chrome_trace_loadable(tmp_path):
    tr = obs.Tracer()
    with tr.span("phase", args={"k": 1}):
        tr.instant("marker", cat="search")
    tr.counter("frontier", {"depth": 3})
    p = tr.dump(str(tmp_path / "trace.jsonl"))
    text = pathlib.Path(p).read_text()
    assert text.startswith("[\n")
    whole = json.loads(text.rstrip().rstrip(",") + "]")
    assert {e["name"] for e in whole} == {"trace_meta", "phase",
                                          "marker", "frontier"}
    for e in whole:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
    evs = obs.load_trace(p)
    assert len(evs) == 4
    assert obs.trace_meta(evs)["epoch_ns"] > 0
    x = [e for e in evs if e["ph"] == "X"][0]
    assert x["dur"] >= 0


def test_trace_equals_the_jax_tracer(tmp_path):
    """The same calls give the same events, the same dump and each
    package's loader reads the other's file."""
    ctx = {"campaign": "c", "cell": "a"}
    mine, ref = _feed(obs, ctx), _feed(jobs, ctx)
    assert _shape(mine.events()) == _shape(ref.events())
    pm = mine.dump(str(tmp_path / "port.jsonl"))
    pj = ref.dump(str(tmp_path / "jax.jsonl"))
    assert _shape(obs.load_trace(pj)) == _shape(jobs.load_trace(pm))
    assert _shape(obs.load_trace(pm)) == _shape(jobs.load_trace(pj))
    assert obs.trace_meta(obs.load_trace(pm))["context"] == ctx


def test_tracer_event_cap(tmp_path):
    tr = obs.Tracer(max_events=3)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr.events()) == 3
    assert tr.dropped == 7
    evs = obs.load_trace(tr.dump(str(tmp_path / "t.jsonl")))
    marker = [e for e in evs if e["name"] == "trace_truncated"]
    assert marker and marker[0]["args"]["dropped_events"] == 7


def test_trace_journal_equals_the_jax_journal(tmp_path):
    """The crash-safe journal: per-event durability, torn final line
    dropped on read, retired by the final dump; the same lines as the
    JAX package's journal."""
    got = {}
    for name, mod in (("port", obs), ("jax", jobs)):
        tr = mod.Tracer()
        p = str(tmp_path / f"{name}.journal")
        assert tr.attach_journal(p, flush_s=0) == p
        assert tr.journaling()
        tr.instant("a", args={"i": 1})
        with tr.span("b"):
            pass
        with open(p, "a") as f:
            f.write('{"torn":')
        got[name] = mod.load_trace(p)
        tr.close_journal(remove=True)
        assert not pathlib.Path(p).exists()
    assert _shape(got["port"]) == _shape(got["jax"])
    assert [e["name"] for e in got["port"]] == ["trace_meta", "a", "b"]


# ---------------------------------------------------------------------------
# metrics (test_obs.py)

def test_histogram_bucket_math():
    h = obs_metrics.Histogram(bounds=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.001, 0.005, 0.05, 99.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1]
    assert h.count == 5
    assert h.sum == pytest.approx(0.0565 + 99.0)
    assert h.min == 0.0005 and h.max == 99.0
    assert h.quantile(0.5) == 0.01
    assert h.quantile(0.99) == 99.0
    d = h.to_dict()
    assert d["buckets_le"] == [0.001, 0.01, 0.1]
    assert len(d["counts"]) == len(d["buckets_le"]) + 1
    assert obs_metrics.Histogram().quantile(0.5) is None
    ref = jobs.Histogram(bounds=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.001, 0.005, 0.05, 99.0):
        ref.observe(v)
    assert d == ref.to_dict()


def _fill(reg):
    reg.inc("ops", f="read")
    reg.inc("ops", 2, f="read")
    reg.inc("ops", f="write")
    reg.set_gauge("depth", 7)
    reg.max_gauge("depth_max", 3)
    reg.max_gauge("depth_max", 9)
    reg.max_gauge("depth_max", 5)
    reg.observe("lat", 0.002)
    reg.observe_many("lat", [0.02, 0.2], f="read")
    return reg


def test_registry_labels_and_snapshot():
    reg = _fill(obs.Registry())
    snap = reg.snapshot()
    assert snap["counters"]["ops{f=read}"] == 3
    assert snap["counters"]["ops{f=write}"] == 1
    assert snap["gauges"]["depth"] == 7
    assert snap["gauges"]["depth_max"] == 9
    assert snap["histograms"]["lat"]["count"] == 1
    json.dumps(snap)
    assert snap == _fill(jobs.Registry()).snapshot()


def test_default_labels_and_prometheus_equal_the_jax_registry():
    labels = {"campaign": "c", "cell": "a"}
    mine = _fill(obs.Registry(default_labels=labels))
    ref = _fill(jobs.Registry(default_labels=labels))
    assert mine.snapshot() == ref.snapshot()
    assert mine.counter_value("ops", f="read") == 3
    assert mine.gauge_value("depth") == 7
    assert obs.render_prometheus([mine]) == jobs.render_prometheus([ref])


def test_metrics_journal_round_trips_across_packages(tmp_path):
    for writer, reader in ((obs, jobs), (jobs, obs)):
        reg = _fill(writer.Registry())
        p = str(tmp_path / f"{writer.__name__}.journal")
        reg.attach_journal(p, flush_s=0)
        reg.inc("late")
        reg.journal_now()
        with open(p, "a") as f:
            f.write('{"torn":')
        assert reader.load_metrics_journal(p) == reg.snapshot()
        reg.close_journal(remove=True)


def test_metrics_snapshot_roundtrip_through_store(tmp_path):
    reg = obs.Registry()
    reg.inc("explored", np.int64(42))
    reg.set_gauge("load", np.float32(0.5))
    reg.set_gauge("dropped", np.bool_(False))
    reg.set_gauge("shards", np.array([3, 1]))
    reg.set_gauge("dir", pathlib.Path("/tmp/x"))
    p = str(tmp_path / "metrics.json")
    store._dump_json(reg.snapshot(), p)
    back = json.load(open(p))
    assert back["counters"]["explored"] == 42
    assert back["gauges"]["load"] == 0.5
    assert back["gauges"]["dropped"] is False
    assert back["gauges"]["shards"] == [3, 1]
    assert back["gauges"]["dir"] == "/tmp/x"


# ---------------------------------------------------------------------------
# search sessions (test_obs.py, test_introspection.py)

def test_search_session_pins_sinks_at_capture():
    tr_a, reg_a = obs.Tracer(), obs.Registry()
    with obs.bind(tr_a, reg_a):
        so = obs_search.capture()
        so.heartbeat("jax-wgl", iteration=1, chunk_s=0.1, frontier=5)
    tr_b, reg_b = obs.Tracer(), obs.Registry()
    with obs.bind(tr_b, reg_b):
        so.heartbeat("jax-wgl", iteration=2, chunk_s=0.1, frontier=3)
        so.summary("jax-wgl", {"valid": True, "configs_explored": 9})
    assert reg_a.counter_value("wgl.chunks", engine="jax-wgl") == 2
    assert reg_a.counter_value("wgl.searches", engine="jax-wgl") == 1
    assert reg_b.snapshot() == {"counters": {}, "gauges": {},
                                "histograms": {}}
    assert tr_b.events() == []
    assert len([e for e in tr_a.events()
                if e["name"] == "wgl.heartbeat.jax-wgl"]) == 2
    so_off = obs_search.capture()
    assert not so_off.enabled()
    so_off.heartbeat("jax-wgl", iteration=1, chunk_s=0.1)


def _session_calls(mod_obs, mod_search):
    tr, reg = mod_obs.Tracer(), mod_obs.Registry()
    so = mod_search.SearchObs(tr, reg)
    so.plan("jax-wgl-batch", 256, 600, 1024, keys=3, lanes=4, owners=2)
    so.heartbeat("jax-wgl-batch", iteration=1, chunk_s=0.5, device_s=0.25,
                 frontier=7, explored=11, depth=3, keys_alive=4,
                 keys_running=2, compactions=1, shard_tops=[2, 0])
    so.heartbeat("jax-wgl-batch", iteration=2, chunk_s=0.125, frontier=1,
                 explored=20, depth=2, keys_alive=2, keys_running=0,
                 compactions=1)
    so.summary("jax-wgl-batch",
               {"valid": "batch", "configs_explored": 20, "iterations": 2,
                "table_load": 0.01, "table_insert_failures": 0},
               keys=3, shard_explored=[15, 5])
    return tr, reg


def test_search_session_equals_the_jax_session():
    """plan/heartbeat/summary on the same inputs: the same registry
    snapshot and the same trace events."""
    tr, reg = _session_calls(obs, obs_search)
    jtr, jreg = _session_calls(jobs, jsearch)
    assert reg.snapshot() == jreg.snapshot()
    assert _shape(tr.events()) == _shape(jtr.events())
    assert reg.gauge_value("wgl.search_depth", engine="jax-wgl-batch") == 3
    assert obs_search.HEARTBEAT_MIN_INTERVAL_S == \
        jsearch.HEARTBEAT_MIN_INTERVAL_S
    assert obs_search.CHUNK_BUCKETS_S == jsearch.CHUNK_BUCKETS_S


def test_heartbeat_device_s_repoints_busy():
    reg = obs.Registry()
    with obs.bind(None, reg):
        so = obs_search.capture()
        so.heartbeat("jax-wgl", iteration=1, chunk_s=1.0, device_s=0.2)
        so.heartbeat("jax-wgl", iteration=2, chunk_s=0.5)
    busy = reg.counter_value("wgl.device_busy_s", engine="jax-wgl")
    assert busy == pytest.approx(0.7)
    h = reg.snapshot()["histograms"]["wgl.chunk_s{engine=jax-wgl}"]
    assert h["count"] == 2 and h["sum"] == pytest.approx(1.5)
    assert busy <= h["sum"]


def test_progress_interval_throttles_trace_not_accounting():
    tr, reg = obs.Tracer(), obs.Registry()
    so = obs_search.SearchObs(tr, reg, min_interval_s=3600.0)
    for i in range(5):
        so.heartbeat("jax-wgl", iteration=i, chunk_s=0.01, frontier=1,
                     explored=i, depth=i)
    hb = [ev for ev in tr.events()
          if ev.get("name") == "wgl.heartbeat.jax-wgl"]
    assert len(hb) == 1, "only the first emission within the interval"
    assert reg.counter_value("wgl.chunks", engine="jax-wgl") == 5
    assert reg.gauge_value("wgl.states_explored", engine="jax-wgl") == 4


def test_progress_interval_comes_from_the_run_scope():
    test = {"progress-interval-s": 3600.0}
    with obs.run_scope(test):
        so = obs_search.capture()
        for i in range(3):
            so.heartbeat("jax-wgl", iteration=i, chunk_s=0.01)
    tr = test["obs"]["tracer"]
    assert len([e for e in tr.events()
                if e["name"] == "wgl.heartbeat.jax-wgl"]) == 1


def test_capture_prefers_run_scoped_sinks_over_globals():
    tr_a = obs.Tracer(context={"campaign": "c", "cell": "a"})
    reg_a = obs.Registry(default_labels={"campaign": "c", "cell": "a"})
    tr_b = obs.Tracer(context={"campaign": "c", "cell": "b"})
    reg_b = obs.Registry(default_labels={"campaign": "c", "cell": "b"})
    with obs.bind(tr_a, reg_a):
        with obs.bind(tr_b, reg_b):
            assert obs.registry() is reg_b
            with obs.sink_scope(tr_a, reg_a):
                so = obs_search.capture()
            so.heartbeat("jax-wgl", iteration=1, chunk_s=0.1,
                         frontier=5, explored=10, depth=2)
    assert reg_a.counter_value("wgl.chunks", engine="jax-wgl") == 1
    assert reg_b.counter_value("wgl.chunks", engine="jax-wgl") == 0
    key = "wgl.chunks{campaign=c,cell=a,engine=jax-wgl}"
    assert reg_a.snapshot()["counters"][key] == 1


def test_run_scope_pins_sinks_for_competition_threads():
    test = {"obs?": True}
    got = {}
    with obs.run_scope(test):
        reg_mine = test["obs"]["registry"]
        other = obs.Registry()

        def worker():
            got["sinks"] = obs.current_sinks()

        ctx = contextvars.copy_context()
        with obs.bind(None, other):
            t = threading.Thread(target=ctx.run, args=(worker,))
            t.start()
            t.join()
    assert got["sinks"][1] is reg_mine


def test_run_scope_opt_out_and_context_labels():
    test = {"obs?": False, "obs": "stale"}
    with obs.run_scope(test) as sinks:
        assert sinks == (None, None) and not obs.enabled()
    assert "obs" not in test
    test = {"obs-context": {"campaign": "c", "cell": "x"},
            "phases?": False}
    with obs.run_scope(test):
        assert obs.enabled()
        assert obs.run_config() == {"phases?": False}
        obs.inc("n")
    reg = test["obs"]["registry"]
    assert reg.snapshot()["counters"] == {"n{campaign=c,cell=x}": 1}
    assert obs.run_config() == {} and not obs.enabled()


def test_live_registries_exposes_every_open_bind():
    r1, r2 = obs.Registry(), obs.Registry()
    with obs.bind(None, r1):
        with obs.bind(None, r2):
            live = obs.live_registries()
            assert r1 in live and r2 in live
    assert obs.live_registries() == []


def test_overlapping_binds_unwind_in_any_order():
    r1, r2 = obs.Registry(), obs.Registry()
    s1, s2 = obs.bind(None, r1), obs.bind(None, r2)
    s1.__enter__()
    s2.__enter__()
    s1.__exit__(None, None, None)         # the older scope ends first
    assert obs.registry() is r2
    s2.__exit__(None, None, None)
    assert obs.registry() is None


# ---------------------------------------------------------------------------
# phase sessions (test_phases.py)

def test_session_spans_contiguous_and_nonoverlapping():
    tr, reg = obs.Tracer(), obs.Registry()
    with obs.bind(tr, reg):
        ph = obs_phases.capture("unit")
        assert ph.enabled
        for phase in ("encode", "plan", "h2d", "device", "d2h", "host"):
            time.sleep(0.002)
            ph.lap(phase)
    evs = sorted(_phase_events(tr), key=lambda e: e["ts"])
    assert [e["name"] for e in evs] == [
        f"wgl.phase.{p}" for p in ("encode", "plan", "h2d", "device",
                                   "d2h", "host")]
    for a, b in zip(evs, evs[1:]):
        assert abs((a["ts"] + a["dur"]) - b["ts"]) < 1.0, (a, b)
    for e in evs:
        phase = e["name"][len("wgl.phase."):]
        c = reg.counter_value("wgl.phase_s", phase=phase, engine="unit")
        assert c == pytest.approx(e["dur"] / 1e6, rel=1e-6)
        assert ph.totals[phase] == pytest.approx(e["dur"] / 1e6, rel=1e-6)


def test_compile_phase_only_after_a_miss():
    tr, reg = obs.Tracer(), obs.Registry()
    with obs.bind(tr, reg):
        ph = obs_phases.capture("unit")
        ph.note_compile(True)
        ph.lap("device")
        ph.lap("device")
        ph.note_compile(False)
        ph.lap("device")
    names = [e["name"] for e in sorted(_phase_events(tr),
                                       key=lambda e: e["ts"])]
    assert names == ["wgl.phase.compile", "wgl.phase.device",
                     "wgl.phase.device"]


def test_disabled_session_times_but_emits_nothing():
    ph = obs_phases.capture("unit")
    assert not ph.enabled
    time.sleep(0.002)
    assert ph.lap("device") > 0.0
    assert ph.totals == {}
    tr, reg = obs.Tracer(), obs.Registry()
    with obs.bind(tr, reg), obs.sink_scope(tr, reg, {"phases?": False}):
        ph2 = obs_phases.capture("unit")
        assert not ph2.enabled
        assert ph2.lap("device") >= 0.0
        obs_phases.note_wait("unit", 0.1)
    assert _phase_events(tr) == []
    assert reg.snapshot()["counters"] == {}


def test_note_wait_emits_one_span_and_counter():
    tr, reg = obs.Tracer(), obs.Registry()
    with obs.bind(tr, reg):
        obs_phases.note_wait("unit", 0.25, owner="t1")
    evs = _phase_events(tr)
    assert len(evs) == 1 and evs[0]["name"] == "wgl.phase.wait"
    assert evs[0]["dur"] == pytest.approx(0.25e6, rel=1e-6)
    assert evs[0]["args"]["owner"] == "t1"
    assert reg.counter_value("wgl.phase_s", phase="wait",
                             engine="unit") == pytest.approx(0.25)
    with obs.bind(tr, reg):
        obs_phases.note_wait("unit", None)
        obs_phases.note_wait("unit", -3.0)
    assert reg.counter_value("wgl.phase_s", phase="wait",
                             engine="unit") == pytest.approx(0.25)


def test_phase_vocabulary_equals_the_jax_package():
    assert obs_phases.PHASES == jphases.PHASES
    assert obs_phases.CAT == jphases.CAT
    assert obs_phases.METRIC == jphases.METRIC


class _FakeCuda:
    """Stands for a CUDA tensor: the session only asks ``is_cuda`` and
    ``device``."""

    def __init__(self, index):
        self.is_cuda = True
        self.device = torch.device("cuda", index)


def test_phase_sync_synchronizes_only_cuda_devices_while_enabled(
        monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    carry = (torch.zeros(2), (_FakeCuda(0), _FakeCuda(0)), None)
    ph = obs_phases.capture("unit")           # unbound: a no-op
    ph.sync(carry, _FakeCuda(1))
    assert synced == []
    with obs.bind(None, obs.Registry()):
        ph = obs_phases.capture("unit")
        ph.sync(torch.zeros(3), (torch.ones(1),))   # CPU: nothing to do
        assert synced == []
        ph.sync(carry, _FakeCuda(1))
    assert sorted(d.index for d in synced) == [0, 1]
    with obs.bind(None, obs.Registry()), \
            obs.sink_scope(None, obs.registry(), {"phases?": False}):
        obs_phases.capture("unit").sync(carry)
    assert len(synced) == 2
