"""The port's campaign folds (``jepsen_tpu_torch/obs/merge.py``,
``obs/bubbles.py``) against the JAX package's.

Both packages read the same trace, metrics and journal files (one store
directory, pointed at by both ``store`` modules) and must write
byte-identical artifacts: ``campaign_trace.jsonl``, ``metrics_fold.json``
and ``bubble_ledger.json``. The returned summaries are compared whole,
with the artifact's absolute path masked (each package writes its own
copy). The inputs are the reference tests' synthetic fleet campaigns
(``tests/test_obs_fleet.py``, ``tests/test_phases.py``) and a real
campaign the port's scheduler runs on the CPU. Tolerance: equality."""

import json
import os
import shutil

import pytest
import torch

from jepsen_tpu import obs as jobs
from jepsen_tpu import store as jstore
from jepsen_tpu.campaign.journal import CampaignJournal
from jepsen_tpu.obs import bubbles as jbubbles
from jepsen_tpu.obs import merge as jmerge
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.obs import bubbles as tbubbles
from jepsen_tpu_torch.obs import merge as tmerge

COORD_EPOCH_NS = 1_000_000_000_000_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "store"))


def _write_trace(d, epoch_ns, events, context=None, name="trace.jsonl"):
    os.makedirs(d, exist_ok=True)
    meta = {"name": "trace_meta", "ph": "i", "cat": "__metadata",
            "ts": 0, "pid": 1, "tid": 0, "s": "g",
            "args": {"epoch_ns": epoch_ns,
                     **({"context": context} if context else {})}}
    with open(os.path.join(d, name), "w") as f:
        for ev in [meta] + events:
            f.write(json.dumps(ev) + "\n")


def _phase(ts_us, dur_us, phase, engine="jax-wgl", pid=4, tid=1):
    return {"ph": "X", "cat": "phase", "name": f"wgl.phase.{phase}",
            "pid": pid, "tid": tid, "ts": float(ts_us),
            "dur": float(dur_us), "args": {"engine": engine}}


def _metrics(d, counters=None, gauges=None, hists=None):
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump({"counters": counters or {}, "gauges": gauges or {},
                   "histograms": hists or {}}, f)


def _hist(le, counts, total, n, lo, hi):
    return {"buckets_le": le, "counts": counts, "sum": total,
            "count": n, "min": lo, "max": hi}


def _clock(off, start=100.0):
    return {"coord-sent-epoch": start,
            "worker-received-epoch": start + 0.05 + off,
            "worker-result-epoch": start + 3.0 + off,
            "coord-received-epoch": start + 3.05}


def skew(cid):
    """A fleet campaign: a coordinator trace, two workers' runs with
    clocks 2 s ahead and 1.5 s behind, metrics on every run."""
    jr = CampaignJournal(cid)
    jr.write_meta({"id": cid, "status": "complete",
                   "cells": ["c0", "c1", "c2"]})
    _write_trace(jstore.campaign_path(cid), COORD_EPOCH_NS,
                 [{"name": "fleet.lease.grant", "ph": "i", "ts": 500.0,
                   "pid": 9, "tid": 1, "cat": "fleet"}])
    _metrics(jstore.campaign_path(cid),
             counters={"fleet.leases": 3,
                       "wgl.chunks{campaign=x,cell=c0}": 99},
             gauges={"fleet.workers": 2})
    for i, (w, off) in enumerate((("w1", 2.0), ("w2", -1.5),
                                  ("w1", 2.0))):
        run_dir = jstore.campaign_path(cid, f"run-c{i}")
        _write_trace(run_dir,
                     COORD_EPOCH_NS + int((1.0 + i + off) * 1e9),
                     [{"name": "jepsen.run", "ph": "X", "ts": 0.0,
                       "dur": 2e6, "pid": 4, "tid": 1,
                       "cat": "lifecycle"},
                      _phase(10, 5000, "encode"),
                      _phase(5010, 20000, "device"),
                      _phase(25010, 3000, "d2h"),
                      _phase(40000, 1000, "host"),
                      _phase(3e6, 1000, "device", engine="jax-wgl-batch")],
                     context={"campaign": cid, "cell": f"c{i}",
                              "worker": w})
        _metrics(run_dir,
                 counters={"wgl.cells_real{bucket=64,engine=jax-wgl}":
                           40 + i,
                           "wgl.cells_padded{bucket=64,engine=jax-wgl}":
                           24 - i,
                           "wgl.device_busy_s{engine=jax-wgl}": 0.25,
                           "wgl.phase_s{engine=jax-wgl,phase=device}":
                           0.25,
                           "wgl.phase_s{engine=jax-wgl,phase=h2d}": 0.5},
                 gauges={"wgl.frontier_peak": 10 * (i + 1),
                         "wgl.label": "x"},
                 hists={"wgl.chunk_s{engine=jax-wgl}":
                        _hist([0.1, 1.0] if i < 2 else [0.5],
                              [1, 2] if i < 2 else [3],
                              0.75 + i, 3, 0.01 * (i + 1), 0.5)})
        jr.append_cell({"cell": f"c{i}", "group": "g", "outcome": True,
                        "worker": w, "path": run_dir, "wall_s": 2.0,
                        "clock": _clock(off, 100.0 + i)})
    # a cell whose artifacts never came home
    jr.append_cell({"cell": "c9", "group": "g", "outcome": "crashed",
                    "worker": "w3",
                    "path": jstore.campaign_path(cid, "never-synced")})
    return jr


def journal_fallback(cid):
    """Only the incremental journals survived (a kill -9): torn tails
    are dropped."""
    jr = CampaignJournal(cid)
    jr.write_meta({"id": cid, "status": "aborted", "cells": ["c9"]})
    run_dir = jstore.campaign_path(cid, "run-killed")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, jstore.TRACE_JOURNAL_FILE), "w") as f:
        f.write(json.dumps(
            {"name": "trace_meta", "ph": "i", "cat": "__metadata",
             "ts": 0, "pid": 1, "tid": 0,
             "args": {"epoch_ns": COORD_EPOCH_NS}}) + "\n")
        f.write(json.dumps(_phase(7, 100, "device")) + "\n")
        f.write('{"name": "torn')
    with open(os.path.join(run_dir, jstore.METRICS_JOURNAL_FILE),
              "w") as f:
        f.write(json.dumps({"counters": {"n": 1}, "gauges": {},
                            "histograms": {}}) + "\n")
        f.write('{"counters": {"n"')
    jr.append_cell({"cell": "c9", "group": "g", "outcome": "crashed",
                    "worker": "w9", "path": run_dir})
    return jr


def no_anchor(cid):
    """Pre-plane traces: no trace_meta anchor anywhere."""
    jr = CampaignJournal(cid)
    jr.write_meta({"id": cid, "status": "complete", "cells": ["a"]})
    run_dir = jstore.campaign_path(cid, "run-a")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "trace.jsonl"), "w") as f:
        f.write(json.dumps(_phase(5, 10, "device")) + "\n")
    jr.append_cell({"cell": "a", "group": "a", "outcome": True,
                    "path": run_dir})
    return jr


CAMPAIGNS = {"skew": skew, "journal-fallback": journal_fallback,
             "no-anchor": no_anchor}


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_merge_fold_and_bubbles_byte_identical(name, tmp_path):
    CAMPAIGNS[name](name)
    out = {}
    for side, merge, bubbles in (("jax", jmerge, jbubbles),
                                 ("torch", tmerge, tbubbles)):
        info = merge.merge_campaign(name)
        merged = _read(info.pop("path"))
        fold = merge.fold_campaign_metrics(name)
        fold_bytes = _read(fold.pop("path"))
        led = bubbles.fold_campaign(name)
        led_bytes = _read(led.pop("path"))
        summary = merge.introspection_summary(fold, makespan_s=4.0)
        other = str(tmp_path / f"{side}.jsonl")
        merge.merge_campaign(name, out_path=other)
        out[side] = (info, merged, fold, fold_bytes, led, led_bytes,
                     summary, bubbles.dumps(led), _read(other),
                     bubbles.fold_run(jstore.campaign_path(name)))
    for a, b in zip(out["torch"], out["jax"]):
        assert a == b
    assert jobs.load_trace(jstore.campaign_path(
        name, jmerge.MERGED_TRACE_FILE))


def test_unknown_campaign_raises_in_both():
    for merge in (jmerge, tmerge):
        with pytest.raises(FileNotFoundError):
            merge.merge_campaign("no-such-campaign")
    # the folds of a campaign with nothing on disk are empty, not errors
    assert tmerge.fold_campaign_metrics("none", persist=False) == \
        jmerge.fold_campaign_metrics("none", persist=False)
    assert tbubbles.fold_campaign("none", persist=False) == \
        jbubbles.fold_campaign("none", persist=False)


def _clock_rec(w, off):
    return {"worker": w,
            "clock": {"coord-sent-epoch": 0.0,
                      "worker-received-epoch": off,
                      "worker-result-epoch": 10.0 + off,
                      "coord-received-epoch": 10.0}}


@pytest.mark.parametrize("clock", [
    {"coord-sent-epoch": 100.0, "worker-received-epoch": 102.05,
     "worker-result-epoch": 103.0, "coord-received-epoch": 101.05},
    {"coord-sent-epoch": 100.0, "worker-received-epoch": 106.0,
     "worker-result-epoch": 110.0, "coord-received-epoch": 110.01},
    {"coord-sent-epoch": 1.0},
    {"worker-result-epoch": "x", "coord-received-epoch": 1.0},
    None,
    "not a dict",
])
def test_clock_offset_equal(clock):
    assert tmerge.clock_offset(clock) == jmerge.clock_offset(clock)


def test_worker_offsets_equal():
    recs = [_clock_rec("w1", 1.0), _clock_rec("w1", 1.2),
            _clock_rec("w1", 40.0), _clock_rec("w2", -3.0),
            {"worker": "w3"}, _clock_rec(None, 0.5)]
    assert tmerge.worker_offsets(recs) == jmerge.worker_offsets(recs)
    assert tmerge.worker_offsets(recs)["w1"] == pytest.approx(1.2)


BUBBLE_CASES = {
    "attribution": [
        _phase(0, 100_000, "encode", pid=1),
        _phase(100_000, 200_000, "device", pid=1),
        _phase(300_000, 50_000, "d2h", pid=1),
        _phase(350_000, 50_000, "host", pid=1),
        _phase(2_000_000, 100_000, "device", pid=1),
        _phase(2_200_000, 100_000, "host", pid=1),
    ],
    "lanes": [_phase(i * 1000, 900, p, pid=1 + i % 2, tid=i % 3)
              for i, p in enumerate(("encode", "device", "d2h",
                                     "host") * 5)],
    "non-phase": [
        _phase(0, 100_000, "device"),
        {"ph": "X", "cat": "search", "name": "wgl.phase.device",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 9e9, "args": {}},
        {"ph": "M", "name": "process_name", "pid": 1, "args": {}},
        {"ph": "X", "cat": "phase", "name": "wgl.phase.device",
         "pid": 1, "tid": 1, "ts": "bad", "dur": 1.0},
    ],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(BUBBLE_CASES))
@pytest.mark.parametrize("gap_s", [1.0, 0.0001])
def test_bubble_fold_events_equal(name, gap_s, tmp_path):
    events = BUBBLE_CASES[name]
    ours = tbubbles.fold_events(events, gap_s=gap_s)
    theirs = jbubbles.fold_events(events, gap_s=gap_s)
    assert ours == theirs
    assert tbubbles.dumps(ours) == jbubbles.dumps(theirs)
    assert tbubbles.dumps(tbubbles.fold_events(list(reversed(events)),
                                               gap_s=gap_s)) == \
        tbubbles.dumps(ours)
    a = tbubbles.write_ledger(ours, str(tmp_path / "t.json"))
    b = jbubbles.write_ledger(theirs, str(tmp_path / "j.json"))
    assert _read(a) == _read(b)


def test_introspection_summary_equal():
    regs = (jobs.Registry(), tobs.Registry())
    for reg in regs:
        reg.inc("wgl.device_busy_s", 2.0, engine="jax-wgl")
        reg.inc("wgl.phase_s", 2.0, phase="device", engine="jax-wgl")
        reg.inc("wgl.phase_s", 0.5, phase="h2d", engine="jax-wgl")
        reg.inc("wgl.cells_real", 30, bucket="128", engine="jax-wgl")
        reg.inc("wgl.cells_padded", 98, bucket="128", engine="jax-wgl")
        reg.observe("wgl.chunk_s", 3.0, engine="jax-wgl")
    snaps = [r.snapshot() for r in regs]
    assert snaps[1] == snaps[0]
    ours = tmerge.introspection_summary(snaps[1], makespan_s=4.0)
    assert ours == jmerge.introspection_summary(snaps[0], makespan_s=4.0)
    assert ours["padding"]["128"]["waste_frac"] == pytest.approx(0.7656)
    assert ours["duty_cycle"] == pytest.approx(0.5)
    for makespan in (None, 0, 8.0):
        assert tmerge.introspection_summary({}, makespan) == \
            jmerge.introspection_summary({}, makespan)


def test_a_port_campaign_folds_alike(tmp_path):
    """A real campaign of the port (two register cells checked on the
    CPU, obs on, so the runs carry phase spans and search metrics):
    both packages' merge, metrics fold and bubble ledger over its files
    are byte-identical, and the run's phase spans reach the ledger."""
    from jepsen_tpu_torch import cli as tcli
    from jepsen_tpu_torch import demo
    from jepsen_tpu_torch.campaign import plan, scheduler
    opts = tcli.test_opt_fn({"no-ssh": True, "time-limit": 1,
                             "per-key-limit": 6, "device": "cpu",
                             "concurrency": "1n"})
    cells = [dict(c, build=lambda p: demo.demo_test({**opts, **p}))
             for c in plan.expand({"axes": {"workload": ["register"],
                                            "seed": [0, 1]}})]
    rep = scheduler.run_cells(cells, campaign_id="real", parallel=2)
    assert rep["summary"]["outcomes"] == {"True": 2}
    out = {}
    for side, merge, bubbles in (("jax", jmerge, jbubbles),
                                 ("torch", tmerge, tbubbles)):
        info = merge.merge_campaign("real")
        merged = _read(info.pop("path"))
        fold = merge.fold_campaign_metrics("real")
        fold_bytes = _read(fold.pop("path"))
        led = bubbles.fold_campaign("real")
        led_bytes = _read(led.pop("path"))
        out[side] = (info, merged, fold, fold_bytes, led, led_bytes)
    assert out["torch"] == out["jax"]
    info, _m, fold, _fb, led, _lb = out["torch"]
    assert info["cells"] == 2 and info["skipped"] == 0
    assert list(info["workers"]) == ["local"]
    assert fold["runs_folded"] == 3
    assert led["episodes"] > 0 and led["device_s"] > 0
    shutil.rmtree(tstore.base_dir)
