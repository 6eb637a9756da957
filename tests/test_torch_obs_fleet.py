"""The port fleet's telemetry plane against the JAX package's: the
dispatcher's coordinator trace and counters, the clock handshake every
worker record carries, the merged campaign trace with one lane per
worker, the metrics fold, and planlint PL017 (its fleet half: a trace
merge with artifact sync off).

The fleet cases run the same cells through both packages' dispatchers
(the reference under ``JAX_PLATFORMS=cpu``, the port with ``device:
"cpu"``), each in a store of its own, with one seeded worker kill so
the steal shows in the trace. Compared at equality: the lane names, the
coordinator's event names, the counter families, the number of merged
run spans, the merge summary's counts. Timestamps, pids and clock
offsets differ run to run and are checked against bounds instead."""

import json
import os

import pytest

from jepsen_tpu import obs as jobs
from jepsen_tpu import store as jstore
from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu.campaign import plan as jplan
from jepsen_tpu.fleet import dispatch as jdispatch
from jepsen_tpu.obs import merge as jmerge
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.analysis import planlint as tplanlint
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.fleet import dispatch as tdispatch
from jepsen_tpu_torch.obs import merge as tmerge

NOOP = {"nodes": ["n1"], "concurrency": 1, "ssh": {"dummy?": True},
        "time-limit": 1, "workload": "noop"}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "torch"))
    jcc.reset()
    tcc.reset()
    yield
    jcc.reset()
    tcc.reset()


@pytest.mark.parametrize("cfg", [
    {"telemetry-flush-ms": 0}, {"telemetry-flush-ms": -1},
    {"telemetry-flush-ms": 250}, {"telemetry-flush-ms": True},
    {"metrics?": True, "serve-ip": "0.0.0.0"},
    {"metrics?": True, "serve-ip": "127.0.0.1"},
    {"metrics?": True, "serve-ip": "0.0.0.0", "auth-token?": True},
    {"metrics?": True}, {"trace-merge?": True, "sync?": False},
    {"trace-merge?": True, "sync?": None},
    {"trace-merge?": True, "sync?": True},
    {"trace-merge?": False, "sync?": False}, {}, None])
def test_pl017_equal(cfg):
    def d(diags):
        return [dict(vars(x)) for x in diags]
    assert d(tplanlint.lint_telemetry(cfg)) == \
        d(jplanlint.lint_telemetry(cfg))


def test_pl017_merge_without_sync_warns():
    diags = tplanlint.lint_telemetry({"trace-merge?": True,
                                      "sync?": False})
    assert [(x.code, x.severity) for x in diags] == [("PL017", "warning")]


def test_run_fleet_runs_pl017_with_sync_off():
    """``run_fleet(sync=False)`` with the merge on logs the PL017
    warning and still runs, as the reference does."""
    import logging
    records = []

    class H(logging.Handler):
        def emit(self, rec):
            records.append(rec.getMessage())

    h = H()
    logger = logging.getLogger("jepsen_tpu_torch.fleet.dispatch")
    logger.addHandler(h)
    try:
        rep = tdispatch.run_fleet(
            jplan.expand({"axes": {"seed": [0], "workload": ["noop"]}}),
            tdispatch.parse_workers("local"), campaign_id="nosync",
            base_options=dict(NOOP, device="cpu"), lease_s=120,
            sync=False)
    finally:
        logger.removeHandler(h)
    assert rep["summary"]["outcomes"] == {"True": 1}
    assert any("PL017" in m for m in records)


def _run(side, tmp_path):
    cells = jplan.expand({"axes": {"seed": [0, 1], "workload": ["noop"]}})
    cells[0]["params"]["die-once-marker"] = str(tmp_path / f"{side}-die")
    if side == "jax":
        return jdispatch.run_fleet(
            cells, jdispatch.parse_workers("local,local"),
            campaign_id="obsfleet", base_options=NOOP, lease_s=120,
            builder="jepsen_tpu.demo:demo_test")
    return tdispatch.run_fleet(
        cells, tdispatch.parse_workers("local,local"),
        campaign_id="obsfleet", base_options=dict(NOOP, device="cpu"),
        lease_s=120)


def _trace_shape(st, ob, rep):
    p = st.campaign_path("obsfleet", "campaign_trace.jsonl")
    evs = ob.load_trace(p)
    lanes = sorted((e.get("args") or {}).get("name")
                   for e in evs if e.get("name") == "process_name")
    coord = sorted({e["name"] for e in evs if e.get("pid") == 1
                    and e.get("cat") == "fleet"})
    runs = [e for e in evs if e.get("name") == "jepsen.run"
            and e.get("ph") == "X"]
    with open(st.campaign_path("obsfleet", "metrics.json")) as f:
        counters = json.load(f)["counters"]
    families = sorted({k.split("{")[0] for k in counters})
    return {"lanes": lanes, "coordinator-events": coord,
            "runs": len(runs), "runs-off-coordinator":
            all(e["pid"] != 1 for e in runs),
            "families": families,
            "summary": {k: rep["trace"][k]
                        for k in ("events", "cells", "skipped")},
            "workers": sorted(rep["trace"]["workers"])}


def test_fleet_campaign_merges_a_lane_per_worker(tmp_path):
    reps = {side: _run(side, tmp_path) for side in ("jax", "torch")}
    shapes = {"jax": _trace_shape(jstore, jobs, reps["jax"]),
              "torch": _trace_shape(tstore, tobs, reps["torch"])}
    assert shapes["torch"] == shapes["jax"]
    sh = shapes["torch"]
    assert sh["lanes"][0] == "coordinator"
    assert set(sh["workers"]) <= {"local", "local#2"}
    assert {"fleet.lease.grant", "fleet.lease.steal"} <= \
        set(sh["coordinator-events"])
    assert sh["runs"] == 2 and sh["runs-off-coordinator"]
    assert "fleet.cells_stolen" in sh["families"]
    # loopback workers share the coordinator's clock: the return-leg
    # estimate stays within its own latency
    for w in reps["torch"]["trace"]["workers"].values():
        assert abs(w["offset_s"]) < 1.0
    # every worker record closes the four-stamp handshake
    for r in tstore.latest_campaign_records("obsfleet"):
        assert set(r["clock"]) == {"coord-sent-epoch",
                                   "worker-received-epoch",
                                   "worker-result-epoch",
                                   "coord-received-epoch"}
        assert tmerge.clock_offset(r["clock"]) == \
            jmerge.clock_offset(r["clock"])
    # a deterministic re-merge, byte for byte
    p = tstore.campaign_path("obsfleet", "campaign_trace.jsonl")
    with open(p, "rb") as f:
        body = f.read()
    tmerge.merge_campaign("obsfleet")
    with open(p, "rb") as f:
        assert f.read() == body
    # the metrics fold and the report's introspection block line up
    assert sorted(reps["torch"]["introspection"]) == \
        sorted(reps["jax"]["introspection"])
    assert os.path.exists(reps["torch"]["introspection"]["metrics_fold"])


def test_no_trace_merge_leaves_no_campaign_trace():
    rep = tdispatch.run_fleet(
        jplan.expand({"axes": {"seed": [0], "workload": ["noop"]}}),
        tdispatch.parse_workers("local"), campaign_id="nomerge",
        base_options=dict(NOOP, device="cpu"), lease_s=120,
        trace_merge=False)
    assert "trace" not in rep
    assert not os.path.exists(tstore.campaign_path(
        "nomerge", "campaign_trace.jsonl"))
    assert os.path.exists(tstore.campaign_path("nomerge", "trace.jsonl"))
