"""The port's control-plane audit (``jepsen_tpu_torch/analysis/
fleetmodel.py``, ``fleetlint.py``) and planlint's campaign-command knob
passes (PL018, PL020, PL024) against the JAX package's.

Every journal below is written once, into one store directory that both
``store`` modules point at; both auditors then read the same files.
``lint_campaign`` and ``preflight`` must give the same diagnostics and
``audit`` the same report and the same ``fleet_analysis.json`` bytes
(the report's absolute ``path`` masked: it is the same file). The
journals are the golden fixtures of ``tests/test_fleetlint.py`` and
``tests/test_fleet_ha.py`` (FL001-FL016), a local campaign each
package's scheduler ran, and the containment cases of the local
scheduler. Journals with a chaos profile are read through each
package's own ``fleet.chaos``, which draw the same schedules.
Tolerance: equality."""

import dataclasses
import datetime
import json
import os
import time

import pytest

from jepsen_tpu import checker as jcc
from jepsen_tpu import client as jclient
from jepsen_tpu import generator as jgen
from jepsen_tpu import store as jstore
from jepsen_tpu import tests as jtst
from jepsen_tpu.analysis import fleetlint as jfleetlint
from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.analysis.fleetmodel import CampaignModel as JModel
from jepsen_tpu.campaign import scheduler as jscheduler
from jepsen_tpu.campaign.journal import CampaignJournal
from jepsen_tpu.fleet import chaos as fchaos
from jepsen_tpu_torch import checker as tcc
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import tests as ttst
from jepsen_tpu_torch.analysis import fleetlint as tfleetlint
from jepsen_tpu_torch.analysis import planlint as tplanlint
from jepsen_tpu_torch.analysis.diagnostics import ERROR, diag
from jepsen_tpu_torch.analysis.fleetmodel import CampaignModel as TModel
from jepsen_tpu_torch.campaign import scheduler as tscheduler


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "store"))


def _d(diags):
    return [d.to_dict() for d in diags]


def _stamp(offset_s=0.0):
    return jstore.local_time(datetime.datetime.now().astimezone()
                             + datetime.timedelta(seconds=offset_s))


# ---------------------------------------------------------------------------
# golden journals (tests/test_fleetlint.py, tests/test_fleet_ha.py)

def mk_fleet(cid, cells=("a", "b"), status="complete", **extra):
    jr = CampaignJournal(cid)
    jr.write_meta({"status": status, "mode": "fleet",
                   "cells": list(cells), "workers": ["w1"],
                   "lease-s": 60.0, "max-leases": 3, **extra})
    return jr


def grant(jr, cell, worker="w1", attempt=1, t=None, **kw):
    jr.append_event({"event": "lease", "cell": cell, "worker": worker,
                     "attempt": attempt, "lease-s": 60.0,
                     "t": t or jstore.local_time(), **kw})


def forfeit(jr, cell, worker="w1", **kw):
    jr.append_event({"event": "lease-failed", "cell": cell,
                     "worker": worker, "error": "injected",
                     "t": jstore.local_time(), **kw})


def terminal(jr, cell, worker="w1", attempt=1, **kw):
    jr.append_cell({"cell": cell, "group": cell, "params": {},
                    "outcome": True, "valid": True, "worker": worker,
                    "attempt": attempt, **kw})


def leased_terminal(jr, cell, **kw):
    grant(jr, cell)
    terminal(jr, cell, **kw)


def _run_dir(name):
    d = os.path.join(jstore.base_dir, name)
    os.makedirs(d, exist_ok=True)
    return d


def _write_trace(run_dir, epoch_s, context, events=(), finalized=True):
    meta = {"name": "trace_meta", "ph": "i", "cat": "__metadata",
            "ts": 0.0, "pid": 1, "tid": 0, "s": "g",
            "args": {"epoch_ns": int(epoch_s * 1e9), "context": context}}
    name = "trace.jsonl" if finalized else jstore.TRACE_JOURNAL_FILE
    with open(os.path.join(run_dir, name), "w") as f:
        for ev in (meta,) + tuple(events):
            f.write(json.dumps(ev) + "\n")


def _span(name, ts_us, dur_us):
    return {"name": name, "ph": "X", "cat": "lifecycle", "ts": ts_us,
            "dur": dur_us, "pid": 1, "tid": 1}


def _fleet_with_run(cid, epoch_s, context=None, events=(), clock=None,
                    finalized=True):
    d = _run_dir(f"noop/{cid}")
    _write_trace(d, epoch_s,
                 context if context is not None
                 else {"campaign": cid, "cell": "a", "worker": "w1"},
                 events, finalized=finalized)
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a")
    terminal(jr, "a", path=d,
             clock=clock or {"worker-result-epoch": epoch_s + 100,
                             "coord-received-epoch": epoch_s + 100})
    return jr


def clean(cid):
    jr = mk_fleet(cid)
    leased_terminal(jr, "a")
    leased_terminal(jr, "b")


def dup(cid):
    clean(cid)
    terminal(CampaignJournal(cid), "a")


def rerun(cid):
    jr = mk_fleet(cid, cells=["x"])
    jr.append_cell({"cell": "x", "outcome": "aborted"})
    grant(jr, "x")
    terminal(jr, "x")


def unplanned(cid):
    jr = mk_fleet(cid, cells=["a", "b"])
    leased_terminal(jr, "a")
    leased_terminal(jr, "ghost")


def aborted_unfinished(cid):
    leased_terminal(mk_fleet(cid, cells=["a", "b"], status="aborted"), "a")


def writers(cid):
    jr = mk_fleet(cid, cells=["a", "b"], resumes=1)
    grant(jr, "a")
    jr.append_cell({"cell": "a", "outcome": True, "worker": "w1",
                    "attempt": 1, "writer": "hostA:1"})
    jr.append_event({"event": "lease", "cell": "b", "worker": "w1",
                     "attempt": 1, "t": jstore.local_time(),
                     "writer": "hostB:2"})
    jr.append_cell({"cell": "b", "outcome": True, "worker": "w1",
                    "attempt": 1, "writer": "hostA:1"})


def handoff(cid):
    jr = mk_fleet(cid, cells=["a", "b"], resumes=1)
    jr.append_cell({"cell": "a", "outcome": True, "writer": "hostA:1"})
    jr.append_cell({"cell": "b", "outcome": True, "writer": "hostB:2"})


def unexplained(cid):
    jr = mk_fleet(cid, cells=["a", "b"])
    jr.append_cell({"cell": "a", "outcome": True, "writer": "hostA:1"})
    jr.append_cell({"cell": "b", "outcome": True, "writer": "hostB:2"})


def nolease(cid):
    terminal(mk_fleet(cid, cells=["a"]), "a")


def wrongworker(cid):
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a", worker="w1")
    terminal(jr, "a", worker="w9")


def budget(cid):
    jr = mk_fleet(cid, cells=["a"])
    for attempt in range(1, 5):
        grant(jr, "a", attempt=attempt)
        if attempt < 4:
            forfeit(jr, "a")
    terminal(jr, "a", attempt=4)


def overlap(cid):
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a", worker="w1", attempt=1)
    grant(jr, "a", worker="w2", attempt=2)
    terminal(jr, "a", worker="w2", attempt=2)


def steal(cid):
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a", worker="w1", attempt=1)
    forfeit(jr, "a")
    grant(jr, "a", worker="w2", attempt=2)
    terminal(jr, "a", worker="w2", attempt=2)


def crashresume(cid):
    jr = mk_fleet(cid, cells=["a"], resumes=1)
    grant(jr, "a", writer="hostA:1")
    for attempt in (1, 2, 3):
        grant(jr, "a", attempt=attempt, writer="hostB:2")
        if attempt < 3:
            forfeit(jr, "a", writer="hostB:2")
    jr.append_cell({"cell": "a", "outcome": True, "worker": "w1",
                    "attempt": 3, "writer": "hostB:2"})


def extend(cid):
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a")
    jr.append_event({"event": "lease-extend", "cell": "a",
                     "worker": "w1", "ttl-s": 35.0,
                     "reason": "artifact-sync", "t": jstore.local_time()})
    terminal(jr, "a")


def extend_synced(cid):
    extend(cid)
    CampaignJournal(cid).append_event(
        {"event": "artifact-sync", "cell": "a", "worker": "w1",
         "status": "ok", "files": 1, "t": jstore.local_time()})


def sync_mismatch(cid):
    d = _run_dir("noop/t1")
    with open(os.path.join(d, "results.json"), "w") as f:
        f.write('{"valid": true}')
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a")
    jr.append_event({"event": "artifact-sync", "cell": "a",
                     "worker": "w1", "status": "ok", "files": 1,
                     "manifest": {"results.json": 999, "gone": 1,
                                  "x/1": 2, "x/2": 3},
                     "t": jstore.local_time()})
    terminal(jr, "a", synced=True, path=d)


def sync_ok(cid):
    d = _run_dir("noop/t1")
    with open(os.path.join(d, "results.json"), "w") as f:
        f.write('{"valid": true}')
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a")
    jr.append_event({"event": "artifact-sync", "cell": "a",
                     "worker": "w1", "status": "ok", "files": 1,
                     "manifest": {"results.json": 15},
                     "t": jstore.local_time()})
    terminal(jr, "a", synced=True, path=d)


def sync_noevent(cid):
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a")
    terminal(jr, "a", synced=True, path=_run_dir("noop/t2"))


def sync_nodir(cid):
    jr = mk_fleet(cid, cells=["a"])
    grant(jr, "a")
    jr.append_event({"event": "artifact-sync", "cell": "a",
                     "worker": "w1", "status": "ok", "files": 1,
                     "t": jstore.local_time()})
    terminal(jr, "a", synced=True,
             path=os.path.join(jstore.base_dir, "noop", "missing"))


def tmp_residue(cid):
    clean(cid)
    staged = jstore.sync_tmp_path("123-456")
    os.makedirs(staged)
    with open(os.path.join(staged, "partial"), "w") as f:
        f.write("torn")


def early(cid):
    now = time.time()
    _fleet_with_run(cid, epoch_s=now - 3600,
                    events=(_span("jepsen.run", 0.0, 1e6),),
                    clock={"worker-result-epoch": now,
                           "coord-received-epoch": now})


def intime(cid):
    now = time.time()
    _fleet_with_run(cid, epoch_s=now + 1.0,
                    events=(_span("jepsen.run", 0.0, 2e6),),
                    clock={"worker-result-epoch": now + 4.0,
                           "coord-received-epoch": now + 4.0})


def lateclose(cid):
    now = time.time()
    _fleet_with_run(cid, epoch_s=now,
                    events=(_span("jepsen.run", 0.0, 60e6),),
                    clock={"worker-result-epoch": now + 2.0,
                           "coord-received-epoch": now + 2.0})


OPEN_EV = {"name": "nemesis.window", "ph": "b", "cat": "nemesis",
           "ts": 1.0, "pid": 1, "tid": 1, "id": "w0"}


def unbalanced(cid):
    _fleet_with_run(cid, epoch_s=time.time(),
                    events=(_span("jepsen.run", 0.0, 1e6), OPEN_EV))


def unbalanced_journal(cid):
    _fleet_with_run(cid, epoch_s=time.time(),
                    events=(_span("jepsen.run", 0.0, 1e6), OPEN_EV),
                    finalized=False)


def context(cid):
    _fleet_with_run(cid, epoch_s=time.time(),
                    context={"campaign": cid, "cell": "OTHER",
                             "worker": "w1"},
                    events=(_span("jepsen.run", 0.0, 1e6),))


def _ha_fleet(cid, status="complete"):
    jr = CampaignJournal(cid)
    jr.write_meta({"status": status, "mode": "fleet", "cells": ["a"],
                   "workers": ["w1"], "lease-s": 60.0, "max-leases": 3,
                   "coordinator-lease-s": 5.0, "ha-epoch": 1})
    return jr


def _lease(jr, epoch, writer=None, t=None, lease_s=5.0):
    rec = {"event": "coordinator-lease", "epoch": epoch,
           "lease-s": lease_s, "t": t or jstore.local_time()}
    if writer is not None:
        rec["writer"] = writer
    jr.append_event(rec)


def _ha_cell(jr, cell="a", epoch=1, writer=None, **kw):
    rec = {"cell": cell, "group": cell, "params": {}, "outcome": True,
           "valid": True, "worker": "w1", "attempt": 1, "epoch": epoch,
           **kw}
    if writer is not None:
        rec["writer"] = writer
    jr.append_event({"event": "lease", "cell": cell, "worker": "w1",
                     "attempt": 1, "lease-s": 60.0, "epoch": epoch,
                     "t": jstore.local_time(),
                     **({"writer": writer} if writer else {})})
    jr.append_cell(rec)


def _takeover(jr, **kw):
    jr.append_event({"event": "coordinator-takeover", "epoch": 2,
                     "prev-epoch": 1, "prev-writer": "coord:1",
                     "reason": "lease-expired", "t": jstore.local_time(),
                     "prev-lease-t": _stamp(-60), "lease-s": 5.0, **kw})


def ha_golden(cid):
    jr = _ha_fleet(cid)
    _lease(jr, 1, writer="coord:1", t=_stamp(-60))
    _takeover(jr)
    _lease(jr, 2)
    _ha_cell(jr, "a", epoch=2)


def ha_zombie(cid):
    jr = _ha_fleet(cid)
    _lease(jr, 1, writer="coord:1", t=_stamp(-60))
    _takeover(jr)
    _lease(jr, 2)
    _ha_cell(jr, "a", epoch=1, writer="coord:1")


def ha_renewal_split_brain(cid):
    jr = _ha_fleet(cid)
    _lease(jr, 1, writer="coord:1", t=_stamp(-60))
    _takeover(jr)
    _lease(jr, 2)
    _lease(jr, 1, writer="coord:1")
    _lease(jr, 2, writer="intruder:3")
    _lease(jr, "x")
    _takeover(jr, writer="late:4", epoch=3)


def ha_premature(cid):
    jr = _ha_fleet(cid)
    _lease(jr, 1, writer="coord:1", t=_stamp(-1))
    _takeover(jr, writer="coord:1", **{"prev-lease-t": _stamp(-1)})
    _lease(jr, 2, writer="coord:1")
    _ha_cell(jr, "a", epoch=2, writer="coord:1")


def ha_forced(cid):
    jr = _ha_fleet(cid)
    _lease(jr, 1, writer="coord:1", t=_stamp(-1))
    jr.append_event({"event": "coordinator-takeover", "epoch": 2,
                     "prev-epoch": 1, "prev-writer": "coord:1",
                     "reason": "manual-resume", "forced": True,
                     "t": jstore.local_time()})
    _lease(jr, 2)
    _ha_cell(jr, "a", epoch=2)


def ha_no_lease(cid):
    jr = _ha_fleet(cid)
    _takeover(jr, **{"prev-epoch": 0, "prev-writer": None})
    _ha_cell(jr, "a", epoch=2)


def _local(side_scheduler, client_mod, gen, checker, tst, cid):
    class OkClient(client_mod.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            return dict(op, type="ok")

    cells = []
    for i in range(3):
        t = tst.noop_test()
        t.update(name=f"{cid}-{i}", nodes=["n1"], concurrency=1,
                 client=OkClient(), checker=checker.noop(),
                 generator=gen.clients(gen.limit(
                     3, gen.repeat({"f": "read"}))), ssh={"dummy?": True})
        cells.append({"id": f"c{i}", "test": t})
    side_scheduler.run_cells(cells, campaign_id=cid, parallel=2)


def local_by_jax(cid):
    _local(jscheduler, jclient, jgen, jcc, jtst, cid)


def local_by_torch(cid):
    _local(tscheduler, tclient, tgen, tcc, ttst, cid)


def local_resumed(cid):
    local_by_torch(cid)
    jr = CampaignJournal(cid)
    meta = jr.load_meta()
    jr.write_meta(dict(meta, resumes=1))
    jr.append_cell({"cell": "c0", "outcome": True, "writer": "other:9"})


JOURNALS = {f.__name__: f for f in (
    clean, dup, rerun, unplanned, aborted_unfinished, writers, handoff,
    unexplained, nolease, wrongworker, budget, overlap, steal,
    crashresume, extend, extend_synced, sync_mismatch, sync_ok,
    sync_noevent, sync_nodir, tmp_residue, early, intime, lateclose,
    unbalanced, unbalanced_journal, context, ha_golden, ha_zombie,
    ha_renewal_split_brain, ha_premature, ha_forced, ha_no_lease,
    local_by_jax, local_by_torch, local_resumed)}

#: the FL codes each golden journal must raise (the reference tests'
#: assertions), so the comparison is never of two empty lists by accident
EXPECT = {"dup": {"FL001"}, "unplanned": {"FL002", "FL003"},
          "writers": {"FL004"}, "unexplained": {"FL004"},
          "nolease": {"FL005"}, "wrongworker": {"FL005"},
          "budget": {"FL006"}, "overlap": {"FL007"}, "extend": {"FL015"},
          "sync_mismatch": {"FL008"}, "sync_noevent": {"FL008"},
          "sync_nodir": {"FL008"}, "tmp_residue": {"FL009"},
          "early": {"FL010"}, "lateclose": {"FL010"},
          "unbalanced": {"FL011"}, "context": {"FL012"},
          "ha_zombie": {"FL016"}, "ha_renewal_split_brain": {"FL016"},
          "ha_premature": {"FL016"}, "ha_no_lease": {"FL016"},
          "local_resumed": {"FL001"}}


@pytest.mark.parametrize("name", sorted(JOURNALS))
def test_audit_equal_to_the_reference(name):
    JOURNALS[name](name)
    ours, theirs = tfleetlint.lint_campaign(name), \
        jfleetlint.lint_campaign(name)
    assert _d(ours) == _d(theirs)
    assert {d.code for d in ours} >= EXPECT.get(name, set())
    assert _d(tfleetlint.preflight(name)) == \
        _d(jfleetlint.preflight(name))
    p = tstore.campaign_path(name, tfleetlint.ANALYSIS_FILE)
    jrep, jdiags = jfleetlint.audit(name)
    with open(p, "rb") as f:
        jbytes = f.read()
    trep, tdiags = tfleetlint.audit(name)
    with open(p, "rb") as f:
        assert f.read() == jbytes
    assert trep == jrep and _d(tdiags) == _d(jdiags)
    assert tfleetlint.load_report(name) == jfleetlint.load_report(name)
    # the model's folds, from one parsed read
    recs = tstore.load_campaign_records(name)
    tm, jm = TModel(name, records=recs), JModel(name, records=recs)
    for attr in ("records", "events", "outcomes", "latest", "status",
                 "mode", "planned", "lease_s", "max_leases", "resumes",
                 "coordinator_lease_s"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    for fn in ("terminal_records", "terminal_by_cell", "grants",
               "writer_runs", "ha_leases", "takeovers",
               "coordinator_state", "worker_offsets",
               "chaos_fault_counts"):
        assert getattr(tm, fn)() == getattr(jm, fn)(), fn
    assert tm.writer_runs(skip_ha=True) == jm.writer_runs(skip_ha=True)
    for cell in tm.planned + ["ghost"]:
        assert tm.lease_timeline(cell) == jm.lease_timeline(cell)
        assert tm.grant_for(cell, "w1", 1) == jm.grant_for(cell, "w1", 1)


@pytest.mark.parametrize("profile", ["flaky-exec:7", "soak:42",
                                     "coordinator-kill:7"])
def test_a_chaos_journal_audits_as_the_reference(profile):
    """A chaos soak's journal (FL013's accounting, FL016's vanished
    kill) audits to the same diagnostics and report in both packages,
    each rebuilding the journaled profile with its own fleet.chaos."""
    prof = fchaos.parse(profile)
    jr = mk_fleet("chaos", cells=["a", "b"],
                  chaos=dataclasses.asdict(prof)
                  if profile.startswith("soak") else prof.describe())
    leased_terminal(jr, "a")
    leased_terminal(jr, "b")
    assert _d(tfleetlint.lint_campaign("chaos")) == \
        _d(jfleetlint.lint_campaign("chaos"))
    from jepsen_tpu.analysis.fleetmodel import CampaignModel as JM
    from jepsen_tpu_torch.analysis.fleetmodel import CampaignModel as TM
    tp, jp = TM("chaos").chaos_profile(), JM("chaos").chaos_profile()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.plan_kills(["a", "b"]) == jp.plan_kills(["a", "b"])
    assert _d(tfleetlint.preflight("chaos")) == \
        _d(jfleetlint.preflight("chaos"))


def test_unknown_campaign_raises_in_both():
    for fl in (jfleetlint, tfleetlint):
        with pytest.raises(FileNotFoundError):
            fl.audit("never-existed")
        with pytest.raises(FileNotFoundError):
            fl.lint_campaign("never-existed")
        assert fl.load_report("never-existed") is None


# ---------------------------------------------------------------------------
# the scheduler's gate and its containment

def _quick(name):
    class OkClient(tclient.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            return dict(op, type="ok")

    t = ttst.noop_test()
    t.update(name=name, nodes=["n1"], concurrency=1, client=OkClient(),
             checker=tcc.noop(), ssh={"dummy?": True},
             generator=tgen.clients(tgen.limit(
                 3, tgen.repeat({"f": "read"}))))
    t["obs?"] = False
    return t


def test_pl018_resume_refused_over_a_corrupt_journal():
    jr = CampaignJournal("corrupt")
    jr.write_meta({"status": "aborted", "cells": ["a"]})
    jr.append_cell({"cell": "a", "outcome": True})
    jr.append_cell({"cell": "a", "outcome": False})
    msgs = []
    for sched in (jscheduler, tscheduler):
        with pytest.raises(sched.CampaignError) as ei:
            sched.run_cells([{"id": "a", "test": {}}],
                            campaign_id="corrupt", resume=True,
                            run_fn=lambda t: t)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "PL018" in msgs[1] and "cells[a]" in msgs[1]


def test_fleetlint_off_skips_the_gate_and_the_audit():
    jr = CampaignJournal("hatch")
    jr.write_meta({"status": "aborted", "cells": ["a"]})
    jr.append_cell({"cell": "a", "outcome": True})
    jr.append_cell({"cell": "a", "outcome": False})
    report = tscheduler.run_cells(
        [{"id": "a", "test": _quick("hatch-a")}], campaign_id="hatch",
        resume=True, fleetlint=False,
        run_fn=lambda t: {**t, "results": {"valid": True}})
    assert report["status"] == "complete"
    assert "fleet_analysis" not in report
    assert tfleetlint.load_report("hatch") is None


def test_an_audit_crash_never_breaks_the_campaign(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("auditor bug")

    monkeypatch.setattr(tfleetlint, "audit", boom)
    report = tscheduler.run_cells([{"id": "a", "test": _quick("cont-a")}],
                                  campaign_id="contained")
    assert report["status"] == "complete"
    assert report["summary"]["outcomes"] == {"True": 1}
    assert "fleet_analysis" not in report
    assert "certification" in report


def test_audit_errors_never_flip_outcomes_or_exit(monkeypatch):
    real = tfleetlint._lint_model

    def with_injected_error(model):
        diags, checks = real(model)
        return diags + [diag("FL001", ERROR, "injected", "x")], checks

    monkeypatch.setattr(tfleetlint, "_lint_model", with_injected_error)
    report = tscheduler.run_cells([{"id": "a", "test": _quick("flip-a")}],
                                  campaign_id="noflips")
    assert report["summary"]["outcomes"] == {"True": 1}
    assert report["status"] == "complete"
    assert report["fleet_analysis"]["counts"]["error"] >= 1
    assert tcli.campaign_exit_code(report) == 0
    assert [r["outcome"] for r in
            tstore.latest_campaign_records("noflips")] == [True]


# ---------------------------------------------------------------------------
# planlint's campaign-command knob passes

PL018 = [{}, {"fleetlint": "on"}, {"fleetlint": "off"},
         {"fleetlint": "strict"}, {"fleetlint": None}, None]
PL020 = [{}, {"coalesce-window-ms": 0}, {"coalesce-window-ms": True},
         {"coalesce-window-ms": 25}, {"coalesce-max-segments": 0},
         {"coalesce-max-segments": 2.5}, {"coalesce-max-segments": 32},
         {"coalesce?": True, "device-slots": 0},
         {"coalesce?": True, "device-slots": 1, "engine": "wgl"},
         {"coalesce?": True, "engine": "jax-wgl"},
         {"coalesce?": False, "device-slots": 0, "engine": "wgl"}, None]
PL024 = [{}, {"coordinator-lease-s": 15.0, "ha?": True},
         {"coordinator-lease-s": 0}, {"coordinator-lease-s": "x"},
         {"takeover-grace-s": -1}, {"renew-interval-s": 0},
         {"renew-interval-s": 6, "coordinator-lease-s": 5},
         {"standby?": True, "store-reachable?": False},
         {"standby?": True, "store-reachable?": True},
         {"chaos-coordinator-kill?": True},
         {"chaos-coordinator-kill?": True, "ha?": True},
         {"coordinator-lease-s": 60, "lease-s": 30},
         {"coordinator-lease-s": 5, "lease-s": 30}, None]


@pytest.mark.parametrize("fn,cfg", [("lint_fleetlint", c) for c in PL018]
                         + [("lint_coalesce", c) for c in PL020]
                         + [("lint_ha", c) for c in PL024])
def test_campaign_knob_lints_equal(fn, cfg):
    assert _d(getattr(tplanlint, fn)(cfg)) == \
        _d(getattr(jplanlint, fn)(cfg))
    assert tplanlint.FLEETLINT_MODES == jplanlint.FLEETLINT_MODES


def test_pl018_carries_the_journal_preflight_as_refusals():
    recs = [{"cell": "a", "outcome": True, "writer": "w:1"},
            {"cell": "a", "outcome": False, "writer": "w:1"},
            {"cell": "b", "outcome": True, "writer": "w:2"},
            {"cell": "c", "outcome": True, "writer": "w:1"}]
    pre_t = tfleetlint.preflight("x", records=recs)
    pre_j = jfleetlint.preflight("x", records=recs)
    assert _d(pre_t) == _d(pre_j)
    assert {d.code for d in pre_t} == {"FL001", "FL004"}
    for resume in (True, False):
        cfg = {"resume?": resume, "fleetlint": "on"}
        assert _d(tplanlint.lint_fleetlint(dict(cfg,
                                                **{"journal-diags":
                                                   pre_t}))) == \
            _d(jplanlint.lint_fleetlint(dict(cfg,
                                             **{"journal-diags": pre_j})))
