"""The port's coordinator HA (``jepsen_tpu_torch/fleet/ha.py``:
``CoordinatorLease``, ``Standby``, the fence) and the fleet's HA paths
against the JAX package's.

The unit cases run each reference case of ``tests/test_fleet_ha.py`` on
both packages (``side``); where both sides read one journal, the two
``store`` modules point at the same directory. The acceptance runs
SIGKILL a live coordinator (the ``coordinator-kill`` chaos profile, in a
process of its own) and let a standby fence it and finish at epoch 2:
once all in the port, and once over a journal the JAX package wrote,
resumed by the port beside the reference's own resume of a copy of the
same store. Masked: ``t`` stamps, ``writer`` identities, ``fence-id``s,
pids and wall clocks. Tolerance: equality."""

import datetime
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu.analysis import fleetlint as jfleetlint
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu.campaign import journal as jjournal
from jepsen_tpu.campaign import plan as jplan
from jepsen_tpu.fleet import dispatch as jdispatch
from jepsen_tpu.fleet import ha as jha
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.analysis import fleetlint as tfleetlint
from jepsen_tpu_torch.analysis import fleetmodel as tfleetmodel
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.campaign import journal as tjournal
from jepsen_tpu_torch.fleet import dispatch as tdispatch
from jepsen_tpu_torch.fleet import ha as tha

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(name="jax", store=jstore, ha=jha,
                            J=jjournal.CampaignJournal, fl=jfleetlint,
                            dispatch=jdispatch)
TORCH = types.SimpleNamespace(name="torch", store=tstore, ha=tha,
                              J=tjournal.CampaignJournal, fl=tfleetlint,
                              dispatch=tdispatch)

NOOP = {"nodes": ["n1"], "concurrency": 1, "ssh": {"dummy?": True},
        "time-limit": 1, "workload": "noop"}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    """Both stores at ONE directory: the unit cases read the same
    journal through both packages."""
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "store"))
    jcc.reset()
    tcc.reset()
    yield
    jcc.reset()
    tcc.reset()


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def side(request):
    return request.param


def _stamp(offset_s=0.0):
    return tstore.local_time(datetime.datetime.now().astimezone()
                             + datetime.timedelta(seconds=offset_s))


def mk_ha(side, cid, status="running", **extra):
    jr = side.J(cid)
    jr.write_meta({"status": status, "mode": "fleet",
                   "cells": ["a", "b"], "workers": ["w1"],
                   "lease-s": 60.0, "max-leases": 3,
                   "coordinator-lease-s": 5.0, **extra})
    return jr


def lease(side, jr, epoch, writer=None, t=None, lease_s=5.0):
    rec = {"event": side.ha.LEASE_EVENT, "epoch": epoch,
           "lease-s": lease_s, "t": t or tstore.local_time()}
    if writer is not None:
        rec["writer"] = writer
    jr.append_event(rec)


def _strip(recs):
    return [{k: v for k, v in r.items()
             if k not in ("t", "writer", "prev-writer", "fence-id",
                          "prev-lease-t", "skew-allowance-s")}
            for r in recs]


# ---------------------------------------------------------------------------
# the constants, the epoch fold, the fence


def test_constants_equal():
    for name in ("LEASE_EVENT", "TAKEOVER_EVENT",
                 "DEFAULT_COORDINATOR_LEASE_S", "DEFAULT_TAKEOVER_GRACE_S",
                 "RENEW_FRACTION"):
        assert getattr(tha, name) == getattr(jha, name), name
    assert sorted(tha.__all__) == sorted(jha.__all__)


def test_fence_appends_takeover_and_detects_a_lost_race(side):
    jr = mk_ha(side, "fence")
    lease(side, jr, 1, t=_stamp(-60))
    assert side.ha.fence(jr) == 2
    rec = [r for r in jr.records()
           if r.get("event") == side.ha.TAKEOVER_EVENT][0]
    assert rec["prev-epoch"] == 1 and rec["prev-writer"] == jr.writer
    assert rec["prev-lease-t"] and rec["lease-s"] == 5.0
    jr2 = mk_ha(side, "fence2")
    lease(side, jr2, 1, writer="coord:1", t=_stamp(-60))
    jr2.append_event({"event": side.ha.TAKEOVER_EVENT, "epoch": 2,
                      "prev-epoch": 1, "prev-writer": "coord:1",
                      "writer": "rival:9", "t": tstore.local_time()})
    assert side.ha.fence(jr2, expect_epoch=1) is None
    assert side.ha.current_epoch(jr2.records()) == 2


def test_double_standby_race_exactly_one_fence_wins(side):
    jr = mk_ha(side, "race")
    lease(side, jr, 1, writer="coord:1", t=_stamp(-120))
    a = side.ha.Standby("race", lease_s=0.1, grace_s=0.05, poll_s=0.01)
    b = side.ha.Standby("race", lease_s=0.1, grace_s=0.05, poll_s=0.01)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and not (a.poll() == "expired" and b.poll() == "expired"):
        time.sleep(0.02)
    assert a.poll() == "expired" and b.poll() == "expired"
    results = {}
    barrier = threading.Barrier(2)

    def racer(name, sb):
        barrier.wait()
        results[name] = sb.fence()

    ts = [threading.Thread(target=racer, args=("a", a)),
          threading.Thread(target=racer, args=("b", b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    wins = [e for e in results.values() if e is not None]
    assert len(wins) == 1 and wins[0] == 2
    assert side.ha.current_epoch(jr.records()) == 2
    # both auditors read the raced journal the same way
    assert [dict(vars(d)) for d in tfleetlint.lint_campaign("race")] == \
        [dict(vars(d)) for d in jfleetlint.lint_campaign("race")]


# ---------------------------------------------------------------------------
# the active side: renewals and zombie fencing


def test_coordinator_lease_renews_then_refuses_once_fenced(side):
    jr = mk_ha(side, "active")
    jr.epoch = 1
    fenced_with = []
    ctl = side.ha.CoordinatorLease(jr, lease_s=5.0, epoch=1,
                                   on_fenced=fenced_with.append)
    assert ctl.renew() is True
    grant = [r for r in jr.records()
             if r.get("event") == side.ha.LEASE_EVENT][-1]
    assert grant["epoch"] == 1 and grant["lease-s"] == 5.0
    assert grant["writer"] == jr.writer
    assert ctl.fenced() is False
    jr.append_event({"event": side.ha.TAKEOVER_EVENT, "epoch": 2,
                     "prev-epoch": 1, "prev-writer": jr.writer,
                     "writer": "standby:7", "t": tstore.local_time()})
    assert ctl.fenced() is False
    assert ctl.fenced(refresh=True) is True
    assert ctl.fenced_by == (2, "standby:7")
    assert fenced_with == [(2, "standby:7")]
    n = len(jr.records())
    assert ctl.renew() is False
    assert len(jr.records()) == n
    assert ctl.fenced(refresh=True) is True
    assert fenced_with == [(2, "standby:7")]


def test_same_epoch_claimed_first_by_a_foreign_writer_fences_us(side):
    jr = mk_ha(side, "usurp")
    jr.epoch = 1
    lease(side, jr, 1, writer="other:2")
    ctl = side.ha.CoordinatorLease(jr, lease_s=5.0, epoch=1)
    assert ctl.renew() is False
    assert ctl.fenced() is True
    assert ctl.fenced_by == (1, "other:2")
    assert all(r.get("writer") == "other:2" for r in jr.records()
               if r.get("event") == side.ha.LEASE_EVENT)


def test_lease_heartbeat_writes_the_same_journal_as_the_reference():
    """``start`` claims synchronously, the heartbeat renews, ``stop``
    joins: the records each package appends (and what each package's
    fold makes of the other's) are the same."""
    out = {}
    for s in (JAX, TORCH):
        jr = mk_ha(s, f"hb-{s.name}")
        jr.epoch = 3
        ctl = s.ha.CoordinatorLease(jr, lease_s=0.3, epoch=3,
                                    renew_s=0.05).start()
        time.sleep(0.3)
        ctl.stop()
        recs = jr.records()
        leases = [r for r in recs if r.get("event") == s.ha.LEASE_EVENT]
        assert len(leases) >= 3
        out[s.name] = (_strip(leases[:3]),
                       tha.coordinator_state(recs),
                       jha.coordinator_state(recs))
    assert out["torch"][0] == out["jax"][0]
    for name in ("jax", "torch"):
        assert out[name][1] == out[name][2]
        assert out[name][1][0] == 3


# ---------------------------------------------------------------------------
# the passive side: skew-immune detection, polls on the same journal


def test_standby_polls_equal_on_one_journal():
    """Both packages' standbys tail ONE journal and give the same poll
    sequence: alive while it grows, expired once it is quiet past the
    lease and grace, complete once finalized."""
    jr = mk_ha(TORCH, "same")
    t = tha.Standby("same", lease_s=0.2, grace_s=0.1, poll_s=0.01)
    j = jha.Standby("same", lease_s=0.2, grace_s=0.1, poll_s=0.01)
    seq = []
    for _ in range(3):
        lease(TORCH, jr, 1, t=_stamp(-3600), lease_s=0.2)
        seq.append((t.poll(), j.poll()))
        time.sleep(0.12)
    time.sleep(0.5)
    seq.append((t.poll(), j.poll()))
    assert seq == [(None, None)] * 3 + [("expired", "expired")]
    assert t.lease_s() == j.lease_s() == 0.2
    meta = jr.load_meta()
    jr.write_meta(dict(meta, status="complete"))
    assert t.poll() == j.poll() == "complete"
    for cls in (tha.Standby, jha.Standby):
        sb = cls("same")
        assert sb.lease_s(meta=meta) == 5.0
        assert sb.lease_s(lease={"lease-s": 7}) == 7.0
        assert sb.lease_s() == 15.0


def test_standby_never_fences_while_the_journal_grows(side):
    jr = mk_ha(side, "behind")
    sb = side.ha.Standby("behind", lease_s=0.2, grace_s=0.1, poll_s=0.01)
    for _ in range(4):
        lease(side, jr, 1, t=_stamp(-3600), lease_s=0.2)
        assert sb.poll() is None
        time.sleep(0.12)
    assert sb.poll() is None


def test_standby_detects_a_dead_coordinator_with_an_ahead_clock(side):
    jr = mk_ha(side, "ahead")
    lease(side, jr, 1, t=_stamp(+3600), lease_s=0.2)
    sb = side.ha.Standby("ahead", lease_s=0.2, grace_s=0.1, poll_s=0.01)
    assert sb.poll() is None
    deadline = time.monotonic() + 10
    status = None
    while time.monotonic() < deadline:
        status = sb.poll()
        if status == "expired":
            break
        time.sleep(0.05)
    assert status == "expired"
    assert sb.fence() == 2
    rec = [r for r in jr.records()
           if r.get("event") == side.ha.TAKEOVER_EVENT][0]
    assert rec["skew-allowance-s"] > 3000


def test_standby_wait_returns_complete_for_a_finalized_campaign(side):
    mk_ha(side, "done", status="complete")
    sb = side.ha.Standby("done", lease_s=0.2, grace_s=0.1, poll_s=0.01)
    assert sb.wait(timeout_s=5) == ("complete", None)


def test_standby_wait_times_out_on_a_non_ha_journal(side):
    jr = mk_ha(side, "noha")
    jr.append_event({"event": "lease", "cell": "a", "worker": "w1",
                     "attempt": 1, "lease-s": 60.0, "t": _stamp(-3600)})
    sb = side.ha.Standby("noha", lease_s=0.1, grace_s=0.05, poll_s=0.01)
    assert sb.wait(timeout_s=1.0) == ("timeout", None)


def test_a_manual_resume_of_an_ha_campaign_fences_with_a_forced_record(
        side):
    """``run_fleet(resume=True)`` over an HA journal with no won epoch:
    the operator is the takeover evidence, so the prior epoch is fenced
    with a ``forced`` record, and every cell already terminal is
    skipped."""
    jr = mk_ha(side, "manual", cells=["a"])
    jr.epoch = 1
    lease(side, jr, 1, writer="coord:1", t=_stamp(-60))
    jr.append_cell({"cell": "a", "group": "a", "params": {},
                    "outcome": True, "valid": True})
    rep = side.dispatch.run_fleet(
        [{"id": "a", "group": "a", "params": {}}],
        side.dispatch.parse_workers("local"), campaign_id="manual",
        resume=True, base_options=NOOP, lease_s=60)
    assert rep["summary"]["skipped-resumed"] == 1
    tk = [r for r in side.store.load_campaign_records("manual")
          if r.get("event") == side.ha.TAKEOVER_EVENT]
    assert [(r["epoch"], r["prev-epoch"], r["forced"], r["reason"])
            for r in tk] == [(2, 1, True, "manual-resume")]
    assert side.J("manual").load_meta()["ha-epoch"] == 2


# ---------------------------------------------------------------------------
# the acceptance runs: kill the coordinator, let a standby finish


_COORD = """
import sys
PKG = sys.argv[2]
if PKG == "jepsen_tpu_torch":
    sys.modules["jax"] = None
    sys.modules["jepsen_tpu"] = None
import importlib
store = importlib.import_module(PKG + ".store")
store.base_dir = sys.argv[1]
plan = importlib.import_module(PKG + ".campaign.plan")
chaos = importlib.import_module(PKG + ".fleet.chaos")
dispatch = importlib.import_module(PKG + ".fleet.dispatch")
cells = plan.expand({"axes": {"workload": ["noop"], "seed": [0, 1, 2]}})
dispatch.run_fleet(
    cells, dispatch.parse_workers("local,local"),
    campaign_id="ha-kill", builder=PKG + ".demo:demo_test",
    base_options=%r if PKG == "jepsen_tpu_torch" else %r,
    lease_s=300, max_leases=5, coordinator_lease_s=1.0,
    takeover_grace_s=0.5, chaos=chaos.parse("coordinator-kill:7"))
""" % (dict(NOOP, device="cpu"), NOOP)


def _kill_coordinator(pkg, base):
    """Run a coordinator of ``pkg`` in a process of its own under the
    coordinator-kill profile; it must die by its own SIGKILL."""
    proc = subprocess.run(
        [sys.executable, "-c", _COORD, base, pkg], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    assert proc.returncode == -signal.SIGKILL, \
        (proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:])


def _cells():
    return jplan.expand({"axes": {"workload": ["noop"],
                                  "seed": [0, 1, 2]}})


def _take_over(s, base, builder, options):
    """The standby's half: tail, fence, resume under the won epoch."""
    s.store.base_dir = base
    sb = s.ha.Standby("ha-kill", poll_s=0.05)
    status, epoch = sb.wait(timeout_s=120)
    assert (status, epoch) == ("takeover", 2)
    return s.dispatch.run_fleet(
        _cells(), s.dispatch.parse_workers("local,local"),
        campaign_id="ha-kill", resume=True, ha_epoch=epoch,
        builder=builder, base_options=options, lease_s=300, max_leases=5,
        coordinator_lease_s=1.0, takeover_grace_s=0.5)


def _shape(s):
    """What a takeover must leave behind, with identities masked."""
    recs = s.store.load_campaign_records("ha-kill")
    terminal = {}
    for r in recs:
        if not r.get("event"):
            terminal[r["cell"]] = terminal.get(r["cell"], 0) + 1
    tk = [r for r in recs if r.get("event") == s.ha.TAKEOVER_EVENT]
    after = recs[recs.index(tk[0]):] if tk else []
    zombies = [r for r in after if r.get("epoch") not in (None, 2)]
    outcomes = {r["cell"]: r["outcome"]
                for r in s.store.latest_campaign_records("ha-kill")}
    return {"terminal": terminal, "outcomes": outcomes,
            "takeovers": [(r["epoch"], r["prev-epoch"]) for r in tk],
            "new-writer": all(r["writer"] != r["prev-writer"] for r in tk),
            "zombies": zombies}


def _leased_after_takeover(s):
    recs = s.store.load_campaign_records("ha-kill")
    i = next(i for i, r in enumerate(recs)
             if r.get("event") == s.ha.TAKEOVER_EVENT)
    return sorted({r["cell"] for r in recs[i:]
                   if r.get("event") == "lease"})


def test_ha_takeover_e2e_coordinator_kill_standby_finishes(tmp_path):
    """The port alone: SIGKILL the live coordinator right after a seeded
    lease grant; a standby detects the dead lease, fences it, resumes
    at epoch 2, and every cell is decided exactly once, with a clean
    audit (FL004/FL007/FL016)."""
    base = str(tmp_path / "port")
    _kill_coordinator("jepsen_tpu_torch", base)
    tstore.base_dir = base
    assert os.path.exists(tha.takeover_marker("ha-kill"))
    recs = tstore.load_campaign_records("ha-kill")
    assert tha.current_epoch(recs) == 1
    meta = tjournal.CampaignJournal("ha-kill").load_meta()
    assert (meta["status"], meta["coordinator-lease-s"],
            meta["ha-epoch"]) == ("running", 1.0, 1)
    # the audit model reads the journaled chaos profile back
    prof = tfleetmodel.CampaignModel("ha-kill").chaos_profile()
    assert (prof.name, prof.seed, prof.coordinator_kill) == \
        ("coordinator-kill", 7, 1)
    rep = _take_over(TORCH, base, "jepsen_tpu_torch.demo:demo_test",
                     dict(NOOP, device="cpu"))
    assert rep["status"] == "complete"
    sh = _shape(TORCH)
    assert sh["terminal"] == {c["id"]: 1 for c in _cells()}
    assert set(sh["outcomes"].values()) == {True}
    assert sh["takeovers"] == [(2, 1)] and sh["new-writer"]
    assert sh["zombies"] == []
    fa = rep["fleet_analysis"]
    assert fa["counts"]["error"] == 0 and fa["counts"]["warning"] == 0, fa
    assert fa["checks"]["ha_takeovers_audited"] == 1, fa


def test_the_port_resumes_a_fleet_journal_the_jax_package_wrote(tmp_path):
    """The JAX package's coordinator dies mid-campaign under the same
    profile. One copy of its store is taken over by the reference's own
    standby and resume, the other by the port's: both fence epoch 1 at
    epoch 2, skip the same terminal cells, re-lease the same cells and
    leave each cell decided exactly once with the same outcome."""
    jbase = str(tmp_path / "jax")
    _kill_coordinator("jepsen_tpu", jbase)
    tbase = str(tmp_path / "torch")
    shutil.copytree(jbase, tbase)
    jstore.base_dir = jbase
    done_before = sorted(jjournal.CampaignJournal("ha-kill").completed())
    jrep = _take_over(JAX, jbase, "jepsen_tpu.demo:demo_test", NOOP)
    trep = _take_over(TORCH, tbase, "jepsen_tpu_torch.demo:demo_test",
                      dict(NOOP, device="cpu"))
    assert trep["status"] == jrep["status"] == "complete"
    assert trep["summary"] == jrep["summary"]
    assert trep["summary"]["skipped-resumed"] == len(done_before)
    assert _shape(TORCH) == _shape(JAX)
    assert _shape(TORCH)["terminal"] == {c["id"]: 1 for c in _cells()}
    assert _leased_after_takeover(TORCH) == _leased_after_takeover(JAX)
    assert set(_leased_after_takeover(TORCH)) == \
        {c["id"] for c in _cells()} - set(done_before)
    assert trep["fleet_analysis"]["counts"] == \
        jrep["fleet_analysis"]["counts"]
