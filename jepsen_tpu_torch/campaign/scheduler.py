"""The campaign scheduler: a bounded, resumable sweep of test cells on
one host (the port's copy of ``jepsen_tpu/campaign/scheduler.py``).

Execution model:

* **Worker pool.** Cells run on ``parallel`` threads. The CPU-side
  harness phases (db setup, generator, interpreter) of different cells
  overlap freely -- that is where wall clock goes in a sweep of short
  tests.
* **Device slots.** Each cell's checker is wrapped so the check phase
  -- the device WGL search -- holds one of ``device_slots`` semaphore
  slots, and a monitored cell's monitor takes the same slots for its
  device checks (``test["monitor-device-sem"]``); in the port the txn
  monitor's closure checks take them too (``monitor/txn.py``). One card
  gets one slot, so searches serialize instead of fighting over its
  memory; CPU-only sweeps can raise it.
* **Abort latch.** The whole campaign shares one
  ``robust.AbortLatch``, wired to SIGINT/SIGTERM on the main thread
  and injected as every cell's ``test["abort"]``: the first signal
  stops new cells AND gracefully drains the running ones (their
  partial histories are salvaged and checked by the normal robust
  machinery); a second signal hard-aborts. Either way the journal is
  left resumable.
* **Journal.** Every finished cell is appended to ``cells.jsonl``
  (flush+fsync) the moment it completes; ``resume=True`` skips cells
  whose latest record is terminal and re-runs aborted/missing ones.
* **Telemetry.** The scheduler keeps its OWN Tracer/Registry (per-cell
  spans, outcome counters, wall/wait histograms) dumped into the
  campaign directory -- deliberately not the process-global `obs`
  binding, which cells rebind per run (overlapping core.runs
  cross-attribute the global pair; instance handles don't). Plan-shape
  repeats are bracketed via compile_cache.stats() deltas, and the
  disk ledger (``fleet.ledger``) keeps them across processes.

Cells are ``{"id": str, "test": <test map>}`` or ``{"id": str,
"build": callable(params) -> test map, "params": {...}}``; lazy builds
keep a malformed cell's crash contained to that cell (journaled
``"crashed"``, as in the reference).

The capacity plan (``capacity_plan=``) is persisted next to the
journal and its prediction oracle runs at finalize, contained, as in
the reference; its bracket counts notes, so a shape an earlier
campaign of the process noted still counts (ROADMAP.md C.11). Resuming a coordinator-HA journal raises the reference's
``CampaignError``, pointing at the fleet path. The finalize audits
(fleetlint, certification) stay contained as in the reference, except
that a ``NotImplementedError`` is never contained.
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

from .. import core, robust, store
from ..checker import core as checker_core
from ..obs import Registry, Tracer
from . import compile_cache
from . import report as creport
from .journal import CampaignJournal

logger = logging.getLogger(__name__)

__all__ = ["CampaignError", "run_cells", "new_campaign_id"]


class CampaignError(RuntimeError):
    """Campaign-level wiring failure (bad resume target, no cells)."""


def new_campaign_id():
    return "campaign-" + store.local_time()


_stamp_lock = threading.Lock()
_stamps = set()


def _unique_start_time(name):
    """A start-time stamp no other cell of this process holds for the
    same test name. The store path is base_dir/<name>/<start-time>;
    same-workload cells share a name, and two pool threads stamping in
    the same microsecond would silently share (and corrupt) one run
    directory."""
    import datetime
    with _stamp_lock:
        t = datetime.datetime.now().astimezone()
        while (name, store.local_time(t)) in _stamps:
            t += datetime.timedelta(microseconds=1)
        stamp = store.local_time(t)
        _stamps.add((name, stamp))
        return stamp


class _DeviceSlotChecker(checker_core.Checker):
    """Serializes the check phase through the campaign's device-slot
    semaphore; the wait is observed so a slot-starved campaign is
    visible in metrics rather than just slow."""

    def __init__(self, inner, sem, reg):
        self.inner = checker_core.as_checker(inner)
        # keep the wrapped checker's name: spans/metrics must read
        # "jax-wgl"/"Compose", not the wrapper class, so campaign and
        # single-run telemetry stay comparable
        self.name = checker_core.checker_name(self.inner)
        self.sem = sem
        self.reg = reg

    def check(self, test, hist, opts=None):
        t0 = time.monotonic()
        with self.sem:
            self.reg.observe("campaign.device_wait_s",
                             time.monotonic() - t0)
            return self.inner.check(test, hist, opts or {})


def _outcome_of(test, latch):
    """(outcome, valid): test_all-compatible outcomes plus "aborted"
    for CAMPAIGN-latched runs (their salvaged verdict covers only a
    prefix because the sweep was interrupted, so resume runs them
    again). A cell that aborted on its OWN deadline (per-cell
    ``time-limit-s`` sets ``test["aborted"] = "time-limit"`` with no
    latch involved) ran exactly as planned: it keeps its decided
    outcome, or resume would re-run it to the same deadline forever."""
    valid = (test.get("results") or {}).get("valid")
    if test.get("aborted") and latch.is_set() \
            and str(test["aborted"]) == str(latch.reason):
        return "aborted", valid
    # a MONITOR-aborted cell ("monitor-violation" on the cell's own
    # chained latch, never the campaign latch) falls through here on
    # purpose: its salvaged prefix was checked, so its verdict is a
    # TERMINAL outcome (normally False) that --resume must not re-run
    if valid is True or valid is False:
        return valid, valid
    return "unknown", valid


def run_cells(cells, *, campaign_id=None, parallel=1, device_slots=1,
              resume=False, latch=None, run_fn=None, ledger=True,
              backends=None, fleetlint=True, capacity_plan=None,
              certify=True):
    """Run a campaign; returns the aggregated report dict (also
    persisted as report.json in the campaign directory).

    ``resume=True`` requires an existing campaign: pass its id, or
    leave ``campaign_id`` None to pick the most recently touched one.

    ``ledger=True`` (default) attaches the disk-persistent compile
    ledger (fleet.ledger, ``store/compile_ledger/``) so plan-shape
    sightings survive restarts and are shared across campaign
    processes; the campaign's hit/miss delta is appended to the ledger
    at finalize and the aggregate appears in the report.

    ``backends`` (fleet.backends.Failover or a tier list) enables
    per-cell backend failover: before each cell runs, the healthiest
    tier is chosen and applied (a card that is down degrades the cell
    to the CPU oracle instead of crashing it); the chosen tier is
    journaled on the cell record.

    ``capacity_plan`` (an analysis.capplan plan dict, built by the
    CLI from the matrix + base options) is persisted as
    ``capacity_plan.json`` in the campaign directory, and at finalize
    the plan's predicted (model, bucket) shapes are diffed against
    the plan shapes this campaign actually noted
    (``compile_cache.noted_counts``/``noted_since`` bracket) into
    ``report["capacity"]`` -- the prediction oracle. CONTAINED both
    ends: a crashing planner/oracle never changes a cell outcome or
    the campaign exit code (the searchplan rule).

    ``certify=True`` (default) re-certifies a deterministic sample of
    the cells' persisted runs at finalize from their own artifacts
    (analysis.certify: witness replay + certificate/results
    agreement) into ``report["certification"]``. CONTAINED the same
    way: sampled findings are reported, never outcome-bearing."""
    cells = list(cells)
    ids = [c["id"] for c in cells]
    if len(set(ids)) != len(ids):
        raise CampaignError(f"duplicate cell ids: "
                            f"{sorted({i for i in ids if ids.count(i) > 1})}")
    run_fn = run_fn or core.run
    if resume and campaign_id is None:
        campaign_id = store.latest_campaign()
        if campaign_id is None:
            raise CampaignError("--resume: no campaign found in the store")
    campaign_id = campaign_id or new_campaign_id()
    jr = CampaignJournal(campaign_id)
    prior = jr.load_meta()
    if resume and prior is None:
        raise CampaignError(f"--resume: campaign {campaign_id!r} was "
                            "never started")
    if prior is not None and not resume:
        # starting fresh over an existing journal would append a second
        # run's records onto the first's (duplicate rows, counts off)
        raise CampaignError(
            f"campaign {campaign_id!r} already exists: pass --resume "
            "to continue it, or pick a new --campaign-id")
    if resume and fleetlint:
        # fleetlint preflight before TRUSTING the journal (PL018):
        # the skip-terminal resume fold is only sound over a journal
        # with one writer and one terminal record per cell
        from ..analysis import fleetlint as flint
        from ..analysis import planlint, render_text
        from ..analysis import errors as diag_errors
        pf = planlint.lint_fleetlint({
            "resume?": True,
            "journal-diags": flint.preflight(campaign_id,
                                             records=jr.records())})
        if diag_errors(pf):
            raise CampaignError(render_text(
                diag_errors(pf),
                title="--resume refused: journal fails the fleetlint "
                      "preflight:"))
    if resume:
        # an HA (fleet.ha) journal must be resumed through the FLEET
        # path: the scheduler has no coordinator lease, so its appends
        # would carry no epoch stamp and no fencing -- a live standby
        # could take over mid-resume and both would write
        from ..fleet import ha as fha
        cur_epoch = fha.current_epoch(jr.records())
        if cur_epoch:
            raise CampaignError(
                f"--resume: campaign {campaign_id!r} is coordinator-HA "
                f"(epoch {cur_epoch}): resume it in fleet mode "
                "(--workers ...) so the prior epoch is fenced with a "
                "journaled takeover record first")
    done = jr.completed() if resume else {}
    if resume:
        # compare EVERY journaled cell (terminal or aborted) against
        # the plan: a stale non-terminal record for a cell the matrix
        # no longer contains would otherwise poison the final report
        # and exit code forever
        unknown = {r.get("cell") for r in jr.records()} - set(ids)
        if unknown:
            raise CampaignError(
                f"--resume: journal has cells not in this plan "
                f"{sorted(unknown)} -- same campaign id, different "
                "matrix?")
    # spread the prior meta first: a resume must not strip keys a
    # prior (possibly newer) coordinator recorded alongside ours
    jr.write_meta({
        **(prior or {}),
        "status": "running",
        "created": (prior or {}).get("created") or store.local_time(),
        "updated": store.local_time(),
        "cells": ids,
        "parallel": parallel,
        "device-slots": device_slots,
        "resumes": ((prior or {}).get("resumes") or 0) + (1 if resume
                                                          else 0),
    })

    latch = latch or robust.AbortLatch()
    tr = Tracer(context={"campaign": campaign_id,
                         "role": "coordinator"})
    reg = Registry()
    sem = threading.BoundedSemaphore(max(1, int(device_slots)))
    # crash-safe campaign telemetry: a kill -9'd coordinator leaves
    # its scheduling trace + counters readable next to cells.jsonl
    try:
        tr.attach_journal(
            store.campaign_path(campaign_id, store.TRACE_JOURNAL_FILE))
        reg.attach_journal(
            store.campaign_path(campaign_id,
                                store.METRICS_JOURNAL_FILE))
    except Exception:  # noqa: BLE001 - journals are insurance
        logger.warning("couldn't attach campaign telemetry journals",
                       exc_info=True)
    led = None
    if ledger:
        try:
            from ..fleet import ledger as fledger
            led = fledger.attach()
        except Exception:  # noqa: BLE001 - persistence is optional
            logger.warning("couldn't attach the persistent compile "
                           "ledger; in-memory counting only",
                           exc_info=True)
    if backends is not None:
        from ..fleet import backends as fbackends
        backends = fbackends.as_failover(backends)
    cc_before = compile_cache.stats()
    cap_before = None
    if capacity_plan is not None:
        # persist the plan next to the journal and open the oracle
        # bracket; contained -- the plan is advisory, never a gate
        try:
            from ..analysis import capplan
            capplan.dump_plan(
                capacity_plan,
                store.campaign_path(campaign_id, capplan.PLAN_FILE))
            cap_before = compile_cache.noted_counts()
        except Exception:  # noqa: BLE001 - planning is advisory
            logger.warning("couldn't persist the capacity plan "
                           "(contained)", exc_info=True)
            capacity_plan = None
    pending = [c for c in cells if c["id"] not in done]
    reg.set_gauge("campaign.cells_total", len(cells))
    reg.set_gauge("campaign.cells_resumed", len(done))
    if done:
        logger.info("campaign %s: resuming, %d/%d cells already done",
                    campaign_id, len(done), len(cells))

    def run_one(cell):
        if latch.is_set():
            return None          # never started: no record, resume runs it
        cid = cell["id"]
        t0 = time.monotonic()
        rec = {"cell": cid, "group": cell.get("group") or cid,
               "params": cell.get("params") or {}}
        test = None
        # per-cell plan-shape delta: exact at --parallel 1; under a
        # wider pool, concurrent cells' counters cross-attribute, but
        # the SUM stays right -- good enough for the cold/warm wall
        # fold the ledger stats event carries
        cc_cell = compile_cache.stats()
        with tr.span("campaign.cell", cat="campaign",
                     args={"cell": cid}):
            try:
                build = cell.get("build")
                test = build(cell.get("params") or {}) if build \
                    else cell["test"]
                if isinstance(test, dict) and test.get("name") \
                        and not test.get("start-time"):
                    test["start-time"] = _unique_start_time(
                        str(test["name"]))
                test = core.prepare_test(test)
                test.setdefault("campaign", {}).update(
                    {"id": campaign_id, "cell": cid,
                     "params": cell.get("params") or {}})
                # trace-context propagation: the cell's own run-scope
                # tracer/registry stamp every span and metric with
                # {campaign, cell}, so obs.merge can fold the run's
                # trace into the campaign timeline
                test.setdefault("obs-context",
                                {"campaign": campaign_id, "cell": cid})
                test["abort"] = latch
                if backends is not None:
                    # failover tiering: a card that is down degrades
                    # this cell to a slower tier instead of crashing it
                    tier = backends.choose()
                    backends.apply(test, tier)
                    rec["backend"] = tier
                    reg.inc("fleet.backend_cells", tier=str(tier))
                if test.get("checker") is not None:
                    test["checker"] = _DeviceSlotChecker(
                        test["checker"], sem, reg)
                if test.get("monitor"):
                    # monitored cells count against the device slots:
                    # the monitor's device-engine chunk checks acquire
                    # the same semaphore as offline searches, so a
                    # fleet can't oversubscribe the accelerator by
                    # monitoring every cell at once
                    test["monitor-device-sem"] = sem
                finished = run_fn(test)
                outcome, valid = _outcome_of(finished, latch)
                rec["outcome"], rec["valid"] = outcome, valid
                if finished.get("aborted"):
                    rec["abort-reason"] = str(finished["aborted"])
                err = (finished.get("results") or {}).get("error")
                if err:
                    rec["error"] = str(err)
            except Exception:  # noqa: BLE001 - contained per cell
                logger.warning("campaign cell %s crashed\n%s", cid,
                               traceback.format_exc())
                rec["outcome"] = "crashed"
                rec["error"] = traceback.format_exc(limit=8)
        try:
            rec["path"] = store.path(test) if test else None
        except (AssertionError, AttributeError, KeyError, TypeError):
            # a crashed build may have left a non-test on `test`; path
            # recovery must never take down the campaign loop
            rec["path"] = None
        rec["compile-cache"] = compile_cache.delta(cc_cell)
        rec["wall_s"] = round(time.monotonic() - t0, 3)
        jr.append_cell(rec)
        reg.inc("campaign.cells", outcome=str(rec["outcome"]))
        reg.observe("campaign.cell_s", rec["wall_s"])
        return rec

    hard_abort = None
    try:
        with robust.signal_scope(latch):
            with tr.span("campaign.run", cat="campaign",
                         args={"id": campaign_id,
                               "cells": len(pending)}):
                if parallel <= 1:
                    for cell in pending:
                        run_one(cell)
                else:
                    pool = ThreadPoolExecutor(
                        max_workers=int(parallel),
                        thread_name_prefix="jepsen campaign")
                    try:
                        for f in [pool.submit(run_one, c)
                                  for c in pending]:
                            f.result()
                        pool.shutdown(wait=True)
                    except BaseException:
                        # hard abort (second SIGINT raises
                        # KeyboardInterrupt in the main thread): stop
                        # waiting HERE so finalize below runs and the
                        # exception propagates promptly. Pool threads
                        # are non-daemon — a plain interpreter exit
                        # still joins any cell wedged past the latch
                        # drain; the CLI is immune because hard_main
                        # exits via os._exit once artifacts are down
                        pool.shutdown(wait=False, cancel_futures=True)
                        raise
    except BaseException as e:  # noqa: BLE001 - finalize, then rethrow
        hard_abort = e
        if not latch.is_set():
            latch.set(repr(e))
        logger.warning("campaign %s hard-aborted (%r); journal is "
                       "resumable with --resume", campaign_id, e)

    try:
        cc = compile_cache.delta(cc_before)
        reg.set_gauge("campaign.compile_cache.hits", cc["hits"])
        reg.set_gauge("campaign.compile_cache.misses", cc["misses"])
        if led is not None:
            # persist this campaign's delta, then surface the
            # cross-process aggregate: sightings shared by SEPARATE
            # processes are the ledger's whole point
            from ..fleet.ledger import fold_walls
            # THIS run's cells only: resumed cells' walls already
            # landed in the prior process's stats event, and
            # Ledger.stats sums events -- re-folding them would
            # inflate cold/warm per resume
            cold, warm = fold_walls([r for r in jr.latest()
                                     if str(r.get("cell"))
                                     not in done])
            led.note_stats(cc["hits"], cc["misses"], cold_wall_s=cold,
                           warm_wall_s=warm)
            try:
                cc = dict(cc, ledger=led.stats())
            except Exception:  # noqa: BLE001 - bookkeeping only
                logger.warning("couldn't aggregate compile-ledger "
                               "stats", exc_info=True)
        aborted = latch.is_set()
        # the journal is the source of truth, latest record per cell:
        # on a hard abort, pool threads may have journaled cells whose
        # futures were never drained
        report = creport.summarize(
            jr.latest(),
            meta={"id": campaign_id}, compile_cache=cc,
            aborted=aborted, abort_reason=latch.reason,
            skipped=len(done))
        jr.write_report(report)
        try:
            tr.dump(store.campaign_path(campaign_id, "trace.jsonl"))
            tr.close_journal(remove=True)
            store._dump_json(reg.snapshot(),
                             store.campaign_path(campaign_id,
                                                 "metrics.json"))
            reg.close_journal(remove=True)
        except Exception:  # noqa: BLE001 - telemetry is a byproduct
            logger.warning("couldn't write campaign obs artifacts",
                           exc_info=True)
        jr.write_meta({**(jr.load_meta() or {}),
                       "status": "aborted" if aborted else "complete",
                       "updated": store.local_time()})
        if capacity_plan is not None:
            # the prediction oracle: predicted (model, bucket) shapes
            # vs the plan shapes this campaign actually noted.
            # CONTAINED -- a crashing oracle costs the report block,
            # never an outcome or the exit code
            try:
                from ..analysis import capplan
                actual = compile_cache.noted_since(cap_before or {})
                report["capacity"] = capplan.report_section(
                    capacity_plan, actual,
                    path=store.campaign_path(campaign_id,
                                             capplan.PLAN_FILE))
                jr.write_report(report)
            except Exception:  # noqa: BLE001 - oracle is contained
                logger.warning("capacity oracle crashed (contained)",
                               exc_info=True)
        if fleetlint:
            try:
                # control-plane audit (analysis.fleetlint): scheduler
                # campaigns have no leases, but the terminal-guard
                # and single-writer invariants hold here too.
                # CONTAINED -- findings are reported, never allowed
                # to change an outcome or the exit code
                from ..analysis import fleetlint as flint
                fa, _diags = flint.audit(campaign_id)
                report["fleet_analysis"] = {"counts": fa["counts"],
                                            "checks": fa["checks"],
                                            "path": fa.get("path")}
                jr.write_report(report)
            except NotImplementedError:
                raise
            except Exception:  # noqa: BLE001 - audit is contained
                logger.warning("fleetlint audit of campaign %s "
                               "crashed (contained)", campaign_id,
                               exc_info=True)
        if certify:
            try:
                # proof-carrying verdicts, campaign grain: replay a
                # deterministic sample of the cells' persisted
                # certificates against their own run artifacts.
                # CONTAINED -- findings are reported, never allowed
                # to change an outcome or the exit code
                from ..analysis import certify as jcertify
                report["certification"] = \
                    jcertify.certify_campaign(jr.latest())
                jr.write_report(report)
            except NotImplementedError:
                raise
            except Exception:  # noqa: BLE001 - certifier is contained
                logger.warning("campaign certification crashed "
                               "(contained)", exc_info=True)
        if hard_abort is not None:
            raise hard_abort
        return report
    finally:
        # stop the journal flusher threads on EVERY exit path: on the
        # happy path the dumps above already closed them (remove=True)
        # and these are no-ops; on an exceptional exit the journal
        # files are kept -- they are the crash evidence
        tr.close_journal()
        reg.close_journal()
