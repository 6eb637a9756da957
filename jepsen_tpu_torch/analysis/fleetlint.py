"""fleetlint: a static consistency auditor for the fleet's OWN control
plane, replayed post hoc from a campaign's recorded artifacts (the
port's copy of ``jepsen_tpu/analysis/fleetlint.py``, host-only; every
check is the reference's, over the same artifacts. A local campaign
has no leases, syncs or chaos, so those checks pass over it; the
journal checks and the HA chain audit apply to every campaign).

Jepsen's premise is that a distributed system's claims are checked
from its recorded history -- and the coordinator/worker/lease plane IS
a distributed system with a history (``cells.jsonl``, per-run traces,
the merged campaign timeline) that, until this module, nobody audited.
fleetlint replays those artifacts against an explicit model of the
control-plane protocol (``fleetmodel.CampaignModel``) and emits
``FL***`` diagnostics through the shared ``analysis.diagnostics``
model into ``store/campaigns/<id>/fleet_analysis.json``.

Every check is an invariant a past PR established informally; the
partial-order obligations (grant ≺ exec ≺ result, skew-adjusted) are
the control-plane analogue of the happens-before proof obligations in
"Proving Linearizability Using Partial Orders" (arxiv 1701.05463),
applied with the prefix-monotone monitoring stance of arxiv
2509.17795: the audit only ever reads a *prefix* of the protocol's
history, and every violation it proves on a prefix stays a violation
of the whole.

Codes:

  FL001 error    duplicate terminal outcome record for one cell (the
                 dispatcher's terminal-guard was bypassed)
  FL002 error    terminal record for a cell outside the campaign's
                 planned set
  FL003 error    campaign finalized "complete" with a planned cell
                 that has no terminal record
  FL004 mixed    journal single-writer violation: two writer
                 identities interleave appends (error -- the
                 coordinator-HA oracle); more distinct writers than
                 resumes can explain (warning)
  FL005 error    terminal result with no matching lease grant for its
                 (cell, worker[, attempt])
  FL006 error    a cell burned more lease grants than the campaign's
                 max-leases budget
  FL007 error    overlapping leases: a cell re-granted with no
                 forfeit (lease-failed / lease-expired) journaled
                 between the grants
  FL008 error    sync consistency: a ``synced: true`` cell whose
                 mirrored run dir is missing, or whose files mismatch
                 the journaled manifest sizes, or with no journaled
                 ``artifact-sync`` success at all
  FL009 error    ``.sync-tmp`` staging residue after the campaign
                 (a partial copy survived where only published runs
                 should exist)
  FL010 error    trace causality: a worker's run span starts before
                 its lease grant after applying the merge's recovered
                 clock offset, or closes after the worker's own
                 result stamp (grant ≺ exec ≺ result violated)
  FL011 warning  a finalized run trace with unbalanced async spans
                 (open without close or vice versa)
  FL012 error    a run's obs-context {campaign, cell, worker}
                 disagrees with its journal record
  FL013 error    chaos accounting: injected faults outnumber the
                 observed recoveries (steals, expiries, sync
                 retries), or a scheduled kill -9 left no steal
                 trail -- an injected fault silently vanished
  FL014 info     audit coverage note: runs/sections skipped for
                 missing artifacts (never fatal -- the audit reads a
                 prefix of whatever survived)
  FL015 warning  a lease extended outside an artifact sync (the one
                 legitimate reason a finished cell may outlive its
                 TTL)
  FL016 mixed    coordinator-lease chain audit (the HA protocol,
                 fleet.ha): a takeover that doesn't name its true,
                 stamp-expired predecessor lease under a distinct
                 writer; a zombie renewal or append stamped with a
                 pre-takeover epoch after the takeover record; a
                 same-epoch append under a foreign writer (split
                 brain) -- all errors. A scheduled coordinator-kill
                 that left no takeover record is a warning (the kill
                 vanished)

Entry points: ``lint_campaign`` (diagnostics only), ``audit``
(diagnostics + the persisted ``fleet_analysis.json`` report, byte
deterministic for a given campaign state), and ``preflight`` (the
well-formedness subset -- FL001 duplicate terminal + FL004 second
writer -- that ``--resume`` runs before trusting the journal; planlint
PL018 turns its failures into refusals).

Containment: the auditor is wired into ``campaign.run_cells`` and
``fleet.run_fleet`` at finalize, where any finding -- and any auditor
crash -- is REPORTED, never allowed to flip a cell outcome or a
campaign exit code (the same rule searchplan follows for verdicts).
The port's scheduler lets a ``NotImplementedError`` through (a branch
that names a later sub-slice).
"""

from __future__ import annotations

import json
import logging
import os

from .. import store
from .diagnostics import (ERROR, INFO, WARNING, diag, errors,
                          severity_counts, to_json)
from .fleetmodel import (FORFEIT_EVENTS, HA_EVENTS, CampaignModel,
                         parse_t)

logger = logging.getLogger(__name__)

__all__ = ["ANALYSIS_FILE", "TOLERANCE_S", "lint_campaign", "audit",
           "preflight", "load_report"]

#: on-disk name of the persisted audit report, next to cells.jsonl
ANALYSIS_FILE = "fleet_analysis.json"

#: slack for cross-clock comparisons (seconds): the return-leg offset
#: estimate is biased by the result's print->parse latency (tens of
#: ms) and journal stamps have their own write latency; half a second
#: keeps loopback fleets comfortably clean while a planted
#: minutes-scale violation still trips
TOLERANCE_S = 0.5

#: how many manifest mismatches one FL008 diagnostic names before
#: truncating (the count is exact either way)
_MANIFEST_NAMED = 3


# ---------------------------------------------------------------------------
# journal well-formedness (the --resume preflight subset)

def _terminal_guard_diags(model):
    """FL001/FL002/FL003: exactly one terminal record per planned
    cell."""
    diags = []
    by_cell = model.terminal_by_cell()
    for cell, recs in sorted(by_cell.items()):
        if len(recs) > 1:
            diags.append(diag(
                "FL001", ERROR,
                f"cell has {len(recs)} terminal outcome records "
                f"(outcomes {[str(r.get('outcome')) for r in recs]}): "
                "the terminal-guard admits exactly one",
                f"campaign.cells[{cell}]",
                "a second coordinator or a guard bypass appended a "
                "stolen cell's late duplicate; the journal fold is "
                "last-wins, so earlier verdicts were silently "
                "shadowed"))
    planned = model.planned
    if planned:
        for cell, recs in sorted(by_cell.items()):
            if cell not in planned:
                diags.append(diag(
                    "FL002", ERROR,
                    "terminal record for a cell outside the planned "
                    f"set ({len(planned)} planned cells)",
                    f"campaign.cells[{cell}]",
                    "same campaign id reused for a different matrix?"))
        if model.status == "complete":
            for cell in planned:
                if cell not in by_cell:
                    diags.append(diag(
                        "FL003", ERROR,
                        "campaign finalized \"complete\" but this "
                        "planned cell has no terminal record",
                        f"campaign.cells[{cell}]",
                        "an incomplete campaign must finalize "
                        "\"aborted\" (workers-exhausted latch), "
                        "never \"complete\""))
    return diags


def _writer_diags(model):
    """FL004: the single-writer oracle. Writer identities must form
    contiguous runs (a resume hands the journal to a NEW writer; two
    interleaved writers were alive at once), and there should be no
    more writers than resumes can explain. Takeover-aware: the HA
    role events (coordinator-lease / coordinator-takeover) are
    excluded from the runs, so a losing standby's lone fence attempt
    -- one takeover record wedged inside the winner's run -- is not
    an interleaving; zombie appends that exclusion could hide are
    caught by epoch in FL016 instead."""
    diags = []
    runs = model.writer_runs(skip_ha=True)
    seen = set()
    for w, idx, _count in runs:
        if w in seen:
            rec = model.records[idx]
            where = rec.get("cell") or rec.get("event") or "?"
            diags.append(diag(
                "FL004", ERROR,
                f"journal writer {w!r} resumed appending at record "
                f"{idx} ({where!r}) after another writer had taken "
                "over: two coordinators held the journal at once",
                f"journal[{idx}]",
                "exactly one coordinator may write cells.jsonl; a "
                "standby must wait for the incumbent's lease to "
                "expire before resuming"))
        seen.add(w)
    distinct = len({r[0] for r in runs})
    if distinct > model.resumes + 1:
        diags.append(diag(
            "FL004", WARNING,
            f"{distinct} distinct journal writers but only "
            f"{model.resumes} journaled resume(s): a writer appended "
            "without registering a resume",
            "journal",
            "every coordinator handoff should pass through the "
            "--resume path (which bumps campaign.json's resume "
            "count)"))
    return diags


# ---------------------------------------------------------------------------
# lease lifecycle

def _lease_diags(model):
    """FL005/FL006/FL007/FL015 over the journal's lease protocol."""
    diags = []
    if model.mode != "fleet":
        return diags
    max_leases = model.max_leases
    cells = sorted({str(e.get("cell")) for e in model.grants()}
                   | set(model.terminal_by_cell()))
    for cell in cells:
        # the lease budget is enforced PER COORDINATOR SESSION (the
        # dispatcher's LeaseTable attempt counter starts fresh on
        # every --resume), so the audit counts grants within one
        # writer's tenure -- a resumed campaign may legally hold more
        # grants across the whole journal than one session's budget
        if max_leases is not None:
            per_writer = {}
            for g in model.grants(cell):
                w = g.get("writer")
                per_writer[w] = per_writer.get(w, 0) + 1
            worst = max(per_writer.values(), default=0)
            if worst > max_leases:
                diags.append(diag(
                    "FL006", ERROR,
                    f"{worst} lease grants within one coordinator "
                    f"session exceed the max-leases budget of "
                    f"{max_leases}",
                    f"campaign.cells[{cell}]",
                    "the dispatcher must journal the cell crashed "
                    "once the budget is spent, not keep re-leasing"))
        # steal only after a forfeit: between two grants of one cell
        # there must be a lease-failed/lease-expired record -- UNLESS
        # the re-grant comes from a NEW writer: a coordinator that
        # died holding a live lease can never journal the forfeit,
        # and its death forfeits everything it held (FL004 separately
        # proves the old writer never came back)
        timeline = model.lease_timeline(cell)
        prev_grant, forfeited = None, True
        for _i, kind, rec in timeline:
            if kind == "lease":
                handoff = prev_grant is not None \
                    and rec.get("writer") != prev_grant.get("writer")
                if prev_grant is not None and not forfeited \
                        and not handoff:
                    diags.append(diag(
                        "FL007", ERROR,
                        f"lease re-granted to "
                        f"{rec.get('worker')!r} (attempt "
                        f"{rec.get('attempt')}) while "
                        f"{prev_grant.get('worker')!r}'s lease had "
                        "no journaled forfeit: two live leases on "
                        "one cell",
                        f"campaign.cells[{cell}]",
                        "a steal must be preceded by lease-failed / "
                        "lease-expired in the journal"))
                prev_grant, forfeited = rec, False
            elif kind in FORFEIT_EVENTS:
                forfeited = True
    # every terminal result must trace back to a granted lease
    for cell, recs in sorted(model.terminal_by_cell().items()):
        for rec in recs:
            worker = rec.get("worker")
            if worker is None:
                continue        # budget-exhaustion crash records
            grants = [g for g in model.grants(cell)
                      if str(g.get("worker")) == str(worker)]
            attempt = rec.get("attempt")
            if attempt is not None:
                grants = [g for g in grants
                          if g.get("attempt") == attempt]
            if not grants:
                diags.append(diag(
                    "FL005", ERROR,
                    f"terminal result from worker {worker!r}"
                    + (f" (attempt {attempt})"
                       if attempt is not None else "")
                    + " has no matching lease grant in the journal",
                    f"campaign.cells[{cell}]",
                    "results are only acceptable under a journaled "
                    "lease (grant ≺ exec ≺ result)"))
    # extends are legitimate only to cover an artifact sync
    sync_idx = [i for i, r in enumerate(model.records)
                if r.get("event") == "artifact-sync"]
    for i, rec in enumerate(model.records):
        if rec.get("event") != "lease-extend":
            continue
        cell = str(rec.get("cell"))
        covered = any(j > i and str(model.records[j].get("cell"))
                      == cell for j in sync_idx)
        if not covered:
            diags.append(diag(
                "FL015", WARNING,
                "lease extended with no artifact-sync journaled "
                "after it: the extension hid the cell from the "
                "death-detection bound for no recorded reason",
                f"campaign.cells[{cell}]",
                "extend a lease only to cover the sync of a "
                "finished cell's artifacts"))
    return diags


# ---------------------------------------------------------------------------
# sync consistency

def _sync_diags(model):
    """FL008/FL009: a ``synced: true`` record's mirror must exist and
    match the journaled manifest byte for byte (sizes); the staging
    area must be empty."""
    diags = []
    for rec in sorted(model.latest, key=lambda r: str(r.get("cell"))):
        if rec.get("synced") is not True:
            continue
        cell = str(rec.get("cell"))
        oks = [e for e in model.events_of("artifact-sync", cell)
               if e.get("status") == "ok"]
        if not oks:
            diags.append(diag(
                "FL008", ERROR,
                "record claims synced: true but the journal has no "
                "artifact-sync success event for the cell",
                f"campaign.cells[{cell}]",
                "every mirror must journal as an artifact-sync "
                "event; a bare flag is unauditable"))
            continue
        path = str(rec.get("path") or "")
        if not path or not os.path.isdir(path):
            diags.append(diag(
                "FL008", ERROR,
                f"synced: true but the mirrored run dir {path!r} "
                "does not exist",
                f"campaign.cells[{cell}]",
                "the atomic-rename publish should make this "
                "impossible; the store was modified after the fact"))
            continue
        man = oks[-1].get("manifest")
        if not isinstance(man, dict):
            continue            # pre-upgrade event: nothing to verify
        bad = []
        for rel, size in sorted(man.items()):
            p = os.path.join(path, str(rel))
            try:
                got = os.path.getsize(p)
            except OSError:
                bad.append(f"{rel} missing")
                continue
            if got != size:
                bad.append(f"{rel} is {got} bytes, manifest says "
                           f"{size}")
        if bad:
            shown = "; ".join(bad[:_MANIFEST_NAMED])
            more = len(bad) - _MANIFEST_NAMED
            diags.append(diag(
                "FL008", ERROR,
                f"mirrored run dir mismatches the journaled "
                f"manifest ({len(bad)} file(s)): {shown}"
                + (f"; +{more} more" if more > 0 else ""),
                f"campaign.cells[{cell}]",
                "a torn copy went visible: the size-verify + "
                "atomic-rename discipline was bypassed"))
    tmp = store.sync_tmp_path()
    try:
        residue = sorted(os.listdir(tmp))
    except OSError:
        residue = []
    if residue:
        diags.append(diag(
            "FL009", ERROR,
            f".sync-tmp holds {len(residue)} staged entr(ies) "
            f"({residue[:3]}...): a partial copy survived the "
            "campaign",
            "store/.sync-tmp",
            "staging is cleared in the pull's finally; residue "
            "means a sync crashed uncleanly"))
    return diags


# ---------------------------------------------------------------------------
# trace causality

def _trace_diags(model):
    """FL010/FL011/FL012 over per-run traces, clocks normalized with
    the merge's per-worker offsets."""
    diags = []
    if model.mode != "fleet":
        return diags, 0, 0
    offsets = model.worker_offsets()
    audited = skipped = 0
    for rec in sorted(model.latest, key=lambda r: str(r.get("cell"))):
        cell = str(rec.get("cell"))
        worker = rec.get("worker")
        path = str(rec.get("path") or "")
        if worker is None or not path or not os.path.isdir(path):
            skipped += 1
            continue
        trace = model.run_trace(path)
        if not trace.events:
            skipped += 1
            continue
        audited += 1
        ctx = trace.context()
        if ctx:
            want = {"campaign": model.id, "cell": cell,
                    "worker": str(worker)}
            got = {k: str(ctx.get(k)) for k in want if k in ctx}
            mismatched = {k: got[k] for k in got if got[k] != want[k]}
            if mismatched:
                diags.append(diag(
                    "FL012", ERROR,
                    f"run obs-context {mismatched} disagrees with "
                    f"the journal record {want}",
                    f"run[{path}]",
                    "the artifacts on disk belong to a different "
                    "cell/worker than the journal claims"))
        span = trace.span_wall("jepsen.run")
        if span is None:
            continue
        t0_w, t1_w = span
        off = float(offsets.get(str(worker), 0.0))
        grant = model.grant_for(cell, worker=worker,
                                attempt=rec.get("attempt"))
        grant_t = parse_t(grant.get("t")) if grant else None
        if grant_t is not None \
                and t0_w - off < grant_t - TOLERANCE_S:
            diags.append(diag(
                "FL010", ERROR,
                f"run span starts {grant_t - (t0_w - off):.3f}s "
                f"before its lease grant (worker clock offset "
                f"{off:+.3f}s applied): grant ≺ exec violated",
                f"run[{path}]",
                "either the trace belongs to another lease or the "
                "recovered clock offset is wrong -- both mean the "
                "merged timeline cannot be trusted"))
        clock = rec.get("clock") or {}
        try:
            wre = float(clock["worker-result-epoch"])
        except (KeyError, TypeError, ValueError):
            wre = None
        if wre is not None and t1_w > wre + TOLERANCE_S:
            diags.append(diag(
                "FL010", ERROR,
                f"run span closes {t1_w - wre:.3f}s after the "
                "worker printed its result (same clock): exec ≺ "
                "result violated",
                f"run[{path}]",
                "the result line must be the last act of the run"))
        if trace.finalized:
            unbalanced = trace.unbalanced_async()
            if unbalanced:
                names = sorted({n for n, _i in unbalanced})[:3]
                diags.append(diag(
                    "FL011", WARNING,
                    f"finalized trace has {len(unbalanced)} "
                    f"unbalanced async span(s) (e.g. {names})",
                    f"run[{path}]",
                    "a span opened without closing in a trace that "
                    "finalized cleanly usually means a lost "
                    "async_end"))
    return diags, audited, skipped


# ---------------------------------------------------------------------------
# chaos accounting

def _chaos_diags(model):
    """FL013: every injected fault must be matched by an observed
    recovery -- a steal, an expiry, a retried or failed sync -- so
    faults cannot silently vanish; and every scheduled kill -9 must
    have left its steal trail in the journal."""
    diags = []
    if not isinstance((model.meta or {}).get("chaos"), dict):
        return diags
    if model.status != "complete":
        return diags            # an aborted soak proves nothing
    faults = model.chaos_fault_counts()
    total_faults = sum(faults.values())
    if total_faults:
        recoveries = (len(model.events_of("lease-failed"))
                      + len(model.events_of("lease-expired"))
                      + len(model.events_of("worker-dead")))
        for ev in model.events_of("artifact-sync"):
            attempts = ev.get("attempts")
            attempts = int(attempts) \
                if isinstance(attempts, int) else 0
            if ev.get("status") == "ok":
                recoveries += max(attempts - 1, 0)
            else:
                recoveries += max(attempts, 1)
        if total_faults > recoveries:
            diags.append(diag(
                "FL013", ERROR,
                f"{total_faults} injected fault(s) {faults} but only "
                f"{recoveries} observed recover(ies) (steals, "
                "expiries, sync retries/failures): at least "
                f"{total_faults - recoveries} fault(s) vanished "
                "without a recorded recovery",
                "campaign.chaos",
                "every injected fault must surface as a journaled "
                "forfeit or a sync retry -- a swallowed fault is a "
                "swallowed real failure"))
    prof = model.chaos_profile()
    if prof is not None and prof.kills:
        for cell in sorted(prof.plan_kills(model.planned)):
            if len(model.grants(cell)) < 2:
                diags.append(diag(
                    "FL013", ERROR,
                    "chaos scheduled a kill -9 on this cell's first "
                    "lease but the journal shows no re-lease: the "
                    "kill (or its steal) vanished",
                    f"campaign.cells[{cell}]",
                    "a killed worker's cell must be stolen and "
                    "re-leased; one grant means the kill never "
                    "fired or the steal never happened"))
    return diags


# ---------------------------------------------------------------------------
# coordinator-HA chain audit

def _as_epoch(v):
    return v if isinstance(v, int) and not isinstance(v, bool) else None


def _ha_diags(model):
    """FL016: replay the coordinator-lease chain (fleet.ha). One walk
    over the journal tracks the authoritative ``(epoch, writer)``
    exactly like ``ha.coordinator_state`` and checks every record
    against it: takeovers must name their true, stamp-expired
    predecessor under a distinct writer (``forced`` operator fences
    skip the expiry requirement -- the operator is the evidence);
    after a takeover, any record stamped with a pre-takeover epoch is
    a zombie append the fencing race let through, and a same-epoch
    record under a foreign writer is split brain. Losing fence
    attempts (a second takeover naming an already-fenced predecessor)
    are benign by themselves -- the loser standing down is exactly
    what the split-brain check proves. Returns ``(diags,
    takeovers_audited)``; a journal with no HA events yields
    nothing."""
    diags = []
    has_ha = any(r.get("event") in HA_EVENTS for r in model.records)
    if not has_ha:
        prof = model.chaos_profile()
        if prof is not None \
                and getattr(prof, "coordinator_kill", 0) \
                and model.status == "complete":
            diags.append(diag(
                "FL016", WARNING,
                "chaos scheduled a coordinator-kill but the journal "
                "has no coordinator-lease or takeover records: the "
                "kill (or the whole HA protocol) vanished",
                "campaign.chaos",
                "coordinator-kill chaos needs --coordinator-lease-s "
                "so a standby can fence the corpse"))
        return diags, 0
    epoch, writer = 0, None
    taken = set()
    lease_by_epoch = {}
    audited = 0
    for i, rec in enumerate(model.records):
        ev = rec.get("event")
        e = _as_epoch(rec.get("epoch"))
        if ev == "coordinator-lease":
            if e is None:
                diags.append(diag(
                    "FL016", ERROR,
                    "coordinator-lease record without an integer "
                    "epoch",
                    f"journal[{i}]",
                    "the epoch is the fencing token; a lease without "
                    "one cannot be fenced"))
                continue
            if e > epoch:
                epoch, writer = e, rec.get("writer")
            elif e < epoch:
                diags.append(diag(
                    "FL016", ERROR,
                    f"zombie coordinator renewal: lease at epoch {e} "
                    f"appended while epoch {epoch} "
                    f"({writer!r}) holds the role",
                    f"journal[{i}]",
                    "a fenced coordinator must refuse its own "
                    "renewals once the takeover record lands"))
            elif rec.get("writer") != writer:
                diags.append(diag(
                    "FL016", ERROR,
                    f"split brain: epoch {e} renewed by "
                    f"{rec.get('writer')!r} while held by {writer!r}",
                    f"journal[{i}]",
                    "two coordinators claimed the same epoch; the "
                    "takeover protocol increments it"))
            lease_by_epoch[e] = rec
        elif ev == "coordinator-takeover":
            audited += 1
            prev = _as_epoch(rec.get("prev-epoch"))
            if prev is not None and prev in taken:
                continue        # a losing fence attempt: benign
            if rec.get("prev-writer") is not None \
                    and rec.get("writer") == rec.get("prev-writer"):
                diags.append(diag(
                    "FL016", ERROR,
                    f"takeover by {rec.get('writer')!r} names ITSELF "
                    "as the fenced predecessor: not a distinct "
                    "writer",
                    f"journal[{i}]",
                    "a coordinator cannot fence itself; takeovers "
                    "come from standbys (or a fresh --resume "
                    "process)"))
            if prev != epoch or (writer is not None
                                 and rec.get("prev-writer") != writer):
                diags.append(diag(
                    "FL016", ERROR,
                    f"takeover names predecessor epoch "
                    f"{rec.get('prev-epoch')!r} writer "
                    f"{rec.get('prev-writer')!r} but the journal's "
                    f"authoritative state was epoch {epoch} "
                    f"({writer!r})",
                    f"journal[{i}]",
                    "a fence must name the exact lease it expired; "
                    "anything else means the standby read a stale "
                    "journal"))
            if not rec.get("forced"):
                prev_lease = lease_by_epoch.get(prev)
                if prev_lease is None:
                    diags.append(diag(
                        "FL016", ERROR,
                        "takeover names no expired predecessor "
                        f"lease (epoch {rec.get('prev-epoch')!r} "
                        "never renewed)",
                        f"journal[{i}]",
                        "only an expired coordinator-lease justifies "
                        "a fence; use a forced takeover for "
                        "operator-driven handoffs"))
                else:
                    t_to = parse_t(rec.get("t"))
                    t_lease = parse_t(prev_lease.get("t"))
                    ttl = prev_lease.get("lease-s")
                    ttl = float(ttl) if isinstance(ttl, (int, float)) \
                        and not isinstance(ttl, bool) \
                        else model.coordinator_lease_s
                    allow = rec.get("skew-allowance-s")
                    allow = float(allow) \
                        if isinstance(allow, (int, float)) \
                        and not isinstance(allow, bool) else 0.0
                    if t_to is not None and t_lease is not None \
                            and ttl is not None \
                            and (t_to - t_lease) + allow \
                            < ttl - TOLERANCE_S:
                        diags.append(diag(
                            "FL016", ERROR,
                            f"premature takeover: the predecessor "
                            f"lease was renewed {t_to - t_lease:.3f}s "
                            f"before the fence (TTL {ttl:.1f}s, skew "
                            f"allowance {allow:+.3f}s): the fenced "
                            "coordinator may still have been alive",
                            f"journal[{i}]",
                            "standbys must wait out the full lease "
                            "TTL (plus grace) on arrivals AND "
                            "stamps before fencing"))
            if e is not None and e > epoch:
                if prev is not None:
                    taken.add(prev)
                epoch, writer = e, rec.get("writer")
        elif e is not None and taken:
            # an ordinary (cell / lease / sync) record stamped with a
            # coordinator epoch, after at least one takeover
            if e < epoch:
                where = rec.get("cell") or ev or "?"
                diags.append(diag(
                    "FL016", ERROR,
                    f"zombie append: record {i} ({where!r}) stamped "
                    f"with pre-takeover epoch {e} after epoch "
                    f"{epoch} ({writer!r}) fenced it",
                    f"journal[{i}]",
                    "the fenced coordinator's terminal-guard must "
                    "re-check the journal before appending; this "
                    "append slipped through the fencing race "
                    "window"))
            elif e == epoch and writer is not None \
                    and rec.get("writer") != writer:
                where = rec.get("cell") or ev or "?"
                diags.append(diag(
                    "FL016", ERROR,
                    f"split brain: record {i} ({where!r}) at epoch "
                    f"{e} from {rec.get('writer')!r} while the role "
                    f"is held by {writer!r}",
                    f"journal[{i}]",
                    "a losing standby must go back to tailing, "
                    "never append under the winner's epoch"))
    prof = model.chaos_profile()
    if prof is not None and getattr(prof, "coordinator_kill", 0) \
            and model.status == "complete" and not model.takeovers():
        diags.append(diag(
            "FL016", WARNING,
            "chaos scheduled a coordinator-kill but the journal has "
            "no takeover record: the kill (or the standby's fence) "
            "vanished",
            "campaign.chaos",
            "a killed coordinator's campaign can only complete "
            "through a standby takeover"))
    return diags, audited


# ---------------------------------------------------------------------------
# entry points

def _lint_model(model):
    """All checks over one parsed model; returns (diags, checks)."""
    diags = []
    diags += _terminal_guard_diags(model)
    diags += _writer_diags(model)
    diags += _lease_diags(model)
    diags += _sync_diags(model)
    tdiags, audited, skipped = _trace_diags(model)
    diags += tdiags
    diags += _chaos_diags(model)
    hdiags, ha_audited = _ha_diags(model)
    diags += hdiags
    if skipped:
        diags.append(diag(
            "FL014", INFO,
            f"{skipped} run(s) skipped by the trace audit (artifacts "
            "not mirrored / no trace)",
            "campaign.trace",
            "unsynced cells are audited once --resume or the web's "
            "on-demand fetch mirrors them"))
    if model.mode == "fleet" and not model.coordinator_trace().events \
            and isinstance((model.meta or {}).get("chaos"), dict):
        diags.append(diag(
            "FL014", INFO,
            "coordinator trace missing: chaos fault accounting "
            "audited from journal events only",
            "campaign.trace"))
    checks = {
        "records": len(model.records),
        "events": len(model.events),
        "leases": len(model.grants()),
        "cells_planned": len(model.planned),
        "cells_terminal": len(model.terminal_by_cell()),
        "runs_audited": audited,
        "runs_skipped": skipped,
        "ha_takeovers_audited": ha_audited,
    }
    return diags, checks


def _require(model):
    if model.meta is None and not model.records:
        raise FileNotFoundError(
            f"campaign {model.id!r} has no campaign.json or journal")


def lint_campaign(campaign_id, records=None):
    """Audit one campaign's artifacts; returns the Diagnostic list.
    ``records`` takes pre-parsed journal records so callers sharing
    store.load_campaign_records' single read (the dispatcher at
    finalize) don't re-read the journal."""
    model = CampaignModel(campaign_id, records=records)
    _require(model)
    return _lint_model(model)[0]


def preflight(campaign_id, records=None):
    """The well-formedness subset ``--resume`` must pass before
    trusting the journal: FL001 duplicate terminal records + FL004
    second-writer interleaving. Pure over the records -- no meta, no
    run dirs -- so it works on a journal mid-crash-recovery."""
    model = CampaignModel(campaign_id, records=records)
    return ([d for d in _terminal_guard_diags(model)
             if d.code == "FL001"]
            + [d for d in _writer_diags(model)
               if d.code == "FL004" and d.severity == ERROR])


def audit(campaign_id, records=None, persist=True):
    """Full audit; returns ``(report, diags)`` and (by default)
    persists the report as ``fleet_analysis.json`` next to
    cells.jsonl. The report is byte-deterministic for a given
    campaign state: no wall-clock stamps, sorted keys, diagnostics in
    severity/code/location order -- auditing the same artifacts twice
    yields the same bytes (the re-audit test pins this)."""
    model = CampaignModel(campaign_id, records=records)
    _require(model)
    diags, checks = _lint_model(model)
    report = {
        "campaign": model.id,
        "mode": model.mode,
        "status": model.status,
        "checks": checks,
        **to_json(diags),
    }
    if persist:
        path = store.campaign_path(model.id, ANALYSIS_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        report["path"] = path
    n = severity_counts(diags)
    if errors(diags):
        logger.warning("fleetlint: campaign %s FAILED its control-"
                       "plane audit: %d error(s), %d warning(s)",
                       model.id, n[ERROR], n[WARNING])
    else:
        logger.info("fleetlint: campaign %s audit clean (%d "
                    "warning(s), %d info)", model.id, n[WARNING],
                    n[INFO])
    return report, diags


def load_report(campaign_id):
    """The persisted fleet_analysis.json, or None."""
    try:
        with open(store.campaign_path(campaign_id,
                                      ANALYSIS_FILE)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
