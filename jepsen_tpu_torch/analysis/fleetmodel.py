"""fleetmodel: the campaign control plane's recorded history as an
explicit event model (the port's copy of
``jepsen_tpu/analysis/fleetmodel.py``, host-only).

The campaign's own artifacts -- ``campaign.json``, the ``cells.jsonl``
journal (cell outcomes, and in fleet campaigns ``lease`` /
``artifact-sync`` event records), per-run ``trace.jsonl`` /
``metrics.json`` (or their crash journals), and the merged
``campaign_trace.jsonl`` -- ARE a distributed system's history: a
coordinator and its workers exchanging leases, results, and file
transfers under injected faults. This module parses those artifacts
into one queryable model; ``fleetlint`` replays the model against the
protocol's invariants. It reads the port's local and fleet campaigns
and the JAX package's journals alike; ``chaos_profile`` rebuilds a
journaled profile with the port's ``fleet.chaos``, which draws the
reference's schedules.

Everything here is read-only and pure (no store writes, no network):
the model is built once per audit from ONE pass over the journal
(``store.load_campaign_records`` -- the single place torn tails are
handled) plus lazy per-run artifact loads, so an audit of a finished
campaign is reproducible byte for byte from the artifacts alone.
"""

from __future__ import annotations

import datetime
import json
import logging
import os

from .. import store

logger = logging.getLogger(__name__)

__all__ = ["CampaignModel", "RunTrace", "parse_t", "FORFEIT_EVENTS",
           "HA_EVENTS"]

#: journal event kinds that forfeit a cell's current lease (the legal
#: predecessors of a steal: a re-grant without one of these between
#: the grants means two live leases on one cell)
FORFEIT_EVENTS = ("lease-failed", "lease-expired")

#: the coordinator-HA role events (fleet.ha): renewals of the
#: coordinator's own lease and the takeover records that fence it
HA_EVENTS = ("coordinator-lease", "coordinator-takeover")


def parse_t(stamp):
    """A journal record's ``t`` stamp (store.local_time format) as
    epoch seconds, or None when absent/unparseable."""
    if not stamp:
        return None
    try:
        return datetime.datetime.strptime(
            str(stamp), store.TIME_FORMAT).timestamp()
    except ValueError:
        return None


class RunTrace:
    """One run directory's trace artifact: the finalized
    ``trace.jsonl`` when it exists, else the crash journal
    (``trace.jsonl.journal``, torn tail dropped). ``finalized``
    distinguishes the two -- a kill -9'd run's journal legitimately
    ends with unbalanced spans, a finalized trace should not."""

    def __init__(self, run_dir):
        from ..obs import load_trace
        self.run_dir = str(run_dir)
        self.events = []
        self.finalized = False
        for name, final in (("trace.jsonl", True),
                            (store.TRACE_JOURNAL_FILE, False)):
            p = os.path.join(self.run_dir, name)
            if os.path.exists(p):
                try:
                    self.events = load_trace(p)
                except OSError:
                    self.events = []
                self.finalized = final and bool(self.events)
                break

    @property
    def meta(self):
        """The trace_meta args ({epoch_ns, context}), or {}."""
        from ..obs.trace import trace_meta
        return trace_meta(self.events) or {}

    def context(self):
        """The {campaign, cell, worker} obs-context the run stamped
        into its tracer, or {}."""
        return dict(self.meta.get("context") or {})

    def epoch_s(self):
        """Wall epoch (seconds) the trace's ts=0 corresponds to, or
        None for pre-plane traces."""
        ns = self.meta.get("epoch_ns")
        return None if ns is None else float(ns) / 1e9

    def span(self, name):
        """The first ``X`` span with this name, or None."""
        for ev in self.events:
            if ev.get("ph") == "X" and ev.get("name") == name:
                return ev
        return None

    def span_wall(self, name):
        """(start_epoch_s, end_epoch_s) of the named span on THIS
        host's wall clock, or None when the span or anchor is
        missing."""
        ep = self.epoch_s()
        ev = self.span(name)
        if ep is None or ev is None:
            return None
        try:
            t0 = ep + float(ev.get("ts", 0.0)) / 1e6
            return t0, t0 + float(ev.get("dur", 0.0)) / 1e6
        except (TypeError, ValueError):
            return None

    def unbalanced_async(self):
        """{(name, id): open_count} for async ``b`` events without a
        matching ``e`` (and vice versa, negative counts)."""
        open_ = {}
        for ev in self.events:
            ph = ev.get("ph")
            if ph not in ("b", "e"):
                continue
            key = (str(ev.get("name")), str(ev.get("id")))
            open_[key] = open_.get(key, 0) + (1 if ph == "b" else -1)
        return {k: v for k, v in open_.items() if v}


class CampaignModel:
    """One campaign's artifacts, parsed once and indexed for the
    protocol checks."""

    def __init__(self, campaign_id, records=None):
        self.id = str(campaign_id)
        self.dir = store.campaign_path(self.id)
        try:
            with open(os.path.join(self.dir, "campaign.json")) as f:
                self.meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            self.meta = None
        #: the ONE journal read every fold below shares
        self.records = list(records) if records is not None \
            else store.load_campaign_records(self.id)
        self.events = store.fold_event_records(self.records)
        self.outcomes = [r for r in self.records if not r.get("event")]
        self.latest = store.fold_latest_records(self.records)
        self._run_traces = {}

    # -- meta accessors -------------------------------------------------

    @property
    def status(self):
        return (self.meta or {}).get("status")

    @property
    def mode(self):
        return (self.meta or {}).get("mode")

    @property
    def planned(self):
        return [str(c) for c in ((self.meta or {}).get("cells") or [])]

    @property
    def lease_s(self):
        v = (self.meta or {}).get("lease-s")
        return float(v) if isinstance(v, (int, float)) else None

    @property
    def max_leases(self):
        v = (self.meta or {}).get("max-leases")
        return int(v) if isinstance(v, int) and not isinstance(v, bool) \
            else None

    @property
    def resumes(self):
        v = (self.meta or {}).get("resumes")
        return int(v) if isinstance(v, int) else 0

    def chaos_profile(self):
        """The journaled chaos profile reconstructed (so e.g. its
        kill schedule can be re-derived deterministically), or None."""
        spec = (self.meta or {}).get("chaos")
        if not isinstance(spec, dict):
            return None
        from ..fleet.chaos import ChaosProfile
        try:
            return ChaosProfile(**spec)
        except TypeError:
            logger.warning("campaign %s: unreconstructable chaos "
                           "profile %r", self.id, spec)
            return None

    # -- journal folds --------------------------------------------------

    def terminal_records(self, cell=None):
        """ALL terminal outcome records (outcome != "aborted"), append
        order -- deliberately NOT the latest-per-cell fold: the
        terminal-guard invariant is about every record ever appended."""
        out = [r for r in self.outcomes if r.get("outcome") != "aborted"]
        if cell is not None:
            out = [r for r in out if str(r.get("cell")) == str(cell)]
        return out

    def terminal_by_cell(self):
        by = {}
        for r in self.terminal_records():
            by.setdefault(str(r.get("cell")), []).append(r)
        return by

    def events_of(self, kind, cell=None):
        out = [e for e in self.events if e.get("event") == kind]
        if cell is not None:
            out = [e for e in out if str(e.get("cell")) == str(cell)]
        return out

    def grants(self, cell=None):
        return self.events_of("lease", cell)

    def grant_for(self, cell, worker=None, attempt=None):
        """The lease grant matching a terminal record's (cell, worker,
        attempt), or the cell's last grant when the attempt wasn't
        recorded. None when the cell was never leased."""
        cands = self.grants(cell)
        if worker is not None:
            wcands = [g for g in cands
                      if str(g.get("worker")) == str(worker)]
            cands = wcands or cands
        if attempt is not None:
            for g in cands:
                if g.get("attempt") == attempt:
                    return g
        return cands[-1] if cands else None

    def lease_timeline(self, cell):
        """[(journal_index, kind, record)] for one cell's lease grants
        and forfeits, in append order -- the sequence the
        steal-after-forfeit rule is checked over."""
        out = []
        for i, rec in enumerate(self.records):
            kind = rec.get("event")
            if kind in ("lease",) + tuple(FORFEIT_EVENTS) \
                    and str(rec.get("cell")) == str(cell):
                out.append((i, kind, rec))
        return out

    def writer_runs(self, skip_ha=False):
        """The journal's writer identities as contiguous runs:
        ``[(writer, first_index, count), ...]``. Records without a
        stamp (pre-upgrade journals) are skipped. A writer appearing
        in two non-adjacent runs means two coordinators interleaved
        appends -- the single-writer violation. With ``skip_ha`` the
        HA role events are excluded (indices still point into
        ``self.records``): a losing standby's lone takeover record is
        a fence attempt, not an interleaved coordinator -- zombie
        appends hiding behind the exclusion are FL016's job, which
        catches them by epoch instead of adjacency."""
        runs = []
        for i, rec in enumerate(self.records):
            if skip_ha and rec.get("event") in HA_EVENTS:
                continue
            w = rec.get("writer")
            if not w:
                continue
            if runs and runs[-1][0] == w:
                runs[-1][2] += 1
            else:
                runs.append([str(w), i, 1])
        return [tuple(r) for r in runs]

    # -- coordinator HA (fleet.ha) --------------------------------------

    @property
    def coordinator_lease_s(self):
        v = (self.meta or {}).get("coordinator-lease-s")
        return float(v) if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else None

    def ha_leases(self):
        """All coordinator-lease renewal events, append order."""
        return self.events_of("coordinator-lease")

    def takeovers(self):
        """All coordinator-takeover (fence) events, append order."""
        return self.events_of("coordinator-takeover")

    def coordinator_state(self):
        """The journal's authoritative ``(epoch, writer)`` (fleet.ha
        fold; ``(0, None)`` for a pre-HA journal)."""
        from ..fleet.ha import coordinator_state
        return coordinator_state(self.records)

    def worker_offsets(self):
        """{worker: offset_s} -- the merge's per-worker median clock
        offset (worker minus coordinator), from the lease handshakes
        on the outcome records."""
        from ..obs.merge import worker_offsets
        return worker_offsets(self.latest)

    # -- per-run artifacts ----------------------------------------------

    def run_trace(self, run_dir):
        """Cached RunTrace for a run directory (each audited run's
        trace is read exactly once)."""
        key = str(run_dir)
        if key not in self._run_traces:
            self._run_traces[key] = RunTrace(key)
        return self._run_traces[key]

    def coordinator_trace(self):
        """The coordinator's own trace (dispatch spans, lease
        instants, chaos injections): the campaign directory's
        trace.jsonl or its crash journal."""
        return self.run_trace(self.dir)

    def chaos_fault_counts(self):
        """{kind: count} of ``chaos.fault`` instants in the
        coordinator trace (kind = execute / download / upload)."""
        out = {}
        for ev in self.coordinator_trace().events:
            if ev.get("ph") == "i" and ev.get("name") == "chaos.fault":
                kind = str((ev.get("args") or {}).get("kind"))
                out[kind] = out.get(kind, 0) + 1
        return out
