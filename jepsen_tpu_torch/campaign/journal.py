"""Resumable campaign state on disk (the port's copy of
``jepsen_tpu/campaign/journal.py``, host-only; the two packages read
and write the same layout).

Layout (under ``store/campaigns/<campaign-id>/``, see store.py):

* ``campaign.json`` -- the campaign's identity: id, planned cell ids,
  scheduling knobs, created/updated stamps, status. Written atomically
  (tmp + rename) at start and finalize.
* ``cells.jsonl`` -- the outcome journal: one JSON line per finished
  cell, appended and flushed the moment the cell completes (the same
  crash-only discipline as store.HistoryJournal), so SIGKILL loses at
  most the line being written. A torn final line is dropped on read.
* ``report.json`` -- the aggregated report (report.py), written when
  the campaign finishes or aborts.

Resume contract: a cell is *completed* when its latest journal record
has any outcome other than ``"aborted"`` (an aborted cell's history
was salvaged, but the cell never got its full run, so ``--resume``
executes it again). Cells with no record never started. The journal is
integrated with ``robust.AbortLatch`` by the scheduler: a latched
abort stops new cells, records in-flight cells as aborted, and leaves
everything here ready for ``--resume``.
"""

from __future__ import annotations

import json
import os
import socket
import threading

from .. import store

__all__ = ["CampaignJournal", "writer_id"]

META_FILE = "campaign.json"
CELLS_FILE = "cells.jsonl"
REPORT_FILE = "report.json"


def writer_id():
    """THIS process's journal-writer identity (``host:pid``). Every
    appended record is stamped with it, which is what lets the
    fleetlint auditor prove the single-writer invariant from the
    journal alone: two coordinators appending concurrently leave
    interleaved writer identities (FL004) -- the oracle the
    coordinator-HA handoff is soaked against. A resumed campaign
    legitimately has a NEW writer; its records form a contiguous run."""
    return f"{socket.gethostname()}:{os.getpid()}"


class CampaignJournal:
    """Owner of one campaign's on-disk state."""

    def __init__(self, campaign_id):
        assert campaign_id, "campaign needs an id"
        self.campaign_id = str(campaign_id)
        self.dir = store.campaign_path(self.campaign_id)
        os.makedirs(self.dir, exist_ok=True)
        self.writer = writer_id()
        #: coordinator epoch (fleet.ha): when set, every appended
        #: record is stamped with it so the FL016 chain audit can
        #: prove post hoc that no fenced (pre-takeover) coordinator's
        #: append slipped in after the takeover record
        self.epoch = None
        self._lock = threading.Lock()

    # -- paths ----------------------------------------------------------

    @property
    def meta_path(self):
        return os.path.join(self.dir, META_FILE)

    @property
    def cells_path(self):
        return os.path.join(self.dir, CELLS_FILE)

    @property
    def report_path(self):
        return os.path.join(self.dir, REPORT_FILE)

    # -- campaign.json --------------------------------------------------

    def write_meta(self, meta):
        """Atomically persist campaign.json (tmp + rename: a campaign
        killed mid-write keeps the previous consistent copy)."""
        store._dump_json(dict(meta, id=self.campaign_id),
                         self.meta_path)

    def load_meta(self):
        """The campaign.json dict, or None when this campaign was
        never started."""
        try:
            with open(self.meta_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    # -- cells.jsonl ----------------------------------------------------

    def append_cell(self, record):
        """Append one finished cell's record and flush+fsync: the
        journal must survive whatever kills the process next.

        If the previous process died MID-append the file ends in a torn
        line without a newline; appending straight onto it would merge
        this record into the fragment and corrupt both, so the torn
        tail is terminated first (the read path skips the fragment)."""
        assert not record.get("event"), \
            "outcome records must not carry an 'event' key"
        self._append_line(record)

    def append_event(self, record):
        """Append one bookkeeping event (the fleet's lease grants and failures,
        ROADMAP.md A.11(d3)):
        same crash-only discipline as outcomes, but the record carries
        an ``"event"`` key so the latest-per-cell outcome fold
        (store.latest_campaign_records) skips it -- the journal stays
        the single source of truth for BOTH who holds a cell and what
        finally happened to it."""
        assert record.get("event"), "event records need an 'event' key"
        self._append_line(record)

    def _append_line(self, record):
        # stamp the writer identity unless the caller already chose one
        # (golden-journal test fixtures forge foreign writers on
        # purpose); setdefault on a copy -- the caller's dict is theirs
        record = dict(record)
        record.setdefault("writer", self.writer)
        if self.epoch is not None:
            record.setdefault("epoch", self.epoch)
        line = json.dumps(record, cls=store._Encoder)
        with self._lock:
            torn = False
            try:
                with open(self.cells_path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    torn = f.read(1) != b"\n"
            except (FileNotFoundError, OSError):
                pass        # absent or empty: nothing to terminate
            with open(self.cells_path, "a") as f:
                if torn:
                    f.write("\n")
                f.write(line + "\n")
                f.flush()
                try:
                    os.fsync(f.fileno())
                except OSError:  # pragma: no cover - exotic fs
                    pass

    def records(self):
        """All journal records in append order (outcomes AND events); a
        torn final line (killed mid-append) is dropped rather than
        fatal."""
        return store.load_campaign_records(self.campaign_id)

    def events(self):
        """Bookkeeping event records only (store's shared filter)."""
        return store.campaign_events(self.campaign_id)

    def latest(self):
        """One record per cell, latest wins (store's shared fold)."""
        return store.latest_campaign_records(self.campaign_id)

    def completed(self):
        """{cell_id: record} for cells whose latest record is terminal
        (anything but "aborted") -- the set ``--resume`` skips."""
        return {rec.get("cell"): rec for rec in self.latest()
                if rec.get("outcome") != "aborted"}

    # -- report.json ----------------------------------------------------

    def write_report(self, report):
        store._dump_json(report, self.report_path)

    def load_report(self):
        try:
            with open(self.report_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
