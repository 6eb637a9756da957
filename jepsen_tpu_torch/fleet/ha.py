"""Coordinator HA: the coordinator role as a leased, failover-able
identity carried through the campaign journal (the port's copy of
``jepsen_tpu/fleet/ha.py``; host-only).

The fleet already survives every fault it injects at WORKERS (dead
processes, wedged transports, torn syncs) because worker ownership is
a journaled lease. The coordinator itself is the last single point of
failure: kill it and the campaign is dead until a human runs
``--resume``. This module closes that by making the coordinator role
just another lease, recoverable from the artifacts the system already
writes:

* **The active coordinator** periodically appends a
  ``{"event": "coordinator-lease", "epoch": N}`` record to
  ``cells.jsonl`` (`CoordinatorLease`, renewing through
  ``robust.HeartbeatLoop``). The record is stamped with the journal's
  ``writer: host:pid`` identity like every other append, so the
  fleetlint single-writer oracle (FL004) and the chain audit (FL016)
  can replay the whole handoff from the journal alone.
* **Standbys** (`Standby`; ``campaign --standby``, or a second host
  pointed at a shared/synced store) tail the journal READ-ONLY and
  detect lease expiry. Detection is *arrival*-based, not stamp-based:
  the standby times, on its own monotonic clock, how long the journal
  has gone without growing -- so a coordinator whose wall clock is
  hours behind (stale-looking stamps) is never falsely fenced while
  its renewals keep landing. The wall-clock stamps are only consulted
  as a second condition, adjusted by the observed future-skew bound
  (records stamped ahead of the standby's clock prove the
  coordinator's clock runs ahead by at least that much), so a dead
  coordinator with an AHEAD clock is still detected.
* **Fencing.** On expiry the standby appends a
  ``{"event": "coordinator-takeover", "epoch": N+1, "prev-epoch": N}``
  record naming the expired predecessor lease and writer. Appends are
  line-atomic, so when two standbys race, the journal itself
  serializes them: the FIRST takeover record claiming a given
  predecessor epoch wins (`coordinator_state`), the loser recognizes
  on re-read that the winning record's unique ``fence-id`` is not its
  own (writer identity alone cannot distinguish two standbys sharing
  one process) and goes back to tailing. The winner then resumes the
  campaign through the fleet's ``--resume`` path (which tolerates torn
  tails, re-syncs artifacts from workers no longer in the fleet list,
  and skips terminal cells).
* **Zombie fencing.** Every journal append by an HA coordinator is
  stamped with its epoch (CampaignJournal.epoch), every cell spec
  carries ``coordinator-epoch``, and the dispatcher's terminal-guard
  re-checks the journal before appending an outcome: a superseded
  coordinator coming back from a pause finds the takeover record,
  refuses its own late appends, and aborts. The un-closable race --
  a stale append landing in the instant between the takeover record
  and the zombie's next check -- is exactly what FL016 proves post
  hoc from the epoch stamps.

The ``coordinator-kill`` chaos fault (fleet.chaos) SIGKILLs the
active coordinator right after a seeded lease grant, and a standby
completes the campaign with exactly one terminal record per cell and
a clean FL004/FL007/FL016 audit (``tests/test_torch_fleet_ha.py``).
The campaign scheduler's ``--resume`` refuses an HA journal and points
at this fleet path, as the reference's does.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time

from .. import robust, store
from ..campaign.journal import CampaignJournal

logger = logging.getLogger(__name__)

__all__ = ["LEASE_EVENT", "TAKEOVER_EVENT",
           "DEFAULT_COORDINATOR_LEASE_S", "DEFAULT_TAKEOVER_GRACE_S",
           "RENEW_FRACTION", "coordinator_state", "current_epoch",
           "last_lease", "fence", "CoordinatorLease", "Standby"]

LEASE_EVENT = "coordinator-lease"
TAKEOVER_EVENT = "coordinator-takeover"

#: default coordinator-lease TTL (seconds): how long the journal may
#: go quiet before standbys may fence. Deliberately much shorter than
#: the cell lease -- coordinator renewals are cheap appends, cells are
#: whole test runs
DEFAULT_COORDINATOR_LEASE_S = 15.0

#: extra quiet time a standby waits past the lease TTL before fencing
DEFAULT_TAKEOVER_GRACE_S = 5.0

#: the active coordinator renews every ``lease_s / RENEW_FRACTION``
#: seconds, so a single dropped renewal never looks like death
RENEW_FRACTION = 3.0

#: per-process fence-attempt sequence: combined with the journal's
#: ``writer`` (host:pid) it makes every takeover record's ``fence-id``
#: globally unique, so a fence can recognize its OWN record on re-read
#: even when two standbys share a process identity (threads)
_FENCE_SEQ = itertools.count()


def _as_int(v):
    return int(v) if isinstance(v, int) and not isinstance(v, bool) \
        else None


def last_lease(records):
    """The newest coordinator-lease record, or None (pre-HA journal)."""
    for rec in reversed(list(records or [])):
        if rec.get("event") == LEASE_EVENT:
            return rec
    return None


def coordinator_state(records):
    """Fold the journal's HA events into the authoritative
    ``(epoch, writer)`` pair -- ``(0, None)`` for a pre-HA journal.

    Epoch claims are monotone: a coordinator-lease only establishes a
    NEW epoch (renewals and zombie re-claims of an old epoch change
    nothing), and the FIRST takeover record claiming a given
    predecessor epoch wins -- later records for the same predecessor
    are losing fence attempts from a standby race, benign as long as
    the loser stands down (FL016 checks that it did)."""
    epoch, writer = 0, None
    taken = set()
    for rec in records or []:
        ev = rec.get("event")
        if ev == LEASE_EVENT:
            e = _as_int(rec.get("epoch"))
            if e is not None and e > epoch:
                epoch, writer = e, rec.get("writer")
        elif ev == TAKEOVER_EVENT:
            prev = _as_int(rec.get("prev-epoch"))
            if prev is not None and prev in taken:
                continue            # a losing fence attempt
            e = _as_int(rec.get("epoch"))
            if e is not None and e > epoch:
                if prev is not None:
                    taken.add(prev)
                epoch, writer = e, rec.get("writer")
    return epoch, writer


def current_epoch(records):
    """The journal's current coordinator epoch (0 = pre-HA)."""
    return coordinator_state(records)[0]


def fence(journal, reason="lease-expired", forced=False,
          skew_allowance_s=None, expect_epoch=None):
    """Fence the current coordinator: append a takeover record naming
    the expired predecessor lease, then re-read the journal to learn
    whether WE won the race. Returns the new epoch on a win, None when
    another standby's takeover landed first.

    ``expect_epoch`` is the compare-and-swap guard: the epoch the
    caller OBSERVED to be expired. If the journal has moved past it by
    the time we re-read (a rival's takeover landed in the window
    between our expiry verdict and our fence), we must NOT fence the
    new, live coordinator -- return None and go back to tailing.

    ``forced`` marks an operator-driven fence (a manual ``--resume``
    of an HA campaign): the kill is out-of-band evidence, so FL016
    skips the stamp-based expiry requirement for it."""
    jr = journal if isinstance(journal, CampaignJournal) \
        else CampaignJournal(journal)
    records = jr.records()
    prev_epoch, prev_writer = coordinator_state(records)
    if expect_epoch is not None and prev_epoch != expect_epoch:
        logger.warning(
            "coordinator takeover abandoned: observed epoch %d "
            "expired but the journal is at epoch %d (%r) now",
            expect_epoch, prev_epoch, prev_writer)
        return None
    lease = last_lease(records)
    epoch = prev_epoch + 1
    rec = {"event": TAKEOVER_EVENT, "epoch": epoch,
           "prev-epoch": prev_epoch, "prev-writer": prev_writer,
           "reason": str(reason), "t": store.local_time(),
           "fence-id": f"{jr.writer}#{next(_FENCE_SEQ)}"}
    if lease is not None:
        rec["prev-lease-t"] = lease.get("t")
        if lease.get("lease-s") is not None:
            rec["lease-s"] = lease.get("lease-s")
    if forced:
        rec["forced"] = True
    if skew_allowance_s is not None:
        rec["skew-allowance-s"] = round(float(skew_allowance_s), 3)
    jr.append_event(rec)
    # The journal's line-atomic appends serialized the race: the FIRST
    # takeover record claiming our predecessor epoch is the winner the
    # fold credits (coordinator_state's ``taken`` set). Match it by
    # fence-id, not writer -- two standbys in one process share the
    # host:pid writer identity, and the fence must still stand down.
    for got in jr.records():
        if got.get("event") == TAKEOVER_EVENT \
                and _as_int(got.get("prev-epoch")) == prev_epoch:
            if got.get("fence-id") == rec["fence-id"]:
                logger.warning("coordinator takeover: epoch %d -> %d "
                               "(fenced %r, %s)", prev_epoch, epoch,
                               prev_writer, reason)
                return epoch
            logger.warning("coordinator takeover lost: %r won epoch %s",
                           got.get("writer"), got.get("epoch"))
            return None
    return None  # append did not land (unreachable with a sane journal)


class CoordinatorLease:
    """The ACTIVE coordinator's side of the role lease: renew the
    journaled coordinator-lease on a heartbeat, and discover fencing.

    Each renewal first re-reads the journal: a takeover record with a
    higher epoch (or this epoch under a foreign writer -- a lost
    standby race) flips the fenced flag, stops renewing, and fires
    ``on_fenced`` exactly once, which the dispatcher wires to its
    abort latch. ``fenced(refresh=True)`` is the terminal-guard's
    check: re-read the journal at the last possible moment before an
    outcome append."""

    def __init__(self, journal, *, lease_s=DEFAULT_COORDINATOR_LEASE_S,
                 epoch=1, renew_s=None, on_fenced=None, registry=None,
                 tracer=None):
        self.jr = journal
        self.lease_s = float(lease_s)
        self.epoch = int(epoch)
        self.renew_s = float(renew_s) if renew_s is not None \
            else max(self.lease_s / RENEW_FRACTION, 0.2)
        self.on_fenced = on_fenced
        self.registry = registry
        self.tracer = tracer
        self._fenced = threading.Event()
        self._fenced_by = None
        self._notified = False
        self._lock = threading.Lock()
        self._loop = None

    @property
    def fenced_by(self):
        """The ``(epoch, writer)`` that superseded us, or None."""
        return self._fenced_by

    def fenced(self, refresh=False):
        """Whether this coordinator's epoch has been superseded.
        ``refresh`` re-reads the journal (the terminal-guard path);
        without it only the cached flag (updated every renewal) is
        consulted."""
        if self._fenced.is_set():
            return True
        if refresh:
            self._check(coordinator_state(self.jr.records()))
        return self._fenced.is_set()

    def _check(self, state):
        epoch, writer = state
        if epoch > self.epoch or (epoch == self.epoch
                                  and writer not in (None,
                                                     self.jr.writer)):
            with self._lock:
                first = not self._fenced.is_set()
                self._fenced.set()
                self._fenced_by = (epoch, writer)
                notify = first and not self._notified
                if notify:
                    self._notified = True
            if notify:
                logger.warning(
                    "coordinator epoch %d fenced: epoch %d held by %r "
                    "took over", self.epoch, epoch, writer)
                if self.registry is not None:
                    try:
                        self.registry.inc("fleet.coordinator_fenced")
                    except Exception:  # noqa: BLE001 - telemetry only
                        pass
                if self.on_fenced is not None:
                    try:
                        self.on_fenced((epoch, writer))
                    except Exception:  # noqa: BLE001 - contained
                        logger.warning("on_fenced callback crashed",
                                       exc_info=True)

    def renew(self):
        """One heartbeat: re-check the journal, then append the lease
        renewal. Returns False once fenced (the loop's stop signal)."""
        if self.fenced(refresh=True):
            return False
        self.jr.append_event({"event": LEASE_EVENT, "epoch": self.epoch,
                              "lease-s": self.lease_s,
                              "t": store.local_time()})
        if self.registry is not None:
            try:
                self.registry.inc("fleet.coordinator_renewals")
                self.registry.set_gauge("fleet.coordinator_epoch",
                                        self.epoch)
            except Exception:  # noqa: BLE001 - telemetry only
                pass
        return True

    def start(self):
        """Append the claiming renewal synchronously (the journal must
        carry the epoch before any cell lease does), then heartbeat."""
        self.renew()
        self._loop = robust.HeartbeatLoop(
            self.renew, self.renew_s,
            name=f"jepsen coordinator-lease {self.jr.campaign_id}")
        self._loop.start()
        return self

    def stop(self, join_s=5.0):
        if self._loop is not None:
            self._loop.stop(join_s=join_s)


class Standby:
    """The PASSIVE side: tail one campaign's journal read-only, fence
    the coordinator once its lease goes stale, report who won.

    Expiry requires BOTH conditions:

    * **arrival**: the journal has not grown for ``lease_s + grace_s``
      on the standby's own monotonic clock (skew-immune -- a live
      coordinator's renewals keep arriving whatever its wall clock
      says); and
    * **stamps**: the newest coordinator-lease stamp is older than
      ``lease_s + grace_s`` of wall clock, after crediting the
      observed future-skew bound (the largest amount by which any
      record's stamp ran ahead of this process's clock at observation
      time -- a one-sided coordinator-clock-offset estimate in the
      same spirit as the worker clock handshake).

    A campaign whose journal carries no coordinator-lease records
    (HA off) is never fenced -- the standby just waits for its
    meta to finalize."""

    def __init__(self, campaign_id, *, lease_s=None, grace_s=None,
                 poll_s=0.5):
        self.campaign_id = str(campaign_id)
        self._lease_s = lease_s
        self.grace_s = float(grace_s) if grace_s is not None \
            else DEFAULT_TAKEOVER_GRACE_S
        self.poll_s = float(poll_s)
        self._seen = None           # (record_count, last_raw_tail)
        self._last_change = None    # monotonic stamp of last growth
        self._skew_bound = 0.0      # max observed stamp-minus-wall
        self._observed_epoch = 0    # epoch fold at the last poll

    # -- store reads (all read-only) ------------------------------------

    def _meta(self):
        try:
            with open(store.campaign_path(self.campaign_id,
                                          "campaign.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _records(self):
        try:
            return store.load_campaign_records(self.campaign_id)
        except OSError:
            return []

    def lease_s(self, meta=None, lease=None):
        """The coordinator-lease TTL to judge expiry by: explicit
        knob, else the campaign meta's, else the newest lease
        record's own ``lease-s``, else the default."""
        if self._lease_s is not None:
            return float(self._lease_s)
        v = ((meta or {}).get("coordinator-lease-s"))
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        v = (lease or {}).get("lease-s")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        return DEFAULT_COORDINATOR_LEASE_S

    # -- the tail loop --------------------------------------------------

    def poll(self):
        """One observation: returns ``"complete"`` (campaign
        finalized; stand down), ``"expired"`` (fence now), or None
        (keep tailing)."""
        from ..analysis.fleetmodel import parse_t
        meta = self._meta()
        if meta is not None and meta.get("status") in ("complete",
                                                       "aborted"):
            return "complete"
        records = self._records()
        now = time.monotonic()
        wall = time.time()
        fingerprint = (len(records),
                       json.dumps(records[-1], sort_keys=True,
                                  default=str) if records else None)
        if self._seen != fingerprint:
            # the journal moved: the coordinator is alive. Fold the
            # newest stamps into the future-skew bound while we're
            # looking at them
            self._seen = fingerprint
            self._last_change = now
            for rec in records[-5:]:
                t = parse_t(rec.get("t"))
                if t is not None:
                    self._skew_bound = max(self._skew_bound, t - wall)
        lease = last_lease(records)
        self._observed_epoch = current_epoch(records)
        if lease is None:
            return None             # HA off (or not started yet)
        bound = self.lease_s(meta, lease) + self.grace_s
        if self._last_change is None or now - self._last_change < bound:
            return None             # arrival condition not met
        t = parse_t(lease.get("t"))
        if t is not None and (wall - t) + self._skew_bound <= bound:
            return None             # stamps say the lease may be live
        return "expired"

    def fence(self, reason="lease-expired"):
        """Append our takeover record; returns the won epoch or None
        (another standby won, or the journal moved past the epoch we
        judged expired -- go back to tailing either way)."""
        return fence(CampaignJournal(self.campaign_id), reason=reason,
                     skew_allowance_s=self._skew_bound,
                     expect_epoch=self._observed_epoch or None)

    def wait(self, timeout_s=None, sleep=time.sleep):
        """Tail until takeover or completion. Returns ``("takeover",
        epoch)``, ``("complete", None)``, or ``("timeout", None)``.
        A lost fence race resets the tail (the winner's records are
        arriving); a won one hands the campaign to the caller, who
        resumes it via the normal ``--resume`` path with
        ``ha_epoch=epoch``."""
        t0 = time.monotonic()
        while True:
            status = self.poll()
            if status == "complete":
                return ("complete", None)
            if status == "expired":
                epoch = self.fence()
                if epoch is not None:
                    return ("takeover", epoch)
            if timeout_s is not None \
                    and time.monotonic() - t0 >= timeout_s:
                return ("timeout", None)
            sleep(self.poll_s)


def takeover_marker(campaign_id):
    """Path of the chaos coordinator-kill die-once marker (shared by
    dispatch and the bench rung)."""
    return os.path.abspath(
        store.campaign_path(campaign_id, "chaos-coordinator-kill"))
