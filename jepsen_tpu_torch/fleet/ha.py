"""Coordinator HA, its journal half: the coordinator role as a leased,
failover-able identity carried through the campaign journal (the
port's copy of ``jepsen_tpu/fleet/ha.py``, in part).

In the JAX package the active fleet coordinator periodically appends a
``{"event": "coordinator-lease", "epoch": N}`` record to
``cells.jsonl``; a standby that sees the lease expire appends a
``{"event": "coordinator-takeover", "epoch": N+1, "prev-epoch": N}``
record naming the expired predecessor, and the FIRST takeover record
claiming a given predecessor epoch wins. Every record is stamped with
the journal's ``writer: host:pid`` identity, so the fleetlint
single-writer oracle (FL004) and the chain audit (FL016) can replay the
whole handoff from the journal alone.

The port has the half that reads and writes those records, because the
campaign scheduler (``--resume`` refuses an HA journal) and the
control-plane audit (``analysis/fleetmodel.py``) need it: the
constants, ``last_lease``, ``coordinator_state``, ``current_epoch``,
``fence`` and ``takeover_marker``. ``CoordinatorLease`` (the renewing
side) and ``Standby`` (the tailing side) have one caller, the fleet
dispatcher, and come with it (ROADMAP.md A.11(d3)); until then they
raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import itertools
import logging
import os

from .. import store
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
    """The ACTIVE coordinator's side of the role lease (renew the
    journaled coordinator-lease on a heartbeat, discover fencing). Its
    only caller is the fleet dispatcher: ROADMAP.md A.11(d3) ports both
    together."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "fleet.ha.CoordinatorLease is not ported yet: ROADMAP.md "
            "A.11(d3) (it comes with the fleet dispatcher)")


class Standby:
    """The PASSIVE side: tail one campaign's journal read-only and fence
    the coordinator once its lease goes stale. Its only caller is the
    fleet path (``campaign --standby``): ROADMAP.md A.11(d3)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "fleet.ha.Standby is not ported yet: ROADMAP.md A.11(d3) "
            "(it comes with the fleet dispatcher)")


def takeover_marker(campaign_id):
    """Path of the chaos coordinator-kill die-once marker (shared by
    dispatch and the bench rung)."""
    return os.path.abspath(
        store.campaign_path(campaign_id, "chaos-coordinator-kill"))
