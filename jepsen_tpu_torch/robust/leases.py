"""Leases: bounded ownership of a unit of work, with an expiry
watchdog.

The JAX package's fleet dispatcher (fleet.dispatch) leases campaign cells
to remote workers. The PRIMARY liveness bound is the transport itself
-- every remote exec carries a subprocess timeout -- but a transport
can wedge past its own deadline (an ssh whose control connection hangs
in an uninterruptible read), and then the cell it carried would be
stuck forever. The `LeaseTable` + `LeaseWatchdog` pair is the backstop
with the same shape as the wedged-worker watchdog (watchdog.py): a
monitor thread notices leases past their deadline and hands them to an
``on_expiry`` callback, which re-queues the cell for another worker
(work stealing) while the wedged holder's eventual result is dropped
by the caller's terminal-guard.

Everything is monotonic-clock based (wall-clock steps under a time
nemesis must not expire leases) and thread-safe; the watchdog fires
each lease's expiry exactly once.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

logger = logging.getLogger(__name__)

__all__ = ["Lease", "LeaseTable", "LeaseWatchdog", "HeartbeatLoop"]


@dataclasses.dataclass
class Lease:
    """One grant: ``unit`` (e.g. a cell id) held by ``holder`` until
    ``deadline`` (monotonic seconds)."""

    unit: str
    holder: str
    ttl_s: float
    granted: float
    deadline: float
    attempt: int = 1

    def remaining(self, now=None):
        return self.deadline - (time.monotonic() if now is None else now)


class LeaseTable:
    """Current grants, one per unit. Granting a unit again (a steal
    after expiry, or a retry) replaces the previous lease; the old
    holder's release becomes a no-op, so a wedged worker coming back
    late cannot release the thief's lease out from under it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._leases = {}
        self._attempts = {}

    def grant(self, unit, holder, ttl_s):
        now = time.monotonic()
        with self._lock:
            attempt = self._attempts.get(unit, 0) + 1
            self._attempts[unit] = attempt
            lease = Lease(unit=str(unit), holder=str(holder),
                          ttl_s=float(ttl_s), granted=now,
                          deadline=now + float(ttl_s), attempt=attempt)
            self._leases[unit] = lease
            return lease

    def extend(self, lease, ttl_s):
        """Push a lease's deadline to ``now + ttl_s`` IF it is still
        the current grant (returns whether it was). The fleet
        dispatcher extends a lease while it syncs the worker's run
        artifacts: the worker already finished, but the watchdog must
        not steal the cell out from under a slow download."""
        now = time.monotonic()
        with self._lock:
            if self._leases.get(lease.unit) is lease:
                lease.deadline = now + float(ttl_s)
                lease.ttl_s = float(ttl_s)
                return True
            return False

    def release(self, lease):
        """Drop a lease IF it is still the current grant for its unit
        (returns whether it was)."""
        with self._lock:
            if self._leases.get(lease.unit) is lease:
                del self._leases[lease.unit]
                return True
            return False

    def holder(self, unit):
        with self._lock:
            lease = self._leases.get(unit)
            return lease.holder if lease else None

    def attempts(self, unit):
        with self._lock:
            return self._attempts.get(unit, 0)

    def active(self):
        with self._lock:
            return list(self._leases.values())

    def expired(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return [lease for lease in self._leases.values()
                    if lease.deadline <= now]


class HeartbeatLoop:
    """Periodic heartbeat thread: calls ``beat()`` every
    ``interval_s`` until stopped or until ``beat`` returns False (the
    holder discovered it lost whatever role the heartbeat renews).
    The inverse of `LeaseWatchdog`: the watchdog watches OTHERS'
    leases expire; this keeps the caller's own lease alive. The fleet
    coordinator's HA role (fleet.ha.CoordinatorLease) renews its
    journaled coordinator-lease through one of these.

    ``beat`` exceptions are contained per tick -- a transient journal
    write failure must not kill the renewal loop whose silence would
    trigger a takeover -- but ``on_stop`` (if given) fires exactly
    once when the loop exits for any reason besides ``stop()``."""

    def __init__(self, beat, interval_s, name="jepsen heartbeat",
                 on_stop=None):
        self.beat = beat
        self.interval_s = float(interval_s)
        self.name = str(name)
        self.on_stop = on_stop
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                alive = self.beat()
            except Exception:  # noqa: BLE001 - contained per tick
                logger.warning("heartbeat %r: beat crashed (contained)",
                               self.name, exc_info=True)
                continue
            if alive is False:
                if self.on_stop is not None and not self._stop.is_set():
                    try:
                        self.on_stop()
                    except Exception:  # noqa: BLE001 - contained
                        logger.warning("heartbeat %r: on_stop crashed",
                                       self.name, exc_info=True)
                return

    def stop(self, join_s=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_s)


class LeaseWatchdog:
    """Monitor thread firing ``on_expiry(lease)`` once per expired
    lease. The expired lease is removed from the table before the
    callback runs (the callback typically re-grants), and callback
    exceptions are contained -- a buggy steal must not kill the
    watchdog that every other cell depends on."""

    def __init__(self, table, on_expiry, poll_s=1.0):
        self.table = table
        self.on_expiry = on_expiry
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="jepsen lease watchdog")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.poll_s):
            for lease in self.table.expired():
                if not self.table.release(lease):
                    continue       # already stolen/released underfoot
                try:
                    from .. import obs
                    obs.inc("robust.lease_expired")
                except Exception:  # noqa: BLE001 - telemetry only
                    pass
                logger.warning(
                    "lease on %r held by %r expired after %.1fs "
                    "(attempt %d)", lease.unit, lease.holder,
                    lease.ttl_s, lease.attempt)
                try:
                    self.on_expiry(lease)
                except Exception:  # noqa: BLE001 - contained per lease
                    logger.warning("lease-expiry callback failed for "
                                   "%r", lease.unit, exc_info=True)

    def stop(self, join_s=5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_s)
