"""Harness fault tolerance: the crash-only core that keeps Jepsen
producing a verdict while its *own* machinery misbehaves.

Jepsen's subject is allowed to wedge, stall, and die -- the harness is
not. This package holds the pieces that enforce that asymmetry:

* :mod:`.retry` -- one exponential-backoff/jitter/elapsed-budget policy
  (`RetryPolicy`) shared by every retry loop in the framework
  (`control.remotes.RetryRemote`, `db.cycle`), instead of each call
  site hand-rolling its own sleep constants.
* :mod:`.abort` -- the graceful-abort protocol: an `AbortLatch` flipped
  by SIGINT/SIGTERM (`signal_scope`) or a hard `test["time-limit-s"]`
  deadline. The interpreter stops new invocations at the generator
  boundary, drains outstanding ops for a grace period, and returns the
  partial history; a second signal hard-aborts.
* :mod:`.leases` -- bounded work ownership: a `LeaseTable` of
  per-unit grants plus a `LeaseWatchdog` monitor thread that hands
  expired leases to a steal callback. The fleet dispatcher
  (fleet.dispatch) uses it as the backstop behind its per-exec
  transport timeouts, so a wedged ssh cannot strand a campaign cell.
* :mod:`.watchdog` -- the wedged-worker watchdog: a monitor thread
  enforcing `test["op-timeout-ms"]` per dispatched op. On expiry the
  op completes as ``:info`` with ``error="harness-timeout"``, the
  wedged worker is retired to a zombie pool (bounded joins, leaks
  counted via obs), and a replacement worker keeps the test running.

The third leg, partial-history salvage, lives where the data lives:
`interpreter` exposes the history-so-far on ``test["partial-history"]``,
`store.HistoryJournal` appends each op to an on-disk journal as it
happens (so even SIGKILL leaves ``history.jsonl.journal`` readable),
and `core.run` recovers, persists, and *checks* the prefix with
``results["salvaged"] = True`` on any abort.

Everything here defaults to off (no ``op-timeout-ms`` -> no watchdog
thread; no signal -> the latch never fires) so reference semantics are
preserved byte-for-byte on the happy path.
"""

from __future__ import annotations

from .abort import AbortLatch, ChainedLatch, signal_scope
from .leases import HeartbeatLoop, Lease, LeaseTable, LeaseWatchdog
from .retry import RetryPolicy
from .watchdog import OpWatchdog, WATCHDOG_FIRED

__all__ = ["AbortLatch", "ChainedLatch", "signal_scope", "RetryPolicy",
           "OpWatchdog", "WATCHDOG_FIRED", "Lease", "LeaseTable",
           "LeaseWatchdog", "HeartbeatLoop"]
