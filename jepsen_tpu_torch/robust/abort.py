"""The graceful-abort protocol: a latch the whole harness can watch.

An `AbortLatch` is a one-way boolean with a reason. `core.run` parks
one on ``test["abort"]`` and wraps the run in `signal_scope`, so
SIGINT/SIGTERM flip the latch instead of tearing the process down
mid-history. The interpreter polls the latch at the generator
boundary: no *new* ops are invoked once it fires, outstanding ops get
``test["abort-grace-s"]`` seconds to drain, and the partial history
flows out the normal return path -- persisted, checked, and marked
``salvaged`` instead of discarded.

A second signal means "you heard me": the handler raises
KeyboardInterrupt in the main thread, abandoning the drain. Even then
the incremental store journal and `core.run`'s salvage path keep the
history-so-far on disk.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading

logger = logging.getLogger(__name__)

__all__ = ["AbortLatch", "ChainedLatch", "signal_scope"]


class AbortLatch:
    """One-way abort flag with a first-wins reason and a signal count
    (the count is what distinguishes graceful from hard abort).

    Signal-handler safe by construction: ``set``/``note_signal`` run
    inside signal handlers, which execute on the main thread and can
    interrupt it *inside* one of this class's own critical sections --
    so the internal lock is an RLock, and nothing here touches
    non-reentrant locks (in particular no obs calls: the interpreter
    counts the abort when it observes the latch)."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.RLock()
        self._reason = None
        self._signals = 0

    def set(self, reason="abort"):
        with self._lock:
            if self._reason is None:
                self._reason = str(reason)
        self._event.set()

    def is_set(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        return self._event.wait(timeout)

    @property
    def reason(self):
        with self._lock:
            return self._reason

    def note_signal(self):
        """Count a delivered abort signal; returns the running total."""
        with self._lock:
            self._signals += 1
            return self._signals


class ChainedLatch(AbortLatch):
    """A per-run latch layered over a shared parent latch.

    The streaming monitor must be able to abort ITS run without
    touching anyone else's: in a campaign every cell shares one
    `AbortLatch` (SIGINT stops the fleet), so a monitor flipping that
    shared latch on one cell's violation would tear down every
    sibling. A ChainedLatch reports set when EITHER it or its parent
    fired, with the own reason winning (a monitor violation is more
    specific than a concurrent fleet-wide SIGINT), so the interpreter
    polls one object and both abort sources work.

    Signal-safety is inherited: set/note_signal only touch this
    latch's own RLock; the parent is only ever *read*."""

    def __init__(self, parent=None):
        super().__init__()
        self.parent = parent

    def is_set(self):
        return super().is_set() or (self.parent is not None
                                    and self.parent.is_set())

    @property
    def reason(self):
        own = AbortLatch.reason.fget(self)
        if own is not None:
            return own
        return self.parent.reason if self.parent is not None else None

    def wait(self, timeout=None):
        """Poll-wait across both latches (the own event can't see the
        parent fire). Slices are short; callers of wait() are never on
        a hot path."""
        if self.parent is None:
            return self._event.wait(timeout)
        import time as _time
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        while True:
            if self.is_set():
                return True
            left = None if deadline is None \
                else deadline - _time.monotonic()
            if left is not None and left <= 0:
                return False
            self._event.wait(min(0.05, left) if left is not None
                             else 0.05)


@contextlib.contextmanager
def signal_scope(latch, signals=(signal.SIGINT, signal.SIGTERM)):
    """Route SIGINT/SIGTERM into ``latch`` for the duration.

    First signal: flip the latch (graceful abort -- the interpreter
    drains and returns the partial history). Second signal: raise
    KeyboardInterrupt from the handler, hard-aborting the drain.
    Previous handlers are restored on exit. Off the main thread (or on
    platforms refusing handler installation) this is a no-op scope:
    the latch still works, it just has no signal wiring."""
    if threading.current_thread() is not threading.main_thread():
        yield latch
        return

    def handler(signum, frame):
        name = signal.Signals(signum).name
        if latch.note_signal() == 1:
            logger.warning("Caught %s: aborting gracefully -- draining "
                           "outstanding ops, salvaging history (signal "
                           "again to hard-abort)", name)
            latch.set(name)
        else:
            logger.warning("Caught second %s: hard abort", name)
            raise KeyboardInterrupt(f"hard abort ({name})")

    prev = {}
    for s in signals:
        try:
            prev[s] = signal.signal(s, handler)
        except (ValueError, OSError):  # non-main interpreter, exotic os
            pass
    try:
        yield latch
    finally:
        for s, h in prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):  # pragma: no cover
                pass
