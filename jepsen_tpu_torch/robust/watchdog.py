"""The wedged-worker watchdog: per-op deadlines for interpreter workers.

A Jepsen client is *supposed* to time out its own network calls, but a
buggy client (or a driver stuck in C) can block forever inside
``invoke`` -- and the reference interpreter then wedges with it: the
event loop joins the worker without a timeout and the whole run hangs
past every CI budget. The watchdog restores the crash-only property:

* the interpreter ``arm()``s a (thread, serial, op) entry when it
  dispatches an op and ``disarm()``s it on completion;
* a single monitor thread sleeps until the nearest deadline and, on
  expiry, puts a `WATCHDOG_FIRED` sentinel on the interpreter's
  completion queue;
* the interpreter (the only mutator of worker state) retires the
  wedged worker to a zombie pool, synthesizes an ``:info`` completion
  with ``error="harness-timeout"``, and spawns a replacement worker so
  the successor process keeps the test running.

The firing is advisory -- the interpreter re-checks the serial against
its own bookkeeping, so a completion racing the deadline wins and the
sentinel is ignored. Off by default: no ``test["op-timeout-ms"]``, no
monitor thread, reference semantics preserved.
"""

from __future__ import annotations

import logging
import threading
import time as _time

from .. import obs

logger = logging.getLogger(__name__)

__all__ = ["OpWatchdog", "WATCHDOG_FIRED"]

#: sentinel key marking a watchdog firing on the completions queue
WATCHDOG_FIRED = "__harness_timeout__"


class OpWatchdog:
    """Monitor thread enforcing one deadline per in-flight op."""

    def __init__(self, timeout_s, completions):
        self.timeout_s = timeout_s
        self._completions = completions
        self._lock = threading.Lock()
        self._armed = {}          # thread id -> (deadline, serial, op)
        self._wake = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(target=self._monitor,
                                        name="jepsen watchdog",
                                        daemon=True)
        self._thread.start()

    def arm(self, wid, serial, op):
        with self._lock:
            self._armed[wid] = (_time.monotonic() + self.timeout_s,
                                serial, op)
        self._wake.set()

    def disarm(self, wid, serial):
        with self._lock:
            entry = self._armed.get(wid)
            if entry is not None and entry[1] == serial:
                del self._armed[wid]

    def stop(self):
        self._stopped = True
        self._wake.set()
        self._thread.join(1.0)

    def _monitor(self):
        while not self._stopped:
            # clear BEFORE scanning: an arm() racing the scan re-sets the
            # event and the wait below returns immediately for a rescan
            # (clear-after-scan could sleep past a freshly-armed deadline)
            self._wake.clear()
            now = _time.monotonic()
            due = []
            with self._lock:
                nearest = None
                for wid, (deadline, serial, op) in list(self._armed.items()):
                    if deadline <= now:
                        due.append((wid, serial, op))
                        del self._armed[wid]
                    elif nearest is None or deadline < nearest:
                        nearest = deadline
            for wid, serial, op in due:
                logger.warning(
                    "Op on worker %r exceeded op-timeout (%.0f ms); "
                    "retiring wedged worker: %r", wid,
                    self.timeout_s * 1000, {k: op.get(k) for k in
                                            ("process", "f", "value")})
                obs.inc("robust.op_timeouts")
                self._completions.put(
                    {WATCHDOG_FIRED: (wid, serial, op)})
            timeout = None if nearest is None else max(0.0, nearest - now)
            self._wake.wait(timeout)
