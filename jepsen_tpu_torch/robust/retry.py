"""One retry policy for the whole harness: exponential backoff with
jitter and a max-elapsed budget.

Before this module, every retry loop in the framework hand-rolled its
own constants: ``RetryRemote`` slept a flat 100 ms five times,
``db.cycle`` retried instantly, and neither bounded total elapsed
time. A `RetryPolicy` is an immutable value describing *how* to retry;
``policy.call(f, ...)`` runs the loop. Two retry triggers compose:

* ``retry_on_exception`` -- an exception class (tuple) whose instances
  are caught and retried; anything else propagates immediately.
* ``retry_on_result`` -- a predicate over *successful* return values.
  Subprocess transports (ssh/docker/kubectl) report failure as
  ``{"exit": 255}`` / ``{"exit": -1, "err": "timeout"}`` dicts rather
  than raising, which is exactly why ``RetryRemote`` historically
  never retried them.

Every retry increments the ``robust.retries`` obs counter (labelled by
``site``) so flaky transports show up in ``metrics.json``.
"""

from __future__ import annotations

import logging
import random
import time as _time
from dataclasses import dataclass

from .. import obs

logger = logging.getLogger(__name__)

__all__ = ["RetryPolicy"]


@dataclass(frozen=True)
class RetryPolicy:
    """How to retry: geometric backoff, multiplicative jitter, capped
    per-sleep and by total elapsed wall time."""

    tries: int = 5                  #: total attempts (>= 1)
    base_s: float = 0.1             #: first backoff
    multiplier: float = 2.0         #: geometric growth per attempt
    jitter: float = 0.1             #: +/- fraction of each backoff
    max_backoff_s: float = 5.0      #: per-sleep cap
    max_elapsed_s: float | None = None  #: total budget; None = unbounded

    @classmethod
    def bounded(cls, total_s, tries=4, base_s=0.5):
        """A policy whose whole loop (attempts + sleeps) fits inside
        ``total_s``: the shape callers with a hard wall budget want
        (e.g. fleet artifact sync, whose budget must stay under the
        worker lease). Per-sleep cap scales with the budget so a
        short budget doesn't spend itself sleeping."""
        total_s = max(0.1, float(total_s))
        return cls(tries=max(1, int(tries)), base_s=float(base_s),
                   multiplier=2.0, jitter=0.1,
                   max_backoff_s=max(float(base_s), total_s / 8.0),
                   max_elapsed_s=total_s)

    def backoff_s(self, attempt, rng=random):
        """Sleep before retry number ``attempt`` (0-based: the sleep
        between attempt 0 and attempt 1 is ``backoff_s(0)``)."""
        b = min(self.base_s * (self.multiplier ** attempt),
                self.max_backoff_s)
        if self.jitter:
            b *= 1.0 + rng.uniform(-self.jitter, self.jitter)
        return max(0.0, b)

    def call(self, f, retry_on_exception=(Exception,),
             retry_on_result=None, on_retry=None, site="robust.retry",
             rng=random):
        """Run ``f()`` under this policy.

        Retries when ``f`` raises ``retry_on_exception`` or returns a
        value for which ``retry_on_result`` is truthy. ``on_retry(attempt,
        exc_or_none)`` runs before each backoff sleep (reconnect hooks).
        On exhaustion the last exception is re-raised, or the last
        (retryable) result returned -- callers inspecting status dicts
        see the final failure rather than an opaque error."""
        start = _time.monotonic()
        last_result = None
        for attempt in range(max(1, self.tries)):
            exc = None
            try:
                result = f()
            except retry_on_exception as e:  # noqa: PERF203
                exc = e
            else:
                if retry_on_result is None or not retry_on_result(result):
                    return result
                last_result = result

            if attempt + 1 >= max(1, self.tries):
                break
            sleep = self.backoff_s(attempt, rng=rng)
            if self.max_elapsed_s is not None and \
                    _time.monotonic() - start + sleep > self.max_elapsed_s:
                logger.debug("%s: elapsed budget %.1fs exhausted after "
                             "%d attempts", site, self.max_elapsed_s,
                             attempt + 1)
                break
            obs.inc("robust.retries", site=site)
            if on_retry is not None:
                on_retry(attempt, exc)
            if sleep > 0:
                _time.sleep(sleep)

        if exc is not None:
            raise exc
        return last_result
