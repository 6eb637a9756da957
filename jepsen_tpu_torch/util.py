"""The utilities the port's checkers need (reference
jepsen/src/jepsen/util.clj): parallel maps that raise real exceptions
(real-pmap, util.clj:65-77; bounded-pmap, used by independent.clj:285),
the op printer (util.clj:177-238), and the pow-2 shape bucket the
streaming fold grows its frontier along (a copy of
``jepsen_tpu.campaign.compile_cache``'s ``bucket``, without its compile
ledger or its settable floor). A copy of the part of the JAX package
the port needs: it imports nothing of it."""

from __future__ import annotations

import concurrent.futures
import contextvars
import threading

#: Exception types that usually mask the root cause when a sibling thread
#: dies first (dom-top real-pmap rethrows the *interesting* one;
#: core_test.clj most-interesting-exception-test).
BORING_EXCEPTIONS = (threading.BrokenBarrierError, InterruptedError,
                     TimeoutError)

#: minimum op-count bucket (the JAX package reads it from its campaign
#: compile cache, whose default this is; the port never changes it)
DEFAULT_N_FLOOR = 64


def bucket(x, lo=1):
    """Round up to a power of two (>= lo): the shared shape-bucket rule."""
    return max(lo, 1 << (max(1, int(x)) - 1).bit_length())


def real_pmap(f, coll):
    """Map f over coll in parallel, one thread per element; raises the most
    *interesting* exception raised by any element — barrier/interrupt
    errors are secondary to real failures (util.clj:65-77 via dom-top)."""
    coll = list(coll)
    if not coll:
        return []
    # propagate the caller's contextvars into the pool threads
    ctx = contextvars.copy_context()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(coll)) as ex:
        futures = [ex.submit(ctx.copy().run, f, x) for x in coll]
        results = []
        errs = []
        for fut in futures:
            try:
                results.append(fut.result())
            except BaseException as e:  # noqa: BLE001 - collect, pick best
                errs.append(e)
        if errs:
            for e in errs:
                if not isinstance(e, BORING_EXCEPTIONS):
                    raise e
            raise errs[0]
        return results


def bounded_pmap(f, coll, bound=None):
    """Parallel map with a bounded worker pool (dom-top bounded-pmap,
    used by independent.clj:285)."""
    coll = list(coll)
    if not coll:
        return []
    bound = bound or min(32, len(coll))
    ctx = contextvars.copy_context()
    with concurrent.futures.ThreadPoolExecutor(max_workers=bound) as ex:
        return list(ex.map(lambda x: ctx.copy().run(f, x), coll))


def op_str(o) -> str:
    """Render an op like the reference's history printer (util.clj:177-238):
    ``process  type  f  value [error]``."""
    parts = [str(o.get("process")), str(o.get("type")), str(o.get("f")),
             repr(o.get("value"))]
    if o.get("error") is not None:
        parts.append(repr(o["error"]))
    return "\t".join(parts)
