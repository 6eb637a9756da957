"""Cross-cutting utilities (reference jepsen/src/jepsen/util.clj; the
port's copy of ``jepsen_tpu/util.py``, host-only).

Relative-time clock (util.clj:328-347), majority math (util.clj:84-93),
parallel map with real exceptions (real-pmap, util.clj:65-77), timeouts
(util.clj:~370-381), history pretty-printing (util.clj:177-238), and the
pow-2 shape bucket the streaming fold grows its frontier along (a copy
of ``jepsen_tpu.campaign.compile_cache``'s ``bucket``, without its
compile ledger or its settable floor).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import contextvars
import random
import threading
import time as _time

MICRO = 1_000
MILLI = 1_000_000
SECOND = 1_000_000_000

#: t=0 for relative_time_nanos. A CONTEXTVAR, not a process global: the
#: campaign scheduler overlaps core.runs on sibling threads, and with a
#: shared global the first run's exit wiped the origin out from under
#: every still-running sibling. Each run's origin flows to its
#: interpreter event loop (same thread) and to spawned workers through
#: the contextvars.copy_context() snapshots the fan-outs already take.
_origin_var = contextvars.ContextVar("jepsen_relative_origin",
                                     default=None)


@contextlib.contextmanager
def with_relative_time():
    """Establish t=0 for relative_time_nanos (util.clj:328-347) in the
    current context (and, via context snapshots, its child threads)."""
    token = _origin_var.set(_time.monotonic_ns())
    try:
        yield
    finally:
        _origin_var.reset(token)


def relative_time_nanos() -> int:
    origin = _origin_var.get()
    if origin is None:
        raise RuntimeError("No relative time origin: use with_relative_time()")
    return _time.monotonic_ns() - origin


@contextlib.contextmanager
def ensure_relative_time():
    """Establish a relative-time origin unless one is already active (the
    interpreter may run standalone or under core.run's origin)."""
    if _origin_var.get() is not None:
        yield
        return
    with with_relative_time():
        yield


def majority(n: int) -> int:
    """Smallest integer strictly greater than half (util.clj:84-88)."""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest integer strictly less than half (util.clj:90-93)."""
    return (n - 1) // 2


def minority_third(n: int) -> int:
    """Largest m such that 3m < n: a minority small enough that the other
    two-thirds retain quorum (nemesis/combined.clj :minority-third
    targeting)."""
    return max(0, (n - 1) // 3)


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
    # propagate the caller's contextvars (control-plane session bindings)
    # into the pool threads
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


class Timeout(Exception):
    pass


def timeout_call(ms, timeout_val, f, *args):
    """Run f in a thread; if it exceeds ms milliseconds return timeout_val
    (the thread is abandoned, like the reference's future cancellation --
    util.clj timeout macro).

    Abandoned threads are not silent: they are renamed to
    ``jepsen abandoned <f>`` (so a thread dump attributes them) and
    counted in the ``robust.threads_abandoned`` obs counter, landing in
    metrics.json next to the interpreter's leaked-worker totals."""
    from . import obs
    name = getattr(f, "__name__", None) or repr(f)
    box = {}
    done = threading.Event()
    ctx = contextvars.copy_context()

    def call():
        try:
            box["ok"] = ctx.run(f, *args)
        except BaseException as e:  # noqa: BLE001 - rethrown by caller
            box["err"] = e
        finally:
            done.set()

    thread = threading.Thread(target=call, name=f"jepsen timeout {name}",
                              daemon=True)
    thread.start()
    if not done.wait(ms / 1000.0):
        thread.name = f"jepsen abandoned {name}"
        obs.inc("robust.threads_abandoned", f=name)
        return timeout_val
    if "err" in box:
        raise box["err"]
    return box["ok"]


def rand_nth(seq, rng=random):
    return seq[rng.randrange(len(seq))]


def rand_exp(rng=random):
    return rng.expovariate(1.0)


def fraction(a, b):
    return a / b if b else 0.0


def nanos_to_secs(ns):
    return ns / SECOND


def secs_to_nanos(s):
    return int(s * SECOND)


def ms_to_nanos(ms):
    return int(ms * MILLI)


def longest_common_prefix(strings):
    if not strings:
        return ""
    s1, s2 = min(strings), max(strings)
    for i, c in enumerate(s1):
        if c != s2[i]:
            return s1[:i]
    return s1


def longest_common_prefix_seq(seqs):
    """Longest common prefix of a collection of sequences, as a list —
    used to shorten snarfed log paths (util.clj drop-common-proper-prefix).
    Always leaves at least the last element distinct (proper prefix)."""
    seqs = [list(s) for s in seqs]
    if not seqs:
        return []
    prefix = []
    for items in zip(*seqs):
        if all(x == items[0] for x in items):
            prefix.append(items[0])
        else:
            break
    shortest = min(len(s) for s in seqs)
    if prefix and len(prefix) >= shortest:
        prefix = prefix[:shortest - 1]
    return prefix


def op_str(o) -> str:
    """Render an op like the reference's history printer (util.clj:177-238):
    ``process  type  f  value [error]``."""
    parts = [str(o.get("process")), str(o.get("type")), str(o.get("f")),
             repr(o.get("value"))]
    if o.get("error") is not None:
        parts.append(repr(o["error"]))
    return "\t".join(parts)


def print_history(history, out=None):
    import sys
    out = out or sys.stdout
    for o in history:
        out.write(op_str(o) + "\n")


def random_nonempty_subset(coll, rng=random):
    """A randomly sized non-empty random subset of coll, order preserved;
    empty when coll is empty (util.clj random-nonempty-subset) — e.g. a
    "primaries" target during an election targets nobody rather than
    crashing the nemesis."""
    coll = list(coll)
    if not coll:
        return []
    n = rng.randint(1, len(coll))
    picked = set(rng.sample(range(len(coll)), n))
    return [x for i, x in enumerate(coll) if i in picked]
