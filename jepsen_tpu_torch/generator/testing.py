"""Deterministic simulated-time execution of generators (reference
jepsen/src/jepsen/generator/test.clj -- shipped in src, not test/, because
consumers test their own generators with it).

``simulate(test, gen, completion_fn)`` runs a generator against a synthetic
scheduler: ops are dispatched to virtual threads, completed by
``completion_fn(op) -> completion op (with :time advanced)``, and the
emitted history (invocations + completions, in time order) is returned.
No wall clock, no threads; with ``fixed_rand`` the result is fully
deterministic (fixed seed 45100, test.clj:31-48).
"""

from __future__ import annotations

import heapq

from . import (PENDING, context, fixed_rand, gen_op,
               gen_update, validate)

#: latency applied by the `perfect` completion functions: 10 ns
#: (generator/test.clj:110-120)
PERFECT_LATENCY = 10


def default_test():
    """A tiny test map for generator tests (test.clj: n=2)."""
    return {"concurrency": 2, "nodes": ["n1", "n2"]}


def simulate(test, gen, completion_fn, limit=100_000):
    """Simulate the full execution of ``gen`` (test.clj:50-108).

    completion_fn: (completed-invocation) -> completion op or None (op never
    completes; its thread stays busy forever).

    Returns the history: all emitted invocations and completions sorted by
    dispatch order.
    """
    gen = validate(gen)
    ctx = context(test)
    # pending completions: heap of (time, seq, thread, completion-op)
    completions = []
    seq = 0
    history = []

    for _ in range(limit):
        # complete anything due before the generator's next op
        res = gen_op(gen, test, ctx)
        if res is None:
            if not completions:
                return history
            op = None
        else:
            op = res[0]

        if completions and (
                op is None or op is PENDING
                or completions[0][0] <= op["time"]):
            # process the earliest completion first
            t, _, thread, comp = heapq.heappop(completions)
            ctx = ctx.with_time(max(ctx.time, t)).free(thread)
            if comp["type"] in ("ok", "fail", "info"):
                if comp["type"] == "info" and isinstance(
                        comp.get("process"), int):
                    # crashed process: bump to a fresh process id
                    ctx = ctx.with_worker(
                        thread, ctx.next_process(thread))
                history.append(comp)
                gen = gen_update(gen, test, ctx, comp)
            continue

        if op is None:
            return history
        if op is PENDING:
            # do NOT commit the pending generator state: state advances
            # only on dispatch (mirrors test.clj:62-71 recurring with gen,
            # not gen', when completing instead of dispatching)
            if not completions:
                # deadlock: nothing pending can ever complete
                return history
            continue

        # dispatch the op
        gen = res[1]
        ctx = ctx.with_time(max(ctx.time, op["time"]))
        thread = ctx.process_to_thread(op["process"])
        history.append(op)
        gen = gen_update(gen, test, ctx, op)
        if op["type"] in ("invoke",):
            ctx = ctx.busy(thread)
            comp = completion_fn(op)
            if comp is not None:
                seq += 1
                heapq.heappush(
                    completions, (comp["time"], seq, thread, comp))
        elif op["type"] == "sleep":
            # thread sleeps: busy until time + value seconds
            ctx = ctx.busy(thread)
            seq += 1
            wake = {"type": "wake", "process": op["process"],
                    "time": op["time"] + int(op["value"] * 1e9)}
            heapq.heappush(completions, (wake["time"], seq, thread, wake))
        # log ops take no time and leave the thread free
    raise RuntimeError(f"simulate exceeded {limit} steps")


def perfect(op):
    """Completion fn: everything succeeds in 10 ns (test.clj `perfect`)."""
    comp = dict(op)
    comp["type"] = "ok"
    comp["time"] = op["time"] + PERFECT_LATENCY
    return comp


def perfect_info(op):
    """Completion fn: everything crashes (:info) in 10 ns."""
    comp = dict(op)
    comp["type"] = "info"
    comp["time"] = op["time"] + PERFECT_LATENCY
    return comp


class imperfect:
    """Rotating fail/info/ok completions, 10/20/30 ns latencies
    (test.clj `imperfect`)."""

    def __init__(self):
        self.i = 0

    def __call__(self, op):
        kinds = [("fail", 10), ("info", 20), ("ok", 30)]
        kind, latency = kinds[self.i % 3]
        self.i += 1
        comp = dict(op)
        comp["type"] = kind
        comp["time"] = op["time"] + latency
        return comp


def quick(gen, test=None, seed=45100, limit=100_000):
    """Simulate with perfect completions and a fixed seed; returns the
    history (test.clj `quick`)."""
    test = test or default_test()
    with fixed_rand(seed):
        return simulate(test, gen, perfect, limit=limit)


def invocations(history):
    return [op for op in history if op["type"] == "invoke"]


def ops_by_f(history):
    out = {}
    for op in history:
        out.setdefault(op.get("f"), []).append(op)
    return out
