"""Pure-functional operation generators (reference jepsen/src/jepsen/
generator.clj, 1452 LoC).

A generator is asked for operations by the interpreter:

    gen_op(gen, test, ctx)     -> None                 (exhausted)
                                | (op_dict, gen')      (emit op)
                                | (PENDING, gen')      (nothing *yet*)
    gen_update(gen, test, ctx, event) -> gen'          (react to event)

Plain data are generators too (generator.clj:545-590): a dict is a one-shot
op (fields filled from context); a callable is invoked (with (test, ctx) if
it takes two args) and its result generates, forever; a list/tuple chains
its members. None is the exhausted generator.

Contexts are immutable maps {time (ns), free_threads, workers
(thread->process)} (generator.clj:453-464); threads are ints 0..n-1 plus
"nemesis". The interpreter owns context bookkeeping; combinators restrict
contexts (reserve, on_threads) or merge alternatives by soonest op
(soonest_op_map, generator.clj:885-927).

Randomness flows through the module-level ``rng`` so the simulated-time
harness (generator/testing.py) can pin seeds like the reference's
with-fixed-rand-int (generator/test.clj:31-48).
"""

from __future__ import annotations

import builtins
import inspect
import logging
import random as _random
from dataclasses import dataclass, replace

from .. import obs
from ..util import secs_to_nanos

logger = logging.getLogger(__name__)

NEMESIS = "nemesis"


class _Pending:
    def __repr__(self):
        return "PENDING"


#: "a process may become free later, but nothing can run now"
PENDING = _Pending()

#: module randomness; rebind via fixed_rand for deterministic tests
rng = _random.Random()


class fixed_rand:
    """Context manager pinning generator randomness to a seed (reference
    generator/test.clj:31-48, seed 45100)."""

    def __init__(self, seed=45100):
        self.seed = seed

    def __enter__(self):
        self.saved = rng.getstate()
        rng.seed(self.seed)
        return self

    def __exit__(self, *exc):
        rng.setstate(self.saved)


# ---------------------------------------------------------------------------
# Context

@dataclass(frozen=True)
class Context:
    """Immutable generator context (generator.clj:453-464)."""

    time: int                      # ns, relative
    free_threads: tuple            # threads not running an op (ordered)
    workers: dict                  # thread -> process

    def free_processes(self):
        return [self.workers[t] for t in self.free_threads]

    def some_free_process(self):
        """A uniformly random free process (generator.clj:480-487 uses a
        bifurcan set for fair O(1) nth; a tuple does the same here)."""
        if not self.free_threads:
            return None
        t = self.free_threads[rng.randrange(len(self.free_threads))]
        return self.workers[t]

    def all_threads(self):
        return list(self.workers.keys())

    def all_processes(self):
        return list(self.workers.values())

    def process_to_thread(self, process):
        for t, p in self.workers.items():
            if p == process:
                return t
        return None

    def thread_to_process(self, thread):
        return self.workers.get(thread)

    def next_process(self, thread):
        """Process id to assign a thread whose process crashed: bump by the
        number of client processes (generator.clj:519-527)."""
        if isinstance(thread, int):
            clients = len([p for p in self.workers.values()
                           if isinstance(p, int)])
            return self.workers[thread] + clients
        return thread

    def restrict(self, pred):
        """Context restricted to threads satisfying pred (on-threads-context,
        generator.clj:844-863)."""
        return Context(
            time=self.time,
            free_threads=tuple(t for t in self.free_threads if pred(t)),
            workers={t: p for t, p in self.workers.items() if pred(t)})

    def with_time(self, time):
        return replace(self, time=time)

    def busy(self, thread):
        """Mark a thread busy (its op was dispatched)."""
        return replace(self, free_threads=tuple(
            t for t in self.free_threads if t != thread))

    def free(self, thread):
        """Mark a thread free again (its op completed)."""
        if thread in self.free_threads:
            return self
        return replace(self, free_threads=self.free_threads + (thread,))

    def with_worker(self, thread, process):
        w = dict(self.workers)
        w[thread] = process
        return replace(self, workers=w)


def context(test):
    """Fresh context for a test map: nemesis + concurrency client threads
    (generator.clj:453-464)."""
    threads = (NEMESIS,) + tuple(range(test.get("concurrency", 1)))
    return Context(time=0, free_threads=threads,
                   workers={t: t for t in threads})


def fill_in_op(op, ctx):
    """Fill missing type/process/time from context; PENDING if no process is
    free (generator.clj:531-543)."""
    p = ctx.some_free_process()
    if p is None:
        return PENDING
    op = dict(op)
    op.setdefault("time", ctx.time)
    op.setdefault("process", p)
    op.setdefault("type", "invoke")
    return op


# ---------------------------------------------------------------------------
# protocol dispatch (generator.clj extend-protocol, :545-620)

class Generator:
    """Base class for combinator generators."""

    def op(self, test, ctx):  # pragma: no cover - interface
        raise NotImplementedError

    def update(self, test, ctx, event):
        return self


def gen_op(gen, test, ctx):
    """Ask any generator-like value for [op, gen'] / [PENDING, gen'] /
    None."""
    while True:
        if gen is None:
            return None
        if isinstance(gen, Generator):
            return gen.op(test, ctx)
        if isinstance(gen, dict):
            op = fill_in_op(gen, ctx)
            return (PENDING, gen) if op is PENDING else (op, None)
        if callable(gen):
            x = gen(test, ctx) if _arity2(gen) else gen()
            if x is None:
                return None
            # the function result generates once, then the fn is re-invoked
            return gen_op([x, gen], test, ctx)
        if isinstance(gen, (list, tuple)):
            if not gen:
                return None
            res = gen_op(gen[0], test, ctx)
            if res is not None:
                op, g2 = res
                rest = list(gen[1:])
                return (op, [g2] + rest if rest else g2)
            gen = list(gen[1:])
            continue
        raise TypeError(f"not a generator: {gen!r}")


def gen_update(gen, test, ctx, event):
    """Propagate an event (invoke/complete) to a generator-like value."""
    if gen is None or isinstance(gen, dict) or callable(gen):
        return gen
    if isinstance(gen, Generator):
        return gen.update(test, ctx, event)
    if isinstance(gen, (list, tuple)):
        if not gen:
            return None
        return [gen_update(gen[0], test, ctx, event)] + list(gen[1:])
    raise TypeError(f"not a generator: {gen!r}")


def _arity2(f):
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return False
    params = list(sig.parameters.values())
    # NB: builtins.any — this module's `any` combinator shadows the builtin
    if builtins.any(p.kind == p.VAR_POSITIONAL for p in params):
        return True   # *args accepts (test, ctx); prefer the 2-arg call
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2


# ---------------------------------------------------------------------------
# validation / debugging combinators

class InvalidOp(Exception):
    pass


@dataclass(frozen=True)
class Validate(Generator):
    """Rejects malformed [op, gen'] tuples (generator.clj:622-676);
    installed automatically by the interpreter."""

    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        if op is not PENDING:
            problems = []
            if not isinstance(op, dict):
                problems.append("should be either PENDING or a dict")
            else:
                if op.get("type") not in ("invoke", "info", "sleep", "log"):
                    problems.append(
                        "type should be invoke, info, sleep, or log")
                if not isinstance(op.get("time"), (int, float)):
                    problems.append("time should be a number")
                if op.get("process") is None:
                    problems.append("no process")
                elif op["process"] not in ctx.free_processes():
                    problems.append(
                        f"process {op['process']!r} is not free")
            if problems:
                raise InvalidOp(f"Generator produced invalid op {op!r}: "
                                + "; ".join(problems))
        return op, Validate(gen2)

    def update(self, test, ctx, event):
        return Validate(gen_update(self.gen, test, ctx, event))


@dataclass(frozen=True)
class FriendlyExceptions(Generator):
    """Wraps generator exceptions with generator/context info
    (generator.clj:678-717)."""

    gen: object

    def op(self, test, ctx):
        try:
            res = gen_op(self.gen, test, ctx)
        except Exception as e:  # noqa: BLE001 - rethrown with context
            raise RuntimeError(
                f"Generator threw {type(e).__name__} when asked for an "
                f"operation. Generator: {self.gen!r}; context: {ctx!r}") \
                from e
        if res is None:
            return None
        op, gen2 = res
        return op, FriendlyExceptions(gen2)

    def update(self, test, ctx, event):
        try:
            return FriendlyExceptions(
                gen_update(self.gen, test, ctx, event))
        except Exception as e:  # noqa: BLE001 - rethrown with context
            raise RuntimeError(
                f"Generator threw {type(e).__name__} during update. "
                f"Event: {event!r}; context: {ctx!r}") from e


@dataclass(frozen=True)
class Trace(Generator):
    """Logs ops and updates with a tag (generator.clj:720-762), and
    routes the same stream through the obs tracer when one is bound —
    one unified event stream, not a second ad-hoc one (the log lines
    stay for grep parity with the reference)."""

    k: object
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        logger.info("%s op -> %r", self.k,
                    res[0] if res else None)
        obs.gen_event(self.k, "op", res[0] if res else None)
        if res is None:
            return None
        op, gen2 = res
        return op, Trace(self.k, gen2)

    def update(self, test, ctx, event):
        logger.info("%s update <- %r", self.k, event)
        obs.gen_event(self.k, "update", event)
        return Trace(self.k, gen_update(self.gen, test, ctx, event))


def validate(gen):
    return Validate(gen)


def friendly_exceptions(gen):
    return FriendlyExceptions(gen)


def trace(k, gen):
    return Trace(k, gen)


# ---------------------------------------------------------------------------
# transformation combinators

@dataclass(frozen=True)
class Map(Generator):
    """Transforms emitted ops with f; PENDING/None bypass
    (generator.clj:765-789)."""

    f: object
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        return (op if op is PENDING else self.f(op)), Map(self.f, gen2)

    def update(self, test, ctx, event):
        return Map(self.f, gen_update(self.gen, test, ctx, event))


def map(f, gen):  # noqa: A001 - mirrors gen/map
    return Map(f, gen)


def f_map(fm, gen):
    """Renames :f values via mapping fm (generator.clj:791-796); used to
    namespace composed nemesis generators."""
    def transform(op):
        # ops without :f (sleep/log) pass through unchanged, as do :f
        # values the mapping doesn't know (reference `(update op :f fm)`
        # maps a missing key to nil rather than crashing)
        if "f" not in op:
            return op
        op = dict(op)
        op["f"] = fm.get(op["f"], op["f"]) if isinstance(fm, dict) \
            else fm(op["f"])
        return op
    return Map(transform, gen)


@dataclass(frozen=True)
class Filter(Generator):
    """Only ops matching pred pass; PENDING bypasses
    (generator.clj:798-817)."""

    pred: object
    gen: object

    def op(self, test, ctx):
        gen = self.gen
        while True:
            res = gen_op(gen, test, ctx)
            if res is None:
                return None
            op, gen2 = res
            if op is PENDING or self.pred(op):
                return op, Filter(self.pred, gen2)
            gen = gen2

    def update(self, test, ctx, event):
        return Filter(self.pred, gen_update(self.gen, test, ctx, event))


def filter(pred, gen):  # noqa: A001 - mirrors gen/filter
    return Filter(pred, gen)


@dataclass(frozen=True)
class IgnoreUpdates(Generator):
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        return op, IgnoreUpdates(gen2)

    def update(self, test, ctx, event):
        return self


def ignore_updates(gen):
    return IgnoreUpdates(gen)


@dataclass(frozen=True)
class OnUpdate(Generator):
    """Calls (f this test ctx event) on update (generator.clj:827-842)."""

    f: object
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        return op, OnUpdate(self.f, gen2)

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


def on_update(f, gen):
    return OnUpdate(f, gen)


# ---------------------------------------------------------------------------
# thread routing

@dataclass(frozen=True)
class OnThreads(Generator):
    """Restricts a generator to threads satisfying pred; updates from other
    threads don't propagate (generator.clj:864-883)."""

    pred: object
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx.restrict(self.pred))
        if res is None:
            return None
        op, gen2 = res
        return op, OnThreads(self.pred, gen2)

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.get("process"))
        if thread is not None and self.pred(thread):
            return OnThreads(self.pred, gen_update(
                self.gen, test, ctx.restrict(self.pred), event))
        return self


def on_threads(pred, gen):
    return OnThreads(_as_pred(pred), gen)


on = on_threads   # backwards-compat alias, generator.clj:884


def _as_pred(p):
    if callable(p) and not isinstance(p, (set, frozenset)):
        return p
    s = builtins.set(p) if not isinstance(p, (set, frozenset)) else p
    return lambda t: t in s


def soonest_op_map(m1, m2):
    """Merge two {op, weight, ...} candidates, preferring the earlier op;
    ties break randomly proportional to weight (generator.clj:885-927)."""
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    op1, op2 = m1["op"], m2["op"]
    if op1 is PENDING:
        return m2
    if op2 is PENDING:
        return m1
    t1, t2 = op1["time"], op2["time"]
    if t1 == t2:
        w1 = m1.get("weight", 1)
        w2 = m2.get("weight", 1)
        chosen = m1 if rng.randrange(w1 + w2) < w1 else m2
        chosen = dict(chosen)
        chosen["weight"] = w1 + w2
        return chosen
    return m1 if t1 < t2 else m2


@dataclass(frozen=True)
class Any(Generator):
    """Ops from whichever sub-generator is soonest; updates go to all
    (generator.clj:929-953)."""

    gens: tuple

    def op(self, test, ctx):
        soonest = None
        for i, gen in enumerate(self.gens):
            res = gen_op(gen, test, ctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "i": i})
        if soonest is None:
            return None
        gens = builtins.list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return soonest["op"], Any(tuple(gens))

    def update(self, test, ctx, event):
        return Any(tuple(gen_update(g, test, ctx, event)
                         for g in self.gens))


def any(*gens):  # noqa: A001 - mirrors gen/any
    if not gens:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(tuple(gens))


@dataclass(frozen=True)
class EachThread(Generator):
    """Independent copy of the generator per thread
    (generator.clj:955-1007)."""

    fresh_gen: object
    gens: tuple    # ((thread, gen), ...) as a hashable mapping

    def _gen_for(self, thread):
        for t, g in self.gens:
            if t == thread:
                return g
        return self.fresh_gen

    def _assoc(self, thread, gen):
        pairs = [(t, g) for t, g in self.gens if t != thread]
        pairs.append((thread, gen))
        return tuple(pairs)

    def op(self, test, ctx):
        soonest = None
        for thread in ctx.free_threads:
            gen = self._gen_for(thread)
            tctx = ctx.restrict(lambda t, thread=thread: t == thread)
            res = gen_op(gen, test, tctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1],
                              "thread": thread})
        if soonest is not None:
            return soonest["op"], EachThread(
                self.fresh_gen,
                self._assoc(soonest["thread"], soonest["gen"]))
        if len(ctx.free_threads) != len(ctx.workers):
            return PENDING, self   # busy threads may still have ops
        return None                # every thread exhausted

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.get("process"))
        if thread is None:
            return self
        tctx = ctx.restrict(lambda t: t == thread)
        gen2 = gen_update(self._gen_for(thread), test, tctx, event)
        return EachThread(self.fresh_gen, self._assoc(thread, gen2))


def each_thread(gen):
    return EachThread(gen, ())


@dataclass(frozen=True)
class Reserve(Generator):
    """Dedicates thread ranges to generators, remainder to a default
    (generator.clj:1009-1089)."""

    ranges: tuple        # tuple of frozensets of threads
    gens: tuple          # len(ranges)+1 generators; last is the default

    def op(self, test, ctx):
        soonest = None
        union = frozenset().union(*self.ranges) if self.ranges \
            else frozenset()
        for i, threads in enumerate(self.ranges):
            rctx = ctx.restrict(lambda t, s=threads: t in s)
            res = gen_op(self.gens[i], test, rctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "i": i,
                              "weight": len(threads)})
        dctx = ctx.restrict(lambda t: t not in union)
        res = gen_op(self.gens[-1], test, dctx)
        if res is not None:
            soonest = soonest_op_map(
                soonest, {"op": res[0], "gen": res[1],
                          "i": len(self.ranges),
                          "weight": len(dctx.workers)})
        if soonest is None:
            return None
        gens = builtins.list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return soonest["op"], Reserve(self.ranges, tuple(gens))

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.get("process"))
        i = len(self.ranges)
        for j, threads in enumerate(self.ranges):
            if thread in threads:
                i = j
                break
        if i < len(self.ranges):
            rctx = ctx.restrict(lambda t, s=self.ranges[i]: t in s)
        else:
            union = frozenset().union(*self.ranges) if self.ranges \
                else frozenset()
            rctx = ctx.restrict(lambda t: t not in union)
        gens = builtins.list(self.gens)
        gens[i] = gen_update(gens[i], test, rctx, event)
        return Reserve(self.ranges, tuple(gens))


def reserve(*args):
    """reserve(5, write_gen, 10, cas_gen, read_gen): first 5 threads run
    write_gen, next 10 cas_gen, the rest read_gen."""
    *pairs, default = args
    assert len(pairs) % 2 == 0 and default is not None
    ranges = []
    n = 0
    gens = []
    for i in range(0, len(pairs), 2):
        count, gen = pairs[i], pairs[i + 1]
        ranges.append(frozenset(range(n, n + count)))
        gens.append(gen)
        n += count
    gens.append(default)
    return Reserve(tuple(ranges), tuple(gens))


def clients(client_gen, nemesis_gen=None):
    """Restrict to client threads; two-arity combines with a nemesis
    generator (generator.clj:1093-1103)."""
    if nemesis_gen is None:
        return on_threads(lambda t: t != NEMESIS, client_gen)
    return any(clients(client_gen), nemesis(nemesis_gen))


def nemesis(nemesis_gen, client_gen=None):
    """Restrict to the nemesis thread (generator.clj:1105-1115)."""
    if client_gen is None:
        return on_threads(lambda t: t == NEMESIS, nemesis_gen)
    return any(nemesis(nemesis_gen), clients(client_gen))


# ---------------------------------------------------------------------------
# scheduling combinators

@dataclass(frozen=True)
class Mix(Generator):
    """Uniform random mixture; ignores updates (generator.clj:1124-1154)."""

    i: int
    gens: tuple

    def op(self, test, ctx):
        if not self.gens:
            return None
        res = gen_op(self.gens[self.i], test, ctx)
        if res is not None:
            op, gen2 = res
            gens = builtins.list(self.gens)
            gens[self.i] = gen2
            return op, Mix(rng.randrange(len(gens)), tuple(gens))
        gens = builtins.list(self.gens)
        del gens[self.i]
        if not gens:
            return None
        return Mix(rng.randrange(len(gens)), tuple(gens)).op(test, ctx)


def mix(gens):
    gens = builtins.list(gens)
    if not gens:
        return None
    return Mix(rng.randrange(len(gens)), tuple(gens))


@dataclass(frozen=True)
class Limit(Generator):
    remaining: int
    gen: object

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        # NB the reference decrements even on PENDING (generator.clj:1158)
        return op, Limit(self.remaining - 1, gen2)

    def update(self, test, ctx, event):
        return Limit(self.remaining,
                     gen_update(self.gen, test, ctx, event))


def limit(remaining, gen):
    return Limit(remaining, gen)


def once(gen):
    return Limit(1, gen)


def log(msg):
    """One log op (generator.clj:1177-1181)."""
    return {"type": "log", "value": msg}


@dataclass(frozen=True)
class Repeat(Generator):
    """Re-emits from an unchanging generator; -1 = forever
    (generator.clj:1183-1210)."""

    remaining: int
    gen: object

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, _ = res
        # underlying gen state does NOT advance; count does (clj:1186-1192)
        return op, Repeat(self.remaining - 1, self.gen)

    def update(self, test, ctx, event):
        return Repeat(self.remaining,
                      gen_update(self.gen, test, ctx, event))


def repeat(*args):
    if len(args) == 1:
        return Repeat(-1, args[0])
    n, gen = args
    assert n >= 0
    return Repeat(n, gen)


@dataclass(frozen=True)
class ProcessLimit(Generator):
    """Emits ops for at most n distinct processes
    (generator.clj:1212-1237)."""

    n: int
    procs: frozenset
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        if op is PENDING:
            return op, ProcessLimit(self.n, self.procs, gen2)
        procs = self.procs | frozenset(ctx.all_processes())
        if len(procs) > self.n:
            return None
        return op, ProcessLimit(self.n, procs, gen2)

    def update(self, test, ctx, event):
        return ProcessLimit(self.n, self.procs,
                            gen_update(self.gen, test, ctx, event))


def process_limit(n, gen):
    return ProcessLimit(n, frozenset(), gen)


@dataclass(frozen=True)
class TimeLimit(Generator):
    """Emits ops for dt nanoseconds after its first op
    (generator.clj:1239-1263)."""

    limit: int
    cutoff: object
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        if op is PENDING:
            return op, TimeLimit(self.limit, self.cutoff, gen2)
        cutoff = self.cutoff if self.cutoff is not None \
            else op["time"] + self.limit
        if op["time"] >= cutoff:
            return None
        return op, TimeLimit(self.limit, cutoff, gen2)

    def update(self, test, ctx, event):
        return TimeLimit(self.limit, self.cutoff,
                         gen_update(self.gen, test, ctx, event))


def time_limit(dt_seconds, gen):
    return TimeLimit(secs_to_nanos(dt_seconds), None, gen)


@dataclass(frozen=True)
class Stagger(Generator):
    """Schedules ops at uniformly random intervals in [0, 2*dt), globally
    (generator.clj:1265-1306)."""

    dt: int
    next_time: object
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        if op is PENDING:
            return op, self
        next_time = self.next_time if self.next_time is not None \
            else ctx.time
        nxt = next_time + int(rng.random() * self.dt)
        if next_time <= op["time"]:
            return op, Stagger(self.dt, nxt, gen2)
        op = dict(op)
        op["time"] = next_time
        return op, Stagger(self.dt, nxt, gen2)

    def update(self, test, ctx, event):
        return Stagger(self.dt, self.next_time,
                       gen_update(self.gen, test, ctx, event))


def stagger(dt_seconds, gen):
    """Roughly one op per dt seconds across all threads."""
    return Stagger(secs_to_nanos(2 * dt_seconds), None, gen)


@dataclass(frozen=True)
class Delay(Generator):
    """Ops exactly dt apart (catching up if behind)
    (generator.clj:1344-1370)."""

    dt: int
    next_time: object
    gen: object

    def op(self, test, ctx):
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        if op is PENDING:
            return op, Delay(self.dt, self.next_time, gen2)
        next_time = self.next_time if self.next_time is not None \
            else op["time"]
        op = dict(op)
        op["time"] = max(op["time"], next_time)
        return op, Delay(self.dt, next_time + self.dt, gen2)

    def update(self, test, ctx, event):
        return Delay(self.dt, self.next_time,
                     gen_update(self.gen, test, ctx, event))


def delay(dt_seconds, gen):
    return Delay(secs_to_nanos(dt_seconds), None, gen)


def sleep(dt_seconds):
    """One special op making its process sleep dt seconds
    (generator.clj:1372-1376)."""
    return {"type": "sleep", "value": dt_seconds}


@dataclass(frozen=True)
class Synchronize(Generator):
    """Waits for all workers free before starting
    (generator.clj:1378-1398)."""

    gen: object

    def op(self, test, ctx):
        if len(ctx.free_threads) == len(ctx.workers) and \
                builtins.set(ctx.free_threads) == \
                builtins.set(ctx.workers.keys()):
            return gen_op(self.gen, test, ctx)
        return PENDING, self

    def update(self, test, ctx, event):
        return Synchronize(gen_update(self.gen, test, ctx, event))


def synchronize(gen):
    return Synchronize(gen)


def phases(*gens):
    """Each generator runs to completion, with barriers between
    (generator.clj:1400-1405)."""
    return [synchronize(g) for g in gens]


def then(a, b):
    """b, then (synchronize a). Args backwards for pipeline composition
    (generator.clj:1407-1416)."""
    return [b, synchronize(a)]


@dataclass(frozen=True)
class UntilOk(Generator):
    """Emits until one op completes ok (generator.clj:1418-1436)."""

    gen: object
    done: bool = False

    def op(self, test, ctx):
        if self.done:
            return None
        res = gen_op(self.gen, test, ctx)
        if res is None:
            return None
        op, gen2 = res
        return op, UntilOk(gen2, self.done)

    def update(self, test, ctx, event):
        if event.get("type") == "ok":
            return UntilOk(self.gen, True)
        return UntilOk(gen_update(self.gen, test, ctx, event), self.done)


def until_ok(gen):
    return UntilOk(gen)


@dataclass(frozen=True)
class FlipFlop(Generator):
    """Alternates between generators; stops when one is exhausted; ignores
    updates (generator.clj:1438-1452)."""

    gens: tuple
    i: int

    def op(self, test, ctx):
        res = gen_op(self.gens[self.i], test, ctx)
        if res is None:
            return None
        op, gen2 = res
        gens = builtins.list(self.gens)
        gens[self.i] = gen2
        return op, FlipFlop(tuple(gens), (self.i + 1) % len(gens))


def flip_flop(a, b):
    return FlipFlop((a, b), 0)


def concat(*gens):
    """Chain arbitrary generators (generator.clj:776-781)."""
    return builtins.list(gens)


@dataclass(frozen=True)
class Cycle(Generator):
    """Endless repetition of a SEQUENCE of generators: the chain
    advances through its elements and restarts fresh when exhausted --
    the analogue of driving a generator with Clojure's (cycle [...])
    lazy seq (e.g. zookeeper.clj:121-124's sleep/start/sleep/stop
    nemesis schedule). Contrast `repeat`, which never advances the
    underlying generator and so re-emits its FIRST op forever."""

    template: tuple
    current: object = None

    def op(self, test, ctx):
        cur = self.current if self.current is not None \
            else builtins.list(self.template)
        res = gen_op(cur, test, ctx)
        if res is None:
            res = gen_op(builtins.list(self.template), test, ctx)
            if res is None:   # template yields nothing at all
                return None
        op, g2 = res
        return op, Cycle(self.template, g2)

    def update(self, test, ctx, event):
        if self.current is None:
            return self
        return Cycle(self.template,
                     gen_update(self.current, test, ctx, event))


def cycle(*gens):
    return Cycle(tuple(gens))
