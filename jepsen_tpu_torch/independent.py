"""Lifting single-key tests to maps of keys (reference
jepsen/src/jepsen/independent.clj).

Some tests are expensive to check — linearizability needs short histories —
but short histories may not sample long enough to reveal concurrency
errors. This module splits a test into independent keyed components:
generators wrap values in ``(k, v)`` tuples, and the checker splits the
history into per-key subhistories.

As in ``jepsen_tpu.independent``, the per-key checker's linearizable
device path hands ALL per-key subhistories to
``parallel.check_batch_encoded`` as one batch -- the key axis becomes the
batch axis of the search -- instead of the reference's bounded-pmap
thread pool (independent.clj:285). Each key's history is planned first
(``analysis/searchplan.py``): sealed quiescent cuts slice it into
segments, and the segments of every key ride the same batch. Unlike the
JAX package, a failure of that batched path raises: it does not fall
back to per-key checks, so a fault of the device path cannot hide behind
slower per-key results. One key's Linearizable verdict is certified
(``_certify_keyed``), and each key's results and history land in the
store under ``independent/<key>/`` (independent.clj:318-326).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace

from . import generator as gen
from . import history as h
from .checker.core import Checker, as_checker, check_safe, merge_valid
from .util import bounded_pmap

logger = logging.getLogger(__name__)

#: Subdirectory for per-key results in the store (independent.clj:18-20).
DIR = "independent"


class Tuple(tuple):
    """A kv tuple: marks values produced by independent generators
    (independent.clj:22-29 MapEntry)."""

    __slots__ = ()

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"[{self[0]!r} {self[1]!r}]"


def tuple_(k, v):
    """Constructs a kv tuple (independent.clj tuple)."""
    return Tuple(k, v)


def is_tuple(value):
    return isinstance(value, Tuple)


def _tuple_gen(k, g):
    """Wraps a generator so ops carry :value [k v] tuples
    (independent.clj:96-101)."""
    def wrap(op):
        op = dict(op)
        op["value"] = Tuple(k, op.get("value"))
        return op
    return gen.map(wrap, g)


def sequential_generator(keys, fgen):
    """One key at a time: builds (fgen k1), drains it, moves to k2, ...
    wrapping each value in a [k v] tuple (independent.clj:31-47). fgen must
    be pure."""
    return [_tuple_gen(k, fgen(k)) for k in keys]


def _group_threads(n, ctx):
    """Partition sorted worker threads into groups of n
    (independent.clj:49-77)."""
    threads = sorted(ctx.all_threads(), key=lambda t: (isinstance(t, str), t))
    thread_count = len(threads)
    group_count = thread_count // n
    assert n <= thread_count, (
        f"With {thread_count} worker threads, concurrent-generator cannot "
        f"run a key with {n} threads concurrently. Consider raising your "
        f"test's concurrency to at least {n}.")
    assert thread_count == n * group_count, (
        f"This concurrent-generator has {thread_count} threads but can only "
        f"use {n * group_count} of them to run {group_count} concurrent "
        f"keys with {n} threads apiece. Consider a concurrency that is a "
        f"multiple of {n}.")
    return [threads[i * n:(i + 1) * n] for i in range(group_count)]


class _LazyKeys:
    """A persistent, memoized view over a (possibly endless) key iterable:
    ``get(i)`` always returns the same key for the same i, so the pure
    generator can be re-entered/copied safely (the reference's lazy seq of
    keys, e.g. ``(range)`` in linearizable_register.clj:45)."""

    def __init__(self, iterable):
        self._it = iter(iterable)
        self._cache = []

    def get(self, i):
        """The i-th key, or None when the sequence is exhausted."""
        while len(self._cache) <= i:
            try:
                self._cache.append(next(self._it))
            except StopIteration:
                return None
        return self._cache[i]


@dataclass(frozen=True)
class ConcurrentGenerator(gen.Generator):
    """Splits threads into groups of n; each group works one key's
    generator, rotating to a fresh key when it exhausts
    (independent.clj:103-236).

    n: group size; fgen: key -> generator; keys: _LazyKeys; key_idx: next
    unconsumed key position; group_threads: list of thread lists (lazy);
    thread_group: {thread: group} (lazy); gens: per-group generator vector
    (lazy)."""

    n: int
    fgen: object
    keys: object
    key_idx: int = 0
    group_threads: object = None
    thread_group: object = None
    gens: object = None

    def _init(self, ctx):
        gt = self.group_threads or _group_threads(self.n, ctx)
        tg = self.thread_group or {t: g for g, ts in enumerate(gt)
                                   for t in ts}
        gens = self.gens
        idx = self.key_idx
        if gens is None:
            gens = []
            for _ in range(len(gt)):
                k = self.keys.get(idx)
                if k is None:
                    gens.append(None)
                else:
                    gens.append(_tuple_gen(k, self.fgen(k)))
                    idx += 1
        return gt, tg, idx, list(gens)

    def op(self, test, ctx):
        gt, tg, idx, gens = self._init(ctx)
        free_groups = {tg[t] for t in ctx.free_threads if t in tg}

        soonest = None
        for group in sorted(free_groups):
            while True:
                g = gens[group]
                if g is None:
                    break
                gctx = ctx.restrict(set(gt[group]).__contains__)
                res = gen.gen_op(g, test, gctx)
                if res is None:
                    # group generator exhausted: rotate to a fresh key
                    k = self.keys.get(idx)
                    if k is not None:
                        idx += 1
                        gens[group] = _tuple_gen(k, self.fgen(k))
                        continue
                    gens[group] = None
                    break
                op, g2 = res
                cand = {"op": op, "group": group, "gen2": g2,
                        "weight": len(gt[group])}
                soonest = gen.soonest_op_map(soonest, cand)
                break

        if soonest is not None and soonest["op"] is not gen.PENDING:
            group = soonest["group"]
            gens[group] = soonest["gen2"]
            return soonest["op"], replace(
                self, key_idx=idx, group_threads=gt, thread_group=tg,
                gens=tuple(gens))
        # No dispatchable op now; if any generator (or pending candidate)
        # remains, stay pending
        if soonest is not None or any(g is not None for g in gens):
            return gen.PENDING, replace(
                self, key_idx=idx, group_threads=gt, thread_group=tg,
                gens=tuple(gens))
        return None

    def update(self, test, ctx, event):
        if self.thread_group is None or self.gens is None:
            return self
        thread = ctx.process_to_thread(event.get("process"))
        group = self.thread_group.get(thread)
        if group is None or self.gens[group] is None:
            return self
        gctx = ctx.restrict(set(self.group_threads[group]).__contains__)
        gens = list(self.gens)
        gens[group] = gen.gen_update(gens[group], test, gctx, event)
        return replace(self, gens=tuple(gens))


def concurrent_generator(n, keys, fgen):
    """n threads per key; groups rotate to fresh keys as their generator
    exhausts. ``keys`` may be endless (e.g. itertools.count()). Excludes
    the nemesis by design (independent.clj:238-264)."""
    assert isinstance(n, int) and n > 0
    return gen.clients(ConcurrentGenerator(n, fgen, _LazyKeys(keys)))


def history_keys(history):
    """The set of keys in a history (independent.clj:266-276)."""
    ks = set()
    for op in history:
        v = op.get("value")
        if is_tuple(v):
            ks.add(v.key)
    return ks


def subhistory(k, history):
    """Ops relevant to key k, with tuples unwrapped to their plain values;
    un-keyed ops (nemesis, logging) appear in every subhistory
    (independent.clj:278-291)."""
    out = []
    for op in history:
        v = op.get("value")
        if not is_tuple(v):
            out.append(op)
        elif v.key == k:
            op = dict(op)
            op["value"] = v.value
            out.append(op)
    return out


class _IndependentChecker(Checker):
    """Lifts a checker over plain values to one over [k v] histories
    (independent.clj:293-344). The linearizable device path batches every
    key's encoded subhistory into ONE device call."""

    def __init__(self, inner):
        self.inner = as_checker(inner)

    def check(self, test, history, opts=None):
        opts = opts or {}
        ks = sorted(history_keys(history), key=repr)
        subs = {k: subhistory(k, history) for k in ks}

        results = self._check_batched(test, ks, subs, opts)
        if results is None:
            # reserve the once-per-test certification claim so the
            # parallel per-key checks can't certify whichever key's
            # subcheck happens to finish first; _certify_keyed below
            # picks one deterministically instead
            reserved = isinstance(test, dict) \
                and self._split_inner()[1] is not None \
                and not test.get("certify-done?")
            if reserved:
                test["certify-done?"] = True

            def one(k):
                subdir = list(opts.get("subdirectory") or []) + [DIR, k]
                r = check_safe(self.inner, test, subs[k],
                               {**opts, "subdirectory": subdir,
                                "history-key": k})
                self._write_key_files(test, subdir, r, subs[k])
                return k, r

            results = dict(bounded_pmap(one, ks))
            if reserved:
                test["certify-done?"] = False

        self._certify_keyed(test, subs, results)
        failures = [k for k, r in results.items()
                    if r.get("valid") is not True]
        return {"valid": merge_valid([r.get("valid")
                                      for r in results.values()]),
                "results": results,
                "failures": failures}

    def _certify_keyed(self, test, subs, results):
        """Certify ONE deterministically chosen key's Linearizable
        verdict: neither keyed path routes subchecks through
        ``checker.core.check`` with the Linearizable gate itself, so
        without this hook keyed searches would ship uncertified. The
        first failing key (sorted by repr) is certified, so a violation's
        witness is the proof of record; a clean run certifies the first
        key. ``certify_verdict`` is contained: a certifier fault never
        touches the keyed verdict."""
        name, lin, _ = self._split_inner()
        if lin is None or not isinstance(test, dict):
            return
        from .checker.core import certify_verdict

        def lin_result(r):
            if name is not None and isinstance(r, dict):
                r = r.get(name)
            return r if isinstance(r, dict) \
                and r.get("valid") in (True, False) else None

        ks = [k for k in sorted(subs, key=repr)
              if lin_result(results.get(k)) is not None]
        if not ks:
            return
        bad = [k for k in ks if lin_result(results[k])["valid"] is False]
        k = (bad or ks)[0]
        certify_verdict(lin, test, subs[k], lin_result(results[k]), key=k)

    def _split_inner(self):
        """Find the Linearizable gate inside the inner checker: either the
        inner checker itself, or exactly one member of a Compose (the
        register workload composes linearizable with timeline). Returns
        (name, linearizable, rest_map) — name None when bare — or
        (None, None, None) when there is no batched path."""
        from .checker.checkers import Linearizable
        from .checker.core import Compose
        inner = self.inner
        if isinstance(inner, Linearizable):
            return None, inner, {}
        if isinstance(inner, Compose):
            lins = [(k, c) for k, c in inner.checker_map.items()
                    if isinstance(c, Linearizable)]
            if len(lins) == 1:
                name, lin = lins[0]
                rest = {k: c for k, c in inner.checker_map.items()
                        if k != name}
                return name, lin, rest
        return None, None, None

    def _check_batched(self, test, ks, subs, opts):
        """When the inner checker gates on the device engine ("jax-wgl",
        "batch" or "competition"), run every key's search as ONE batched
        device call -- keys become the search's batch axis
        (parallel/keyshard.py) instead of a thread pool. Each key's
        history is planned: its segments ride the same batch and merge
        back into the key's verdict. Under "competition" a key the batch
        leaves unknown is raced per key (device vs the CPU engines).
        Other composed checkers still run per key. Returns None when not
        applicable (no Linearizable gate, or a CPU algorithm); raises
        when the batched path fails."""
        name, lin, rest = self._split_inner()
        if lin is None or lin.algorithm not in ("jax-wgl", "batch",
                                                "competition"):
            return None
        from . import parallel
        from .analysis import searchplan
        plan_on = searchplan.segments_enabled(test)
        min_seg = searchplan.min_segment(test)
        # the SAME client-op selection as Linearizable.check
        pairs = []
        spans = []          # per key: (start, count, info, plan_s, seeds)
        for k in ks:
            client = lin.prepare_history(h.client_ops(subs[k]))
            segs, info, plan_s = None, None, 0.0
            if plan_on:
                t0 = time.monotonic()
                segs, info = searchplan.plan_segments(lin.spec, client,
                                                      min_seg)
                plan_s = time.monotonic() - t0
                if len(segs) < 2:
                    segs = None     # no reduction: encode as-is
            start = len(pairs)
            if segs is None:
                pairs.append(lin.spec.encode(client))
                spans.append((start, 1, None, 0.0, None))
            else:
                pairs.extend(lin.spec.encode(s.events) for s in segs)
                spans.append((start, len(segs), info, plan_s,
                              [s.seed for s in segs]))
        batch = parallel.check_batch_encoded(lin.spec, pairs,
                                             **lin.engine_opts)
        per_key = []
        for start, count, info, plan_s, seeds in spans:
            if info is None:
                per_key.append(batch[start])
                continue
            # stamp segment provenance onto each normalized witness
            # before the merge folds them, as Linearizable._check_planned
            for i in range(count):
                w = batch[start + i].get("witness")
                if isinstance(w, dict):
                    w["segment"] = {"index": i, "count": count,
                                    "seed": seeds[i]}
            per_key.append(searchplan.merge_segment_results(
                batch[start:start + count], info, plan_s))

        def finish(kr):
            k, lr = kr
            lr = dict(lr)
            if lr.get("valid") == "unknown" and \
                    lin.algorithm == "competition":
                # competition semantics: an unknown from the device batch
                # defers to the per-key race (device vs the CPU engines)
                lr = check_safe(lin, test, subs[k], opts)
            lr["valid?"] = lr["valid"]
            subdir = list(opts.get("subdirectory") or []) + [DIR, k]
            if name is None:
                r = lr
            else:
                # mimic the Compose result shape for the whole inner map
                r = {name: lr}
                for rn, rc in rest.items():
                    r[rn] = check_safe(rc, test, subs[k],
                                       {**opts, "subdirectory": subdir,
                                        "history-key": k})
                r["valid"] = merge_valid(
                    [v.get("valid") for v in r.values()
                     if isinstance(v, dict)])
            self._write_key_files(test, subdir, r, subs[k])
            return k, r

        return dict(bounded_pmap(finish, list(zip(ks, per_key))))

    def _write_key_files(self, test, subdir, results, sub):
        """Per-key results.json + history.txt in the store
        (independent.clj:318-326)."""
        if not test.get("name") or not test.get("start-time"):
            return
        try:
            from . import store
            from .util import op_str
            store._dump_json(results, store.make_path(test, subdir,
                                                      "results.json"))
            with open(store.make_path(test, subdir, "history.txt"),
                      "w") as f:
                for op in sub:
                    f.write(op_str(op) + "\n")
        except Exception:  # noqa: BLE001 - persistence is best-effort here
            logger.warning("couldn't write per-key files", exc_info=True)


def checker(inner):
    """Lift a checker over plain values to [k v] tuple histories
    (independent.clj:293-344)."""
    return _IndependentChecker(inner)
