"""Lifting single-key tests to maps of keys (reference
jepsen/src/jepsen/independent.clj), the checker half.

Some tests are expensive to check — linearizability needs short histories —
but short histories may not sample long enough to reveal concurrency
errors. This module splits a test into independent keyed components:
values are wrapped in ``(k, v)`` tuples, and the checker splits the
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
(``_certify_keyed``).

Not ported yet (ROADMAP.md queue A): the keyed generators (they need
``generator``, A.11) and the per-key store files (``store``, A.11).
"""

from __future__ import annotations

import time

from . import history as h
from .checker.core import Checker, as_checker, check_safe, merge_valid
from .util import bounded_pmap

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
                return k, check_safe(self.inner, test, subs[k],
                                     {**opts, "subdirectory": subdir,
                                      "history-key": k})

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
            if name is None:
                return k, lr
            # mimic the Compose result shape for the whole inner map
            subdir = list(opts.get("subdirectory") or []) + [DIR, k]
            r = {name: lr}
            for rn, rc in rest.items():
                r[rn] = check_safe(rc, test, subs[k],
                                   {**opts, "subdirectory": subdir,
                                    "history-key": k})
            r["valid"] = merge_valid(
                [v.get("valid") for v in r.values() if isinstance(v, dict)])
            return k, r

        return dict(bounded_pmap(finish, list(zip(ks, per_key))))


def checker(inner):
    """Lift a checker over plain values to [k v] tuple histories
    (independent.clj:293-344)."""
    return _IndependentChecker(inner)
