"""Strict-serializability anomaly: T2 visible without an earlier T1
(reference jepsen/src/jepsen/tests/causal_reverse.clj, 114 LoC; the
port's copy of ``jepsen_tpu/tests/causal_reverse.py``). Host-only.

Concurrent blind single-key inserts race reads of all keys; a read that
observes w_i but misses some w_j which completed before w_i *invoked*
shows causal reversal."""

from __future__ import annotations

import itertools

from .. import checker as cc
from .. import generator as gen
from .. import independent
from ..checker.core import Checker
from ..history import invoke as is_invoke, ok as is_ok


def graph(history):
    """value -> set of writes known complete before that write invoked
    (causal_reverse.clj:21-47)."""
    completed = set()
    expected = {}
    for op in history:
        if op.get("f") != "write":
            continue
        if is_invoke(op):
            expected[op.get("value")] = frozenset(completed)
        elif is_ok(op):
            completed.add(op.get("value"))
    return expected


def errors(history, expected):
    """Reads whose observed set misses a write that preceded one they saw
    (causal_reverse.clj:49-77)."""
    out = []
    for op in history:
        if not (is_ok(op) and op.get("f") == "read"):
            continue
        seen = set(op.get("value") or ())
        our_expected = set()
        for v in seen:
            our_expected |= set(expected.get(v, ()))
        missing = our_expected - seen
        if missing:
            err = {k: v for k, v in op.items() if k != "value"}
            err["missing"] = sorted(missing)
            err["expected-count"] = len(our_expected)
            out.append(err)
    return out


class _Checker(Checker):
    def check(self, test, history, opts=None):
        errs = errors(history, graph(history))
        return {"valid": not errs, "valid?": not errs, "errors": errs}


def checker():
    return _Checker()


def workload(opts):
    """Generator + checker bundle (causal_reverse.clj:90-114). Options:
    nodes (worker count per key), per-key-limit (default 500)."""
    n = len(opts.get("nodes") or []) or 1

    def fgen(k):
        counter = itertools.count()

        def write(test, ctx):
            return {"f": "write", "value": next(counter)}

        def read(test, ctx):
            return {"f": "read"}

        return gen.limit(
            opts.get("per-key-limit", 500),
            gen.stagger(1 / 100, gen.mix([read, write])))

    return {
        "checker": cc.compose({
            "sequential": independent.checker(checker()),
        }),
        "generator": independent.concurrent_generator(
            n, itertools.count(), fgen),
    }
