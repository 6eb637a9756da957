"""Adya G2 anti-dependency probes: paired predicate-guarded inserts
(reference jepsen/src/jepsen/tests/adya.clj, 87 LoC; the port's copy of
``jepsen_tpu/tests/adya.py``). Host-only.

For each key, exactly two insert txns race: one carries an a-table id,
the other a b-table id (value ``[key, [a_id, b_id]]`` with one id None).
Each txn first checks a predicate over both tables and only inserts if
both come back empty — so under serializability at most one can commit.
Two commits for one key witness a G2 predicate anti-dependency cycle."""

from __future__ import annotations

import itertools
import threading

from .. import generator as gen
from .. import independent
from ..checker.core import Checker


def g2_gen():
    """Pairs of insert ops per key with globally unique ids
    (adya.clj:12-58)."""
    counter = itertools.count(1)
    lock = threading.Lock()

    def next_id():
        with lock:
            return next(counter)

    def fgen(k):
        return [gen.once(lambda test, ctx:
                         {"type": "invoke", "f": "insert",
                          "value": [None, next_id()]}),
                gen.once(lambda test, ctx:
                         {"type": "invoke", "f": "insert",
                          "value": [next_id(), None]})]

    return independent.concurrent_generator(2, itertools.count(), fgen)


class _G2Checker(Checker):
    """At most one insert may succeed per key (adya.clj:60-87)."""

    def check(self, test, history, opts=None):
        keys = {}
        for op in history:
            if op.get("f") != "insert":
                continue
            v = op.get("value")
            if not independent.is_tuple(v) and not (
                    isinstance(v, (list, tuple)) and len(v) == 2):
                continue
            k = v[0]
            if op.get("type") == "ok":
                keys[k] = keys.get(k, 0) + 1
            else:
                keys.setdefault(k, 0)
        inserted = sum(1 for c in keys.values() if c > 0)
        illegal = {k: c for k, c in sorted(keys.items(),
                                           key=lambda kv: str(kv[0]))
                   if c > 1}
        return {"valid": not illegal,
                "valid?": not illegal,
                "key-count": len(keys),
                "legal-count": inserted - len(illegal),
                "illegal-count": len(illegal),
                "illegal": illegal}


def g2_checker():
    return _G2Checker()


def workload():
    return {"generator": g2_gen(), "checker": g2_checker()}
