"""Cycle-detection workloads (reference jepsen/src/jepsen/tests/cycle.clj
+ cycle/append.clj + cycle/wr.clj, which delegate to the external elle
engine; here they drive the port's ``cycle``, whose closures run on
``opts["device"]``, None: CUDA). The port's copy of
``jepsen_tpu/tests/cycle``.

Transactions are ops like::

    {"type": "invoke", "f": "txn",
     "value": [["r", 3, None], ["append", 3, 2], ["r", 3, None]]}

completed with the reads filled in."""

from __future__ import annotations

import random

from ...checker.core import FnChecker


def checker(analyze_fn, opts=None, workload=None):
    """A checker from a history->result analyzer (cycle.clj:9-16);
    the analyzer's closures run on ``opts["device"]`` (None: CUDA).
    Decided verdicts get the cycle-witness certification ride-along
    (analysis/certify.py VC013): every implicated cycle replayed
    host-side through the same inference, persisted in
    certificate.json. Contained inside ``certify_txn_verdict`` --
    never flips a verdict."""
    name = getattr(analyze_fn, "__module__", "cycle")
    wl = workload or ("wr" if name.endswith(".wr") else "append")

    def run(test, hist, _opts):
        res = analyze_fn(hist, opts, device=(opts or {}).get("device"))
        from ...analysis import certify
        certify.certify_txn_verdict(test, hist, res, workload=wl,
                                    opts=opts)
        return res

    return FnChecker(run, name=name)


def txn_generator(key_count=3, min_txn_length=1, max_txn_length=4,
                  max_writes_per_key=32, write_f="append", read_p=0.5):
    """Transactions over a rotating pool of keys (elle's wr-txns shape):
    key_count keys are active at once; writes to a key take unique
    ascending values; once a key takes max_writes_per_key writes it
    retires and a fresh key enters the pool."""
    state = {"next-key": key_count,
             "active": list(range(key_count)),
             "next-val": {k: 1 for k in range(key_count)},
             "writes": {k: 0 for k in range(key_count)}}

    def gen(test, ctx):
        n = random.randint(min_txn_length, max_txn_length)
        txn = []
        for _ in range(n):
            ki = random.randrange(len(state["active"]))
            k = state["active"][ki]
            if random.random() < read_p:
                txn.append(["r", k, None])
            else:
                v = state["next-val"][k]
                state["next-val"][k] = v + 1
                state["writes"][k] += 1
                txn.append([write_f, k, v])
                if state["writes"][k] >= max_writes_per_key:
                    fresh = state["next-key"]
                    state["next-key"] = fresh + 1
                    state["active"][ki] = fresh
                    state["next-val"][fresh] = 1
                    state["writes"][fresh] = 0
        return {"type": "invoke", "f": "txn", "value": txn}

    return gen
