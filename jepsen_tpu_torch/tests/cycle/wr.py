"""Write/read register txn workload (reference jepsen/src/jepsen/tests/
cycle/wr.clj; the port's copy of ``jepsen_tpu/tests/cycle/wr.py``).
Writes are unique; reads fill in the value seen."""

from __future__ import annotations

from . import checker as _checker, txn_generator
from ...cycle import wr as engine


def checker(opts=None):
    """Checker over wr histories (wr.clj:14-41). Options: anomalies,
    linearizable_keys (infer per-key version order from realtime write
    order), device (where the closures run; None: CUDA)."""
    return _checker(engine.check, opts)


def gen(opts=None):
    opts = opts or {}
    return txn_generator(
        key_count=opts.get("key-count", 3),
        min_txn_length=opts.get("min-txn-length", 1),
        max_txn_length=opts.get("max-txn-length", 4),
        max_writes_per_key=opts.get("max-writes-per-key", 32),
        write_f="w")


def test(opts=None):
    return {"generator": gen(opts), "checker": checker(opts)}
