"""List-append workload (reference jepsen/src/jepsen/tests/cycle/
append.clj:11-57; the port's copy of
``jepsen_tpu/tests/cycle/append.py``). Clients execute txns of ``["append", k, v]`` /
``["r", k, None]`` mops, filling reads with the full list observed."""

from __future__ import annotations

from . import checker as _checker, txn_generator
from ...cycle import append as engine


def checker(opts=None):
    """Checker over append histories (append.clj:11-22). Options:
    anomalies (default G0/G1c/G-single/G2), device (where the closures
    run; None: CUDA)."""
    return _checker(engine.check, opts)


def gen(opts=None):
    opts = opts or {}
    return txn_generator(
        key_count=opts.get("key-count", 3),
        min_txn_length=opts.get("min-txn-length", 1),
        max_txn_length=opts.get("max-txn-length", 4),
        max_writes_per_key=opts.get("max-writes-per-key", 32),
        write_f="append")


def test(opts=None):
    """Partial test bundle: generator + checker; you supply the client
    (append.clj:28-57)."""
    return {"generator": gen(opts), "checker": checker(opts)}
