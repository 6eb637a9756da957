"""Transaction micro-op utilities (the port's copy of ``jepsen_tpu.txn``;
reference txn/src/jepsen/txn.clj:5-73
and txn/micro_op.clj:6-35).

A transaction is an op whose value is a list of micro-ops (*mops*), each
``[f, k, v]`` — e.g. ``["r", "x", 3]`` or ``["append", "y", 7]``."""

from __future__ import annotations

# -- micro-op accessors (micro_op.clj:6-35) ---------------------------------

def f(mop):
    return mop[0]


def key(mop):
    return mop[1]


def value(mop):
    return mop[2]


def is_read(mop) -> bool:
    return mop[0] == "r"


def is_write(mop) -> bool:
    return mop[0] == "w"


def is_mop(mop) -> bool:
    return len(mop) == 3 and mop[0] in ("r", "w")


# -- transaction reductions (txn.clj:5-73) ----------------------------------

def reduce_mops(fn, init_state, history):
    """Fold fn(state, op, mop) over every micro-op of every op's txn
    (txn.clj:5-17)."""
    state = init_state
    for op in history:
        for mop in op.get("value") or ():
            state = fn(state, op, mop)
    return state


def op_mops(history):
    """All (op, mop) pairs from a history, lazily (txn.clj:19-22)."""
    for op in history:
        for mop in op.get("value") or ():
            yield op, mop


def ext_reads(txn) -> dict:
    """Keys -> values this txn observed and did not itself write first
    (txn.clj:24-39): only the first access to a key counts, and only if
    it's a read."""
    ext = {}
    seen = set()
    for mop in txn:
        fk, k, v = mop[0], mop[1], mop[2]
        if fk == "r" and k not in seen:
            ext[k] = v
        seen.add(k)
    return ext


def ext_writes(txn) -> dict:
    """Keys -> final values written by this txn (txn.clj:41-53): the last
    write to each key wins."""
    ext = {}
    for mop in txn:
        if mop[0] != "r":
            ext[mop[1]] = mop[2]
    return ext


def int_write_mops(txn) -> dict:
    """Keys -> lists of non-final write mops to that key (txn.clj:55-73);
    keys with a single write are omitted."""
    writes = {}
    for mop in txn:
        if mop[0] != "r":
            writes.setdefault(mop[1], []).append(mop)
    return {k: vs[:-1] for k, vs in writes.items() if len(vs) > 1}
