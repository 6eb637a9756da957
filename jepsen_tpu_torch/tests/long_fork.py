"""Long-fork anomaly workload: concurrent writes observed in conflicting
orders, legal under parallel snapshot isolation but banned by SI proper
(reference jepsen/src/jepsen/tests/long_fork.clj, 332 LoC; doc:1-88;
the port's copy of ``jepsen_tpu/tests/long_fork.py``). Host-only.

Writes are single-key inserts ``[["w", k, 1]]`` with globally unique
keys; reads scan a key's whole *group* (n consecutive keys). Two reads
of the same group fork when each observes a write the other missed."""

from __future__ import annotations

import random

from .. import generator as gen
from ..checker.core import Checker
from ..history import invoke as is_invoke, ok as is_ok


def group_for(n, k):
    """The n-key group containing k: [l, l+n) (long_fork.clj:97-104)."""
    lo = k - (k % n)
    return list(range(lo, lo + n))


def read_txn_for(n, k):
    """A txn reading k's whole group in shuffled order
    (long_fork.clj:106-112)."""
    ks = group_for(n, k)
    random.shuffle(ks)
    return [["r", k2, None] for k2 in ks]


class Generator(gen.Generator):
    """Single fresh-key writes, each followed by a group read from the
    same worker, mixed with reads of other in-flight groups
    (long_fork.clj:117-156)."""

    def __init__(self, n, next_key=0, workers=None):
        self.n = n
        self.next_key = next_key
        self.workers = workers or {}

    def update(self, test, ctx, event):
        return self

    def op(self, test, ctx):
        process = ctx.some_free_process()
        if process is None:
            return gen.PENDING, self
        worker = ctx.process_to_thread(process)
        k = self.workers.get(worker)
        if k is not None:
            op = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, k)}, ctx)
            return op, Generator(self.n, self.next_key,
                                 {**self.workers, worker: None})
        active = [v for v in self.workers.values() if v is not None]
        if active and random.random() < 0.5:
            op = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, random.choice(active))},
                ctx)
            return op, self
        k = self.next_key
        op = gen.fill_in_op(
            {"process": process, "f": "write", "value": [["w", k, 1]]},
            ctx)
        return op, Generator(self.n, k + 1, {**self.workers, worker: k})


def generator(n):
    return Generator(n)


class IllegalHistory(Exception):
    def __init__(self, info):
        super().__init__(info.get("msg", "illegal history"))
        self.info = info


def read_compare(a, b):
    """-1 if read-state a dominates, 0 equal, 1 if b dominates, None if
    incomparable — the fork signal (long_fork.clj:158-196)."""
    if set(a) != set(b):
        raise IllegalHistory(
            {"type": "illegal-history", "reads": [a, b],
             "msg": "these reads did not query the same keys"})
    res = 0
    for k in a:
        va, vb = a[k], b[k]
        if va == vb:
            continue
        if vb is None:          # a saw more here
            if res > 0:
                return None
            res = -1
        elif va is None:        # b saw more here
            if res < 0:
                return None
            res = 1
        else:
            raise IllegalHistory(
                {"type": "illegal-history", "key": k, "reads": [a, b],
                 "msg": "distinct values for one key; this checker "
                        "assumes a single write per key"})
    return res


def read_op_value_map(op):
    return {k: v for _, k, v in op["value"]}


def find_forks(ops):
    """All mutually incomparable read pairs (long_fork.clj:216-224)."""
    forks = []
    for i, a in enumerate(ops):
        for b in ops[i + 1:]:
            if read_compare(read_op_value_map(a),
                            read_op_value_map(b)) is None:
                forks.append([a, b])
    return forks


def is_read_txn(txn):
    return all(m[0] == "r" for m in txn)


def is_write_txn(txn):
    return len(txn) == 1 and txn[0][0] == "w"


def _groups(n, read_ops):
    """Partition reads by observed key-group; each must be exactly n keys
    (long_fork.clj:248-261)."""
    by_group = {}
    for op in read_ops:
        ks = frozenset(m[1] for m in op["value"])
        if len(ks) != n:
            raise IllegalHistory(
                {"type": "illegal-history", "op": op,
                 "msg": f"every read should observe exactly {n} keys, "
                        f"got {len(ks)}"})
        by_group.setdefault(ks, []).append(op)
    return list(by_group.values())


class _LongForkChecker(Checker):
    """valid iff no key is written twice and no read pair forks
    (long_fork.clj:311-324)."""

    def __init__(self, n):
        self.n = n

    def check(self, test, history, opts=None):
        reads = [op for op in history
                 if is_ok(op) and is_read_txn(op.get("value") or [])]
        vals = [op["value"] for op in reads]
        out = {
            "reads-count": len(reads),
            "early-read-count": sum(
                1 for txn in vals if not any(m[2] for m in txn)),
            "late-read-count": sum(
                1 for txn in vals if all(m[2] for m in txn)),
        }
        # multiple writes to one key -> unknown (long_fork.clj:273-288)
        seen = set()
        for op in history:
            if is_invoke(op) and is_write_txn(op.get("value") or []):
                k = op["value"][0][1]
                if k in seen:
                    out.update(valid="unknown",
                               error=["multiple-writes", k])
                    out["valid?"] = out["valid"]
                    return out
                seen.add(k)
        try:
            forks = []
            for grp in _groups(self.n, reads):
                forks.extend(find_forks(grp))
        except IllegalHistory as e:
            out.update(valid="unknown", error=e.info)
            out["valid?"] = out["valid"]
            return out
        if forks:
            out.update(valid=False, forks=forks)
        else:
            out["valid"] = True
        out["valid?"] = out["valid"]
        return out


def checker(n):
    return _LongForkChecker(n)


def workload(n=2):
    """Checker + generator bundle; n = group size
    (long_fork.clj:326-332)."""
    return {"checker": checker(n), "generator": generator(n)}
