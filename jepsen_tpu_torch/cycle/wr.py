"""Write/read register dependency inference (the port's copy of
``jepsen_tpu.cycle.wr``): the elle.rw-register
equivalent (reference jepsen/src/jepsen/tests/cycle/wr.clj delegates to
elle). Writes are assumed unique per (key, value).

Without observed version traces (unlike list-append), version order must
be *assumed* into existence. Supported inference, mirroring elle's
documented options:

- WR edges always: the writer of v -> every txn that externally read v.
- ``sequential_keys``: each key is sequentially consistent; a process
  touching version a of k before version b witnesses a < b, yielding
  WW/RW edges between their writers and readers.
- ``linearizable_keys``: each key is linearizable; derive version order
  from realtime order of the writes (completion of A before invocation
  of B). Adds WW and RW edges along that order.

Non-cycle anomalies: G1a (read a failed txn's write), G1b (read a
non-final write of some txn), ``internal`` (a txn's own reads disagree
with its preceding mops), ``lost-update`` (two committed txns both
read-modify-write the same version), and ``dirty-update`` (a committed
txn read-modify-wrote ON TOP of a failed txn's write, so the aborted
value entered the committed version chain -- elle's dirty-update).

Realtime (RT) edges are inferred by default, enabling the
strict-serializability *-realtime cycle classes; pass
``{"realtime": False}`` for plain serializability -- NOTE this default
changed in round 3: histories that are serializable but not strictly
so fail by default. Per-process order (PROC) edges and the
sequential-consistency *-process classes are OFF by default; request
them via ``{"process": True}`` or by naming a *-process anomaly."""

from __future__ import annotations

from . import (DEFAULT_ANOMALIES, RW, WR, WW, Graph, add_process_edges,
               add_realtime_edges, check_graph, invocation_times)
from .. import history as h
from ..txn import ext_reads, ext_writes, int_write_mops


def _txn(op):
    return op.get("value") or []


def infer(history, opts=None):
    """Infer the dependency graph from an rw-register history WITHOUT
    classifying cycles. Returns ``(graph, found, oks, garbage)`` --
    ``found`` maps inference-level anomaly names to witness lists,
    ``garbage`` lists reads of values nobody is known to have written.
    The streaming monitor and the service's batched probe build on
    this; ``analyze`` layers the cycle classification on top."""
    opts = opts or {}
    anomalies = tuple(opts.get("anomalies", DEFAULT_ANOMALIES))
    history = [op for op in history if op.get("f") in ("txn", None)]
    # realtime precedence needs invocation times; pair them up before
    # dropping invokes (completion-only test histories fall back to
    # treating ops as point events)
    inv_time = invocation_times(history)
    oks = [op for op in history if op.get("type") == "ok"]
    fails = [op for op in history if op.get("type") == "fail"]

    def invoked_at(op):
        return inv_time.get(id(op), op.get("time", 0))

    def precedes(a, b):
        """True realtime precedence: a completed before b was invoked."""
        return a.get("time", 0) < invoked_at(b)

    idx = {id(op): i for i, op in enumerate(oks)}
    found: dict[str, list] = {}

    writer = {}          # (k, v) -> op with final write v to k
    intermediate = {}    # (k, v) -> op which wrote v non-finally
    for op in oks:
        for k, v in ext_writes(_txn(op)).items():
            writer[(k, v)] = op
        for k, mops in int_write_mops(_txn(op)).items():
            for mop in mops:
                intermediate[(k, mop[2])] = op
    failed_writer = {}
    for op in fails:
        for k, v in ext_writes(_txn(op)).items():
            failed_writer[(k, v)] = op
    info_writer = {}
    for op in [o for o in history if o.get("type") == "info"]:
        for k, v in ext_writes(_txn(op)).items():
            info_writer[(k, v)] = op

    graph = Graph(len(oks))
    garbage = []

    # internal consistency: within one txn, a read of k must return the
    # latest preceding mop's value for k (elle's `internal` anomaly)
    for op in oks:
        seen: dict = {}
        for mop in _txn(op):
            f_, k, v = mop[0], mop[1], mop[2]
            if f_ == "r":
                if k in seen and v != seen[k]:
                    found.setdefault("internal", []).append(
                        {"key": k, "expected": seen[k], "read": v,
                         "op": dict(op)})
                if v is not None:
                    seen[k] = v
            else:
                seen[k] = v

    # lost update: two committed txns both read version v of k and both
    # write k -- each believes it replaced v (elle's `lost-update`).
    # dirty update: a committed txn read-modify-wrote on top of a
    # FAILED txn's write -- the aborted value entered the committed
    # version chain (elle's `dirty-update`; reserved-unimplemented in
    # round 3, VERDICT r3 missing #2)
    rmw: dict = {}
    for op in oks:
        reads, writes = ext_reads(_txn(op)), ext_writes(_txn(op))
        for k, v in reads.items():
            if v is not None and k in writes:
                rmw.setdefault((k, v), []).append(op)
                if (k, v) in failed_writer:
                    found.setdefault("dirty-update", []).append(
                        {"key": k, "aborted_value": v,
                         "writer": dict(failed_writer[(k, v)]),
                         "op": dict(op)})
    for (k, v), group in rmw.items():
        if len(group) >= 2:
            found.setdefault("lost-update", []).append(
                {"key": k, "value": v,
                 "ops": [dict(o) for o in group]})

    for op in oks:
        for k, v in ext_reads(_txn(op)).items():
            if v is None:
                continue
            w = writer.get((k, v))
            if w is not None:
                if w is not op:
                    graph.add(idx[id(w)], idx[id(op)], WR,
                              f"{k}: read {v} written by it")
            elif (k, v) in intermediate:
                found.setdefault("G1b", []).append(
                    {"key": k, "value": v, "op": dict(op),
                     "writer": dict(intermediate[(k, v)])})
            elif (k, v) in failed_writer:
                found.setdefault("G1a", []).append(
                    {"key": k, "value": v, "op": dict(op),
                     "writer": dict(failed_writer[(k, v)])})
            elif (k, v) in info_writer:
                # indeterminate write observed: proves it committed, but
                # the writer isn't an indexable ok txn -- no edge
                pass
            else:
                garbage.append({"key": k, "value": v, "op": dict(op)})

    if opts.get("sequential_keys"):
        # Each key is sequentially consistent: every process observes
        # versions of k in the (single) version order. A process that
        # touched version a of k before version b — across its ops OR
        # within one txn's mop order (read-then-write) — witnesses
        # a < b.
        by_process: dict = {}
        for op in oks:
            by_process.setdefault(op.get("process"), []).append(op)
        before: dict = {}   # (k, va, vb): va witnessed before vb
        for p, pops in by_process.items():
            last_seen: dict = {}
            for op in pops:
                for mop in _txn(op):
                    k, v = mop[1], mop[2]
                    if v is None:
                        continue
                    prev = last_seen.get(k)
                    if prev is not None and prev != v:
                        before[(k, prev, v)] = True
                    last_seen[k] = v
        readers: dict = {}   # (k, v) -> ops that externally read v
        for op in oks:
            for k, v in ext_reads(_txn(op)).items():
                readers.setdefault((k, v), []).append(op)
        for (k, va, vb) in before:
            a, b = writer.get((k, va)), writer.get((k, vb))
            if a is not None and b is not None and a is not b:
                graph.add(idx[id(a)], idx[id(b)], WW,
                          f"{k}: {va} observed before {vb} "
                          "(sequential-keys)")
            # anyone who read va anti-depends on vb's writer
            if b is not None:
                for op in readers.get((k, va), ()):
                    if op is not b:
                        graph.add(idx[id(op)], idx[id(b)], RW,
                                  f"{k}: read {va}; {vb} written after "
                                  "(sequential-keys)")

    if opts.get("linearizable_keys"):
        # Under per-key linearizability the version order embeds the
        # realtime order, so a->b edges are sound exactly when a
        # *completed* before b was *invoked*; genuinely concurrent
        # writes get no edge (ordering them by completion time alone
        # manufactures false cycles).
        by_key: dict = {}
        for op in oks:
            for k in ext_writes(_txn(op)):
                by_key.setdefault(k, []).append(op)
        for k, writers in by_key.items():
            for a in writers:
                for b in writers:
                    if a is not b and precedes(a, b):
                        graph.add(idx[id(a)], idx[id(b)], WW,
                                  f"{k}: write realtime order "
                                  "(linearizable-keys)")
        # RW: a read of a's version anti-depends on every write
        # realtime-after a (all their versions are later than a's)
        for op in oks:
            for k, v in ext_reads(_txn(op)).items():
                a = writer.get((k, v))
                if a is None:
                    continue
                for b in by_key.get(k, ()):
                    if b is not a and b is not op and precedes(a, b):
                        graph.add(idx[id(op)], idx[id(b)], RW,
                                  f"{k}: read {v}, overwritten by a "
                                  "realtime-later write")

    if opts.get("realtime", True):
        # strict-serializability: a completed-before-invoked pair is
        # realtime-ordered; cycles needing these edges become the
        # *-realtime anomaly classes
        # unlike linearizable_keys' precedes() (whose point-event
        # fallback is documented, opt-in behavior), RT edges are only
        # added where BOTH a real invocation and a real completion
        # time were witnessed (op.get("time") is None otherwise)
        add_realtime_edges(graph, oks,
                           lambda op: op.get("time"),
                           lambda op: inv_time.get(id(op)),
                           skew_bound=opts.get(
                               "skew-bound", opts.get("skew_bound", 0)))

    if opts.get("process") or any(a.endswith("-process")
                                  for a in anomalies):
        # sequential consistency: each process's own op order; cycles
        # needing these edges become the *-process classes (off by
        # default, like elle's :sequential analysis)
        add_process_edges(graph, oks)

    return graph, found, oks, garbage


def analyze(history, opts=None, device=None) -> dict:
    """Infer and classify; closures of graphs of more than 64 txns run
    on ``device`` (None: CUDA)."""
    opts = opts or {}
    anomalies = tuple(opts.get("anomalies", DEFAULT_ANOMALIES))
    graph, found, oks, garbage = infer(history, opts)
    res = check_graph(graph, oks, anomalies, device)
    res["anomalies"].update(found)
    res["anomaly_types"] = sorted(set(res["anomaly_types"]) | set(found))
    if res["anomaly_types"]:
        res["valid"] = False
    elif garbage:
        # reads observed values nobody is known to have written
        res["valid"] = "unknown"
        res["anomalies"]["garbage-read"] = garbage
    return res


def check(history, opts=None, device=None) -> dict:
    res = analyze(h.complete(history), opts, device)
    res["valid?"] = res["valid"]
    return res
