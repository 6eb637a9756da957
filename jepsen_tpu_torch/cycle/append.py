"""List-append dependency inference (the port's copy of
``jepsen_tpu.cycle.append``): the elle.list-append equivalent
(reference jepsen/src/jepsen/tests/cycle/append.clj delegates to elle;
algorithm reconstructed from Adya's formalism + elle's public docs).

Transactions are lists of mops ``["append", k, v]`` / ``["r", k, list]``.
Appends are unique per key, so every observed list is a *trace* of the
key's version history:

- version order per key  = the longest observed read (all reads must be
  prefix-compatible or the history is immediately invalid), extended
  past the last read via within-txn append adjacency (a txn's
  consecutive appends to one key are adjacent versions)
- WW  A -> B   when B appended the element right after A's in the order
- WR  A -> R   when R's (external) read of k ends in A's element
- RW  R -> B   when B appended the element right after the last one R saw

Non-cycle anomalies caught during inference (elle's names):

- incompatible-order  two reads of a key disagree beyond prefixing
- duplicates          the same element appears twice in one read
- cyclic-versions     the version-order inference sources (observed
                      read prefixes + within-txn append adjacency)
                      contradict each other: their union graph has a
                      cycle, so no total version order exists
- G1a aborted-read    a read observed an element appended by a failed txn
- G1b intermediate-read  a read's last element is a txn's *non-final*
                      append to that key
- dirty-update        rw-register only (cycle/wr.py implements it;
                      appends of aborted values are G1a here)
"""

from __future__ import annotations

from . import (DEFAULT_ANOMALIES, RW, WR, WW, Graph, add_process_edges,
               add_realtime_edges, check_graph, invocation_times)
from .. import history as h


def _txn(op):
    return op.get("value") or []


def _external_reads(txn):
    """(k, list) for each read of k occurring before any append of k in
    this txn (internal reads — after own appends — observe own effects
    and aren't evidence about other txns)."""
    out = []
    appended = set()
    for mop in txn:
        f, k, v = mop[0], mop[1], mop[2]
        if f == "r":
            if k not in appended and v is not None:
                out.append((k, list(v)))
        else:
            appended.add(k)
    return out


def _appends(txn):
    """(k, v) for each append, in txn order."""
    return [(mop[1], mop[2]) for mop in txn if mop[0] == "append"]


def _value_cycle(edges):
    """One cycle (as a value list, first == last) in a small directed
    graph given as {v: set(successors)}, or None. Iterative
    three-color DFS."""
    nodes = set(edges)
    for succ in edges.values():
        nodes |= set(succ)
    color = dict.fromkeys(nodes, 0)          # 0 white, 1 gray, 2 black
    for root in nodes:
        if color[root]:
            continue
        color[root] = 1
        stack = [(root, iter(edges.get(root, ())))]
        path = [root]
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if color[nxt] == 1:          # back edge: cycle
                    return path[path.index(nxt):] + [nxt]
                if color[nxt] == 0:
                    color[nxt] = 1
                    stack.append((nxt, iter(edges.get(nxt, ()))))
                    path.append(nxt)
                    break
            else:
                color[node] = 2
                stack.pop()
                path.pop()
    return None


def infer(history, anomalies=DEFAULT_ANOMALIES,
          realtime=True, process=False, skew_bound=0):
    """Infer the dependency graph from an append history WITHOUT
    classifying cycles. Returns ``(graph, found, oks)`` where ``found``
    maps inference-level anomaly names (duplicates, incompatible-order,
    cyclic-versions, G1a, G1b, garbage-read) to witness lists and
    ``oks`` indexes the graph's nodes. The streaming monitor and the
    service's batched probe build on this; ``analyze`` layers the cycle
    classification on top. ``skew_bound`` (history time units) gates RT
    edges on the realtime gap exceeding the recovered clock-offset
    bound."""
    history = [op for op in history if op.get("f") in ("txn", None)]
    inv_time = invocation_times(history)
    oks = [op for op in history if op.get("type") == "ok"]
    fails = [op for op in history if op.get("type") == "fail"]
    infos = [op for op in history if op.get("type") == "info"]

    idx = {id(op): i for i, op in enumerate(oks)}
    found: dict[str, list] = {}

    def note(kind, item):
        found.setdefault(kind, []).append(item)

    # writer maps: element (k, v) -> (owner kind, op, final?) -- among ok
    # txns; failed/info appends tracked for G1a / indeterminacy
    writer = {}
    intermediate = {}
    txn_succ = {}
    for op in oks:
        per_key = {}
        for k, v in _appends(_txn(op)):
            writer[(k, v)] = op
            per_key.setdefault(k, []).append(v)
        for k, vs in per_key.items():
            for v in vs[:-1]:
                intermediate[(k, v)] = op
            # txns are atomic, so a txn's consecutive appends to one key
            # are *adjacent* in the key's version order
            for v1, v2 in zip(vs, vs[1:]):
                txn_succ.setdefault(k, {})[v1] = v2
    failed_writer = {}
    for op in fails:
        for k, v in _appends(_txn(op)):
            failed_writer[(k, v)] = op
    info_writer = {}
    for op in infos:
        for k, v in _appends(_txn(op)):
            info_writer[(k, v)] = op

    # observed reads per key
    reads_by_key: dict = {}
    for op in oks:
        for k, lst in _external_reads(_txn(op)):
            reads_by_key.setdefault(k, []).append((op, lst))
            if len(set(lst)) != len(lst):
                note("duplicates", {"op": dict(op), "key": k,
                                    "read": lst})

    # version order per key from the longest read; prefix-compatibility
    version_order: dict = {}
    for k, reads in reads_by_key.items():
        longest = max((lst for _, lst in reads), key=len)
        for op, lst in reads:
            if lst != longest[:len(lst)]:
                note("incompatible-order",
                     {"key": k, "read": lst, "longest": longest,
                      "op": dict(op)})
        version_order[k] = list(longest)

    # extend each order past the last read using within-txn adjacency, so
    # tail appends no read observed still contribute WW/RW edges. Residual
    # gap vs elle: append chains never touching the observed prefix stay
    # unordered and contribute no edges (documented incompleteness; no
    # false positives either way).
    for k, order in version_order.items():
        succ = txn_succ.get(k, {})
        seen = set(order)
        while order and order[-1] in succ and succ[order[-1]] not in seen:
            nxt = succ[order[-1]]
            order.append(nxt)
            seen.add(nxt)
        # adjacency that contradicts the observed order is an anomaly in
        # its own right: v2 must sit directly after v1, so either it's
        # elsewhere in the order, or v1 has a non-final position while v2
        # was never observed at all
        pos = {v: i for i, v in enumerate(order)}
        for v1, v2 in succ.items():
            if v1 not in pos:
                continue
            nxt_pos = pos.get(v2)
            bad = (nxt_pos != pos[v1] + 1 if nxt_pos is not None
                   else pos[v1] < len(order) - 1)
            if bad:
                note("incompatible-order",
                     {"key": k, "txn-adjacent": [v1, v2],
                      "observed": order})

    # cyclic inferred version orders: the union of the inference
    # sources (observed-read consecutive pairs + within-txn adjacency)
    # must embed in a total order per key; a cycle means they
    # contradict -- e.g. a txn appending the same element twice, or
    # adjacency chains closing on the observed prefix (elle's
    # cyclic-versions; VERDICT r3 next #5)
    for k in set(version_order) | set(txn_succ):
        edges: dict = {}
        order = version_order.get(k, [])
        for a, b in zip(order, order[1:]):
            edges.setdefault(a, set()).add(b)
        for a, b in txn_succ.get(k, {}).items():
            edges.setdefault(a, set()).add(b)
        cyc = _value_cycle(edges)
        if cyc is not None:
            note("cyclic-versions", {"key": k, "cycle": cyc})

    graph = Graph(len(oks))

    for k, order in version_order.items():
        # WW: consecutive observed appends
        for a, b in zip(order, order[1:]):
            wa, wb = writer.get((k, a)), writer.get((k, b))
            if wa is not None and wb is not None and wa is not wb:
                graph.add(idx[id(wa)], idx[id(wb)], WW,
                          f"{k}: append {a} precedes append {b}")
        # aborted / garbage reads
        for v in order:
            if (k, v) in writer or (k, v) in info_writer:
                continue
            if (k, v) in failed_writer:
                note("G1a", {"key": k, "value": v,
                             "writer": dict(failed_writer[(k, v)])})
            else:
                note("garbage-read", {"key": k, "value": v})

    for op in oks:
        for k, lst in _external_reads(_txn(op)):
            order = version_order.get(k, [])
            if lst:
                last = lst[-1]
                w = writer.get((k, last))
                if w is not None and w is not op:
                    graph.add(idx[id(w)], idx[id(op)], WR,
                              f"{k}: read ends in {last} appended by it")
                if (k, last) in intermediate and \
                        intermediate[(k, last)] is not op:
                    note("G1b", {"key": k, "value": last,
                                 "op": dict(op),
                                 "writer": dict(intermediate[(k, last)])})
            # RW: whoever appended the next version overwrote what we saw
            pos = len(lst)
            if pos < len(order):
                nxt = order[pos]
                wn = writer.get((k, nxt))
                if wn is not None and wn is not op:
                    graph.add(idx[id(op)], idx[id(wn)], RW,
                              f"{k}: read ended at {lst[-1] if lst else '[]'}"
                              f"; {nxt} was appended next")

    if realtime:
        # RT edges only where both endpoints' times were witnessed
        # (a missing completion time must not order an op before
        # everything -- advisor finding r3)
        add_realtime_edges(
            graph, oks, lambda op: op.get("time"),
            lambda op: inv_time.get(id(op)), skew_bound=skew_bound)

    if process or any(a.endswith("-process") for a in anomalies):
        add_process_edges(graph, oks)

    return graph, found, oks


def analyze(history, anomalies=DEFAULT_ANOMALIES,
            realtime=True, process=False, skew_bound=0,
            device=None) -> dict:
    """Infer the dependency graph from an append history and classify its
    anomalies. Returns the check_graph result plus inference-level
    anomalies. ``realtime`` adds RT (completed-before-invoked) edges,
    enabling the strict-serializability *-realtime classes;
    ``process`` adds per-process order edges, enabling the
    sequential-consistency *-process classes (off by default, and
    auto-enabled when a *-process anomaly is requested). The closures
    of graphs of more than 64 txns run on ``device`` (None: CUDA)."""
    graph, found, oks = infer(history, anomalies, realtime, process,
                              skew_bound)
    res = check_graph(graph, oks, anomalies, device)
    res["anomalies"].update(found)
    res["anomaly_types"] = sorted(set(res["anomaly_types"]) |
                                  (set(found) - {"garbage-read"}))
    if res["anomaly_types"]:
        res["valid"] = False
    elif found.get("garbage-read"):
        # reads observed elements nobody is known to have appended --
        # could be a concurrent info txn we can't index; indeterminate
        res["valid"] = "unknown"
        res["anomalies"]["garbage-read"] = found["garbage-read"]
    return res


def check(history, opts=None, device=None) -> dict:
    """Checker entry: complete invoke/ok pairs are analyzed (closures on
    ``device``, None: CUDA); returns
    {"valid": ..., "anomaly_types": [...], "anomalies": {...}}."""
    opts = opts or {}
    anomalies = tuple(opts.get("anomalies", DEFAULT_ANOMALIES))
    res = analyze(h.complete(history), anomalies,
                  realtime=opts.get("realtime", True),
                  process=opts.get("process", False),
                  skew_bound=opts.get("skew-bound",
                                      opts.get("skew_bound", 0)),
                  device=device)
    res["valid?"] = res["valid"]
    return res
