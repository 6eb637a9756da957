"""searchplan: the execution half of static search planning -- slice
one history at sealed quiescent cuts into sequential segments that are
checked in isolation, and merge their results back into one verdict (a
copy of the parts of ``jepsen_tpu/analysis/searchplan.py`` that the
checkers run).

Quiescent points -- instants with zero open invocations -- let a history
slice into *sequential* segments ("Efficient Decrease-and-Conquer
Linearizability Monitoring", arxiv 2410.04581).

**Quiescent-cut soundness.** Slicing a state-carrying model at a
quiescent instant is only sound when the state at the cut is statically
known. The rule used here ("sealed cut"): a quiescent instant ``c`` is a
valid cut iff the last-invoked non-pure op ``w`` before ``c`` (if any)

  1. completed ``:ok``,
  2. has ``f`` in the model's ``seal_fs`` -- ops that are *total*
     (steppable from every state) and *state-oblivious* (the post-state
     depends only on the op, e.g. a register write), and
  3. every other non-pure op before ``c`` returns before ``w`` invokes
     (so every linearization of the prefix puts ``w`` after all other
     state-changing ops).

Then the state after ANY linearization of the prefix is exactly
``step(., w)``, so the suffix checks in isolation *seeded with the real
completed pair w* (which real-time precedence forces first). The full
history is linearizable iff every segment is. A model that declares no
``seal_fs``/``pure_fs`` gets no cuts.

**Search-dead elision.** A non-``:ok`` *pure* op with fully-unknown
arguments and results (e.g. a crashed read) is unconstrained: it never
must linearize, never changes state, and always steps ok, so it is
elided before cut detection (an open crashed read would otherwise poison
every later quiescent instant).

Unlike the JAX package's ``plan_segments``, a fault of the planner here
raises instead of degrading to one unsegmented segment: a wrong plan must
not hide behind a slower check. The plan report of record
(``build_plan``, ``SearchPlan``) and the partition predicates
(``per_key_parts``, ``per_value_parts``) wait for the host harness
(ROADMAP.md queue A.11).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import history as h

__all__ = ["DEFAULT_PREDICATES", "MIN_SEGMENT_OPS", "Segment",
           "segment_events", "plan_segments", "stream_cut",
           "merge_segment_results", "enabled", "segments_enabled",
           "min_segment", "predicate_names"]

#: predicates applied by default: the per-key split plus quiescent
#: crash-isolated segmentation
DEFAULT_PREDICATES = ("per-key", "crash-segments")

#: minimum non-elided ops per segment: cuts below this coalesce so tiny
#: histories aren't shredded into per-op searches. Override per test with
#: ``test["searchplan-min-segment"]``.
MIN_SEGMENT_OPS = 8

#: config-count estimate exponent cap
_EST_EXP_CAP = 30


def enabled(test):
    """Is search planning on for this test map? (default: yes)"""
    return bool(isinstance(test, dict) and test.get("searchplan?", True))


def segments_enabled(test):
    """Is quiescent-cut segmentation on for this test map? Planning must
    be enabled AND the crash-segments predicate requested."""
    return enabled(test) and "crash-segments" in predicate_names(test)


def min_segment(test):
    ms = (test or {}).get("searchplan-min-segment") \
        if isinstance(test, dict) else None
    if isinstance(ms, int) and not isinstance(ms, bool) and ms > 0:
        return ms
    return MIN_SEGMENT_OPS


def predicate_names(test):
    """The predicate list a test requests (default DEFAULT_PREDICATES)."""
    names = (test or {}).get("searchplan-partitions") \
        if isinstance(test, dict) else None
    if names is None:
        return list(DEFAULT_PREDICATES)
    return [str(n) for n in names]


# ---------------------------------------------------------------------------
# logical-op rows

@dataclasses.dataclass
class _Row:
    """One logical op (invoke/completion pair) of a client history."""

    inv: dict
    comp: dict          # None when the op never completed
    invoke_idx: int
    return_idx: int     # h.INF_TIME for info/open ops
    f: object
    ok: bool
    pure: bool
    elide: bool


def _pure_seal(spec):
    """(pure_fs, seal_fs) name sets from a ModelSpec; empty sets when the
    model declares none (no cuts, no elision -- always sound)."""
    pure = set(getattr(spec, "pure_fs", None) or ())
    seal = set(getattr(spec, "seal_fs", None) or ())
    return pure, seal


def _rows(spec, events):
    """Pair an (indexed, client-only) event list into logical-op rows
    sorted by invocation index. Failed ops are dropped (the encoder drops
    them too); their count returns alongside."""
    pure, _ = _pure_seal(spec)
    rows = []
    failed = 0
    for inv, comp in h.pairs(events):
        if inv is None:
            continue            # bare completion: not a logical client op
        if comp is not None and comp.get("type") == h.FAIL:
            failed += 1
            continue
        ok = comp is not None and comp.get("type") == h.OK
        ret = int(comp["index"]) if ok else h.INF_TIME
        f = inv.get("f")
        is_pure = f in pure
        elide = (not ok) and is_pure and inv.get("value") is None \
            and (comp is None or comp.get("value") is None)
        rows.append(_Row(inv, comp, int(inv["index"]), ret, f, ok,
                         is_pure, elide))
    rows.sort(key=lambda r: r.invoke_idx)
    return rows, failed


def _cut_positions(spec, rows):
    """Valid sealed quiescent cuts over non-elided ``rows`` (already
    sorted by invoke). Returns a list of (position, seed_position): the
    cut falls between rows[position] and rows[position+1]; the suffix
    segment is seeded with rows[seed_position]'s completed pair, or
    inherits the initial state when seed_position is None."""
    _, seal = _pure_seal(spec)
    cuts = []
    max_ret = -1            # over all rows so far
    np_max_ret = -1         # over non-pure rows so far
    last_np = None          # position of last non-pure row
    last_np_sealed = False
    for i, r in enumerate(rows):
        if not r.pure:
            # seal condition 3: every earlier non-pure op returns before
            # this one invokes
            others_done = np_max_ret < r.invoke_idx
            last_np = i
            last_np_sealed = bool(r.ok and r.f in seal and others_done)
            np_max_ret = max(np_max_ret, r.return_idx)
        max_ret = max(max_ret, r.return_idx)
        if i + 1 >= len(rows):
            break
        if max_ret >= rows[i + 1].invoke_idx:
            continue        # not quiescent: some op is still open
        if last_np is None:
            cuts.append((i, None))      # state-untouched prefix
        elif last_np_sealed:
            cuts.append((i, last_np))
    return cuts


@dataclasses.dataclass
class Segment:
    """One sequential sub-search of a part: the events to encode (seed
    pair included), ready for ``spec.encode``."""

    events: list
    rows: int               # non-elided logical ops (seed excluded)
    seed: dict              # sealing invoke op, or None for segment 0
    est_configs: int = 0


def segment_events(spec, events, min_segment=MIN_SEGMENT_OPS):
    """Slice one part's (client-only, indexed) event list at sealed
    quiescent cuts. Returns (segments, info): ``segments`` is a list of
    Segment -- length 1 when no reduction applies -- and ``info`` carries
    {"cuts", "elided", "failed_dropped", "rows"}."""
    rows, failed = _rows(spec, events)
    live = [r for r in rows if not r.elide]
    elided = len(rows) - len(live)
    info = {"cuts": 0, "elided": elided, "failed_dropped": failed,
            "rows": len(live)}
    if not live:
        return [Segment(list(events), 0, None)], info

    cuts = _cut_positions(spec, live)
    # coalesce: a cut fires only once min_segment rows accumulated on its
    # left (the remainder always forms the final segment, however small)
    chosen = []
    start = 0
    for pos, seed in cuts:
        if pos + 1 - start >= max(1, min_segment) \
                and len(live) - (pos + 1) >= 1:
            chosen.append((pos, seed))
            start = pos + 1
    info["cuts"] = len(chosen)

    def seg_events(seg_rows, seed_row):
        evs = []
        if seed_row is not None:
            evs += [seed_row.inv, seed_row.comp]
        for r in seg_rows:
            evs.append(r.inv)
            if r.comp is not None:
                evs.append(r.comp)
        evs.sort(key=lambda o: o["index"])
        return evs

    def emit(seg_rows, seed_row):
        with_seed = ([seed_row] + seg_rows) if seed_row is not None \
            else seg_rows
        seg = Segment(seg_events(seg_rows, seed_row), len(seg_rows),
                      None if seed_row is None else dict(seed_row.inv))
        seg.est_configs = _estimate_rows(with_seed)
        return seg

    segments = []
    start = 0
    seed_row = None
    for pos, seed in chosen:
        segments.append(emit(live[start:pos + 1], seed_row))
        seed_row = live[seed] if seed is not None else None
        start = pos + 1
    segments.append(emit(live[start:], seed_row))
    return segments, info


def _estimate(inv, ret, n_ok):
    """``n_ok * 2^(C-1)`` with C the max point-concurrency."""
    if not inv:
        return 0
    from ..checker.torch_wgl import max_point_concurrency
    C = max_point_concurrency(np.asarray(inv, np.int64),
                              np.asarray(ret, np.int64))
    return max(1, n_ok) * (1 << min(int(C) - 1, _EST_EXP_CAP))


def _estimate_rows(rows):
    """The config-count estimate of a segment's already-paired rows, for
    ordering plans."""
    return _estimate([r.invoke_idx for r in rows],
                     [r.return_idx for r in rows],
                     sum(1 for r in rows if r.ok))


def plan_segments(spec, client_events, min_seg=MIN_SEGMENT_OPS):
    """Execution-side entry: segment one part's prepared client history.
    Returns (segments, info) like ``segment_events``; a planner fault
    raises."""
    return segment_events(spec, client_events, min_seg)


def merge_segment_results(results, info=None, plan_s=0.0,
                          engine="jax-wgl"):
    """Fold one part's per-segment engine results into a single result
    dict shaped like an unplanned check: validity merges worst-wins
    (every segment must linearize), configs sum, and an invalid verdict
    carries the failing segment's witness fields."""
    from ..checker.core import merge_valid
    valid = merge_valid([r.get("valid") for r in results])
    out = {"valid": valid, "engine": engine,
           "configs_explored": sum(int(r.get("configs_explored") or 0)
                                   for r in results),
           "iterations": max((int(r.get("iterations") or 0)
                              for r in results), default=0),
           "searchplan": {"segments": len(results),
                          **({"cuts": info.get("cuts", 0),
                              "elided": info.get("elided", 0)}
                             if info else {}),
                          "plan_s": round(plan_s, 6)}}
    # every segment's normalized witness, segment provenance included:
    # the certifier re-certifies each segment against a replanned cut
    wits = [r.get("witness") for r in results]
    if any(isinstance(w, dict) for w in wits):
        out["witnesses"] = wits
    if valid is False:
        for i, r in enumerate(results):
            if r.get("valid") is False:
                for k in ("op", "final_paths", "previous_ok", "configs",
                          "pattern", "error", "witness"):
                    if k in r:
                        out[k] = r[k]
                out["searchplan"]["failed_segment"] = i
                break
    elif valid == "unknown":
        errs = [r.get("error") for r in results
                if r.get("valid") == "unknown" and r.get("error")]
        if errs:
            out["error"] = errs[0]
    return out


# ---------------------------------------------------------------------------
# streaming support: the latest sealed quiescent cut of an encoded prefix

def stream_cut(spec, e):
    """The latest sealed quiescent cut of a materialized encoded prefix.
    Returns (cut_invoke_idx, seed_invoke_idx | None) -- keep rows
    invoking at/after ``cut_invoke_idx`` plus the seed row -- or None
    when no cut applies. *Settled* elidable rows (a completed ``:info``
    pure op with unknown args/result) are invisible to the sweep; rows
    still OPEN are never elidable and block every later cut."""
    n = len(e)
    if n < 2:
        return None
    pure, seal = _pure_seal(spec)
    codes = getattr(spec, "f_codes", None) or {}
    pure_c = {codes[f] for f in pure if f in codes}
    seal_c = {codes[f] for f in seal if f in codes}
    inv = np.asarray(e.invoke_idx, np.int64)
    ret = np.asarray(e.return_idx, np.int64)
    ok = np.asarray(e.is_ok, bool)
    fc = np.asarray(e.f, np.int32)
    args = np.asarray(e.args, np.int32).reshape(n, -1)
    rets = np.asarray(e.ret, np.int32).reshape(n, -1)
    is_pure = np.isin(fc, sorted(pure_c)) if pure_c \
        else np.zeros(n, bool)
    # settled = the completion event arrived (ops rows carry the pair);
    # without the pairs every row is treated as open
    if e.ops is not None:
        settled = np.asarray([comp is not None for _, comp in e.ops],
                             bool)
    else:
        settled = ok.copy()
    elide = (~ok) & settled & is_pure & (args == h.NIL).all(axis=1) \
        & (rets == h.NIL).all(axis=1)
    order = np.argsort(inv, kind="stable")
    best = None
    max_ret = -1
    np_max_ret = -1
    seed = None
    seed_sealed = False
    live = [int(i) for i in order if not elide[i]]
    for pos, i in enumerate(live):
        if not is_pure[i]:
            others_done = np_max_ret < int(inv[i])
            seed = i
            seed_sealed = bool(ok[i]) and int(fc[i]) in seal_c \
                and others_done
            np_max_ret = max(np_max_ret, int(ret[i]))
        max_ret = max(max_ret, int(ret[i]))
        if pos + 1 >= len(live):
            break
        nxt = live[pos + 1]
        if max_ret >= int(inv[nxt]):
            continue
        if seed is None:
            best = (int(inv[nxt]), None)
        elif seed_sealed:
            best = (int(inv[nxt]), int(inv[seed]))
    return best
