"""searchplan: static search planning over histories -- slice one
history at sealed quiescent cuts into sequential segments that are
checked in isolation and merge their results back into one verdict (the
execution half the checkers run), and build the plan report of record
(``build_plan``): the partition predicates, the cuts and the elisions,
with SP diagnostics (a copy of ``jepsen_tpu/analysis/searchplan.py``).

Two papers drive the pass. "Faster linearizability checking via
P-compositionality" (arxiv 1504.00204): a partition of a history by a
predicate the model is compositional over turns one big check into many
small independent ones -- here per key (``per_key_parts``, the
jepsen.independent split) and per value for set/add-read workloads
(``per_value_parts``). -- instants with zero open invocations -- let a history
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
not hide behind a slower check (``checker.core.plan_history``, the
report's caller, contains the fault as the JAX package's does).

Every decision of ``build_plan`` is reported through the shared
``Diagnostic`` model as SP codes:

  SP001 info     a partition predicate split the history into N parts
  SP002 info     quiescent sealed cuts found (count, per part)
  SP003 info     search-dead ops elided (count)
  SP004 info     plan summary: sub-searches + config-count estimates
  SP005 warning  no reduction possible -- the plan is one search
  SP006 warning  a requested predicate is not applicable to this
                 history/model
  SP007 error    unknown partition predicate name (the name is skipped)

plus JX007 (``shapelint``) when the plan's segments pad to too many
distinct shape buckets.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import history as h
from .diagnostics import ERROR, INFO, WARNING, diag

__all__ = ["PREDICATES", "DEFAULT_PREDICATES", "MIN_SEGMENT_OPS",
           "SearchPlan", "SubSearch", "Segment", "build_plan",
           "segment_events", "plan_segments", "stream_cut",
           "merge_segment_results", "estimate_configs", "per_key_parts",
           "per_value_parts", "enabled", "segments_enabled",
           "min_segment", "predicate_names"]

#: registered partition-predicate names
PREDICATES = ("per-key", "per-value", "crash-segments")

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

    @property
    def encoded_ops(self):
        """Ops ``spec.encode`` will produce -- the seed pair encodes as a
        row too, and shape bucketing (JX007, the plan report) counts
        what pads, not what is logically new."""
        return self.rows + (1 if self.seed is not None else 0)


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


def estimate_configs(events):
    """Order-of-magnitude config-count estimate for one sub-search:
    ``n_ok * 2^(C-1)`` with C the max point-concurrency. Monotone in
    both n and C, which is all plan ordering needs."""
    inv, ret, n_ok = [], [], 0
    for invop, comp in h.pairs(events):
        if invop is None:
            continue
        if comp is not None and comp.get("type") == h.FAIL:
            continue
        ok = comp is not None and comp.get("type") == h.OK
        n_ok += ok
        inv.append(int(invop["index"]))
        ret.append(int(comp["index"]) if ok else h.INF_TIME)
    return _estimate(inv, ret, n_ok)


def plan_segments(spec, client_events, min_seg=MIN_SEGMENT_OPS):
    """Execution-side entry: segment one part's prepared client history.
    Returns (segments, info) like ``segment_events``; a planner fault
    raises."""
    return segment_events(spec, client_events, min_seg)


# ---------------------------------------------------------------------------
# partition predicates

def per_key_parts(events):
    """The jepsen.independent per-key split: applicable when op values
    carry [k v] tuples. Returns {key: subhistory} with tuples unwrapped,
    or None when no op is keyed. Semantics match
    ``independent.subhistory`` (un-keyed ops replicate into every part)
    in one pass over the history."""
    from .. import independent
    keyed = {}
    unkeyed = []
    for pos, op in enumerate(events):
        v = op.get("value")
        if independent.is_tuple(v):
            op = dict(op)
            op["value"] = v.value
            keyed.setdefault(v.key, []).append((pos, op))
        else:
            unkeyed.append((pos, op))
    if not keyed:
        return None
    out = {}
    for k in sorted(keyed, key=repr):
        merged = sorted(keyed[k] + unkeyed, key=lambda po: po[0])
        out[k] = [op for _, op in merged]
    return out


def per_value_parts(events):
    """Per-value partitioning of a grow-only set/add-read workload: set
    linearizability decomposes per element -- a read shows ``e`` iff
    some ``add(e)`` linearized before it -- so each added value becomes
    an independent *register* sub-search (absent -> present): ``add(e)``
    becomes ``write 1``, an ok read ``read 1`` if it holds ``e``, else
    ``read 0``.

    Applicable iff every client op is ``add``/``read`` and ok reads
    return collections. Returns {element: register event list}, or
    None. Each part opens with a synthetic ``write 0`` pair at indices
    -2/-1: the register's initial state is NIL, not 0, so without it a
    read completing before ``add(e)`` would check false-invalid."""
    adds = set()
    reads = []
    rows = []
    for inv, comp in h.pairs(events):
        if inv is None:
            continue
        f = inv.get("f")
        if f not in ("add", "read"):
            return None
        if comp is not None and comp.get("type") == h.FAIL:
            continue
        rows.append((inv, comp, f))
        if f == "add":
            adds.add(inv.get("value"))
        elif comp is not None and comp.get("type") == h.OK:
            v = comp.get("value")
            if not isinstance(v, (list, tuple, set, frozenset)):
                return None
            reads.append(v)
    if not adds:
        return None
    parts = {}
    for e in sorted(adds, key=repr):
        evs = [{"type": "invoke", "process": -1, "f": "write",
                "value": 0, "index": -2},
               {"type": "ok", "process": -1, "f": "write",
                "value": 0, "index": -1}]
        for inv, comp, f in rows:
            if f == "add":
                if inv.get("value") != e:
                    continue
                evs.append({**inv, "f": "write", "value": 1})
                if comp is not None:
                    evs.append({**comp, "f": "write", "value": 1})
            else:
                evs.append({**inv, "f": "read", "value": None})
                if comp is not None and comp.get("type") == h.OK:
                    evs.append({**comp, "f": "read",
                                "value": 1 if e in comp["value"] else 0})
                elif comp is not None:
                    evs.append({**comp, "f": "read", "value": None})
        parts[e] = evs
    return parts


# ---------------------------------------------------------------------------
# the plan report of record

@dataclasses.dataclass
class SubSearch:
    """One independent sub-search of the plan."""

    part: object            # partition label ([k v] key / set element)
    segment: int            # segment ordinal within the part
    n_ops: int              # encoded ops (seed pair included)
    est_configs: int
    spec_name: str = None   # model override (per-value -> "register")
    seeded: bool = False    # True when a sealing pair seeds the state

    def to_dict(self):
        return {"part": repr(self.part), "segment": self.segment,
                "ops": self.n_ops, "est_configs": self.est_configs,
                **({"spec": self.spec_name} if self.spec_name else {}),
                "seeded": self.seeded}


@dataclasses.dataclass
class SearchPlan:
    """An ordered set of independent sub-searches plus the decisions
    that produced it."""

    subsearches: list
    diagnostics: list
    predicates: list
    elided: int = 0
    cuts: int = 0
    est_configs_unplanned: int = 0
    built_s: float = 0.0

    @property
    def est_configs_planned(self):
        return sum(s.est_configs for s in self.subsearches)

    def summary(self):
        return {"subsearches": len(self.subsearches),
                "predicates": list(self.predicates),
                "cuts": self.cuts,
                "elided": self.elided,
                "est_configs_planned": self.est_configs_planned,
                "est_configs_unplanned": self.est_configs_unplanned,
                "built_s": round(self.built_s, 6),
                "parts": [s.to_dict() for s in self.subsearches[:64]]}


def build_plan(test, hist, lin=None, keyed=None):
    """Build the full SearchPlan for a test's history: discover the
    Linearizable gate (unless passed), apply the requested partition
    predicates, segment each part at sealed quiescent cuts, and emit SP
    diagnostics + the JX007 shape-proliferation check. Returns a
    SearchPlan, or None when the test has no searchable gate."""
    t0 = time.monotonic()
    if lin is None:
        from ..monitor.core import find_linearizable
        lin, keyed = find_linearizable(
            test.get("checker") if isinstance(test, dict) else None)
    if lin is None:
        return None
    spec = lin.spec
    names = predicate_names(test)
    diags = []
    subs = []
    cuts_total = elided_total = 0
    min_seg = min_segment(test)

    client = h.client_ops(h.ensure_indexed(hist or []))
    for n in names:
        if n not in PREDICATES:
            diags.append(diag(
                "SP007", ERROR,
                f"unknown partition predicate {n!r} (known: "
                f"{list(PREDICATES)}); skipping it",
                "searchplan.partitions",
                "fix test['searchplan-partitions'] (planlint PL015 "
                "catches this at preflight)"))
    names = [n for n in names if n in PREDICATES]

    parts = None
    spec_name = None
    if "per-key" in names:
        parts = per_key_parts(client)
        if parts is not None:
            diags.append(diag(
                "SP001", INFO,
                f"per-key split: {len(parts)} independent part(s) "
                f"{sorted(map(repr, parts))[:8]}",
                "searchplan.per-key"))
        elif keyed:
            diags.append(diag(
                "SP006", WARNING,
                "per-key partitioning requested under an independent "
                "checker but no op carries a [k v] tuple value",
                "searchplan.per-key"))
    if parts is None and "per-value" in names:
        parts = per_value_parts(client)
        if parts is not None:
            spec_name = "register"
            diags.append(diag(
                "SP001", INFO,
                f"per-value split: {len(parts)} independent element "
                "register(s) (set/add-read reduction)",
                "searchplan.per-value"))
        elif isinstance(test, dict) \
                and test.get("searchplan-partitions"):
            diags.append(diag(
                "SP006", WARNING,
                "per-value partitioning requested but the history is "
                "not an add/read set workload",
                "searchplan.per-value"))

    segment = "crash-segments" in names
    part_items = list(parts.items()) if parts is not None \
        else [(None, client)]
    part_spec = spec
    if spec_name == "register":
        from ..models import model_spec
        part_spec = model_spec("register")
    prepared = {}
    for label, sub in part_items:
        events = lin.prepare_history(sub) if spec_name is None else sub
        # History-wrap each part so the segmentation sweep and the
        # estimate passes below share one pairing walk per part
        events = h.ensure_indexed(events)
        prepared[label] = events
        if segment:
            segs, info = plan_segments(part_spec, events, min_seg)
            cuts_total += info["cuts"]
            elided_total += info["elided"]
        else:
            # rows = logical ops spec.encode will produce (failed ops
            # drop), not raw events: the shape lint and the plan report
            # bucket on what actually pads
            part_rows, _ = _rows(part_spec, events)
            segs = [Segment(list(events), len(part_rows), None)]
            segs[0].est_configs = estimate_configs(events)
        for i, seg in enumerate(segs):
            subs.append(SubSearch(label, i, seg.encoded_ops,
                                  seg.est_configs, spec_name,
                                  seg.seed is not None))
    if cuts_total:
        diags.append(diag(
            "SP002", INFO,
            f"{cuts_total} sealed quiescent cut(s) slice the history "
            "into sequential segments checkable in isolation",
            "searchplan.quiescent-cuts"))
    if elided_total:
        diags.append(diag(
            "SP003", INFO,
            f"elided {elided_total} search-dead op(s) (unconstrained "
            "non-ok pure ops)", "searchplan.elision"))

    # "unplanned" baseline: the same parts without quiescent
    # segmentation or elision
    est_unplanned = sum(estimate_configs(ev) for ev in prepared.values())
    plan = SearchPlan(subs, diags, names, elided_total, cuts_total,
                      est_unplanned)
    if len(subs) <= 1:
        diags.append(diag(
            "SP005", WARNING,
            "no reduction possible: the plan is one search (no keyed "
            "values, no sealed quiescent instant — heavy overlap or "
            "open indeterminate ops keep every instant non-quiescent)",
            "searchplan",
            "crashed pure reads elide automatically; crashed writes "
            "pin the search together by design"))
    else:
        diags.append(diag(
            "SP004", INFO,
            f"plan: {len(subs)} sub-search(es), estimated configs "
            f"{plan.est_configs_planned:,} vs {est_unplanned:,} "
            "unplanned", "searchplan"))
    # JX007: segments padding to too many distinct shape buckets
    from .shapelint import lint_searchplan_shapes
    diags += lint_searchplan_shapes([s.n_ops for s in subs])
    plan.built_s = time.monotonic() - t0
    return plan


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
