"""capplan: whole-campaign static capacity & shape planning (the port's
copy of ``jepsen_tpu/analysis/capplan.py``).

Every compile shape, HBM footprint, and int32-wall crossing a campaign
will produce is a pure function of the campaign matrix and the
ModelSpecs it names -- fully determined *before a single device
dispatch*. Otherwise they are only discovered at dispatch time:
shapelint's JX007 fires per plan once a history exists,
``--device-slots`` is a blind knob, and the service coalescer learns
its buckets from the first window. P-compositionality (arxiv
1504.00204) gives the cost model for partitioned searches and "On the
complexity of Linearizability" (arxiv 1410.5000) the per-family
asymptotics; both are static functions of the plan, so this analyzer
computes them statically, in the searchplan/fleetlint lineage.

The pipeline::

    matrix --expand--> cells --shape model--> per-cell search shapes
           --fold--> bucket census + compile-shape prediction
                   + HBM footprints vs --device-mem-budget
                   + int32-wall proximity
           --> capacity_plan.json (byte-deterministic: no wall
               stamps, sorted keys -- the fleet_analysis.json
               discipline) + CP001-CP008 diagnostics

and, after the campaign runs, the **prediction oracle**: the predicted
``(model, bucket)`` set is diffed against the plan shapes the engines
actually noted under the port's labels during the campaign
(``compile_cache.noted_counts``/``noted_since``, projected by
``sizemodel.ledger_key_shape``) and the prediction error
lands in ``report.json["capacity"]``.

Codes::

  CP001 warning  unknown-shape cell: no static size model for the
                 cell's workload (or its op count is runtime-bound),
                 so the campaign prediction is incomplete
  CP002 info     compile-shape census: the predicted distinct
                 (model, bucket) set and per-bucket cell population
  CP003 warning  fragmented buckets: the campaign pads to more than
                 MAX_PLAN_SHAPES distinct op-count buckets (the
                 static JX007) -- carries the computed floor that
                 would collapse them. The port compiles nothing per
                 shape and its floor is a constant, so the finding
                 costs padding-free reuse of nothing: it reports the
                 fragmentation and the floor, and names no setter
  CP004 error    a single cell's predicted HBM footprint exceeds
                 --device-mem-budget: the cell can never fit
  CP005 warning  requested device slots oversubscribe the budget
                 (slots x peak footprint > budget)
  CP006 info     the computed --device-slots auto value
                 (budget // peak per-cell footprint)
  CP007 warning  int32-wall proximity: some cell within 2x of the
                 2^31 index ceiling (the static JX005)
  CP008 error    int32 wall crossed: some cell's encoded cells or
                 search buffers overflow int32 indices (the static
                 JX004)

**Containment** (the searchplan rule, asserted by test): findings
never flip a verdict or exit code. ``--capacity plan`` persists the
plan, ``warn`` additionally prints the table + diagnostics; only
``enforce`` may refuse a campaign, and only via PL021/CP *errors* at
preflight -- a crashing planner never changes an outcome either way.

The size math all comes from ``analysis.sizemodel`` (which delegates
to the live ``torch_wgl._plan_sizes`` / ``compile_cache.bucket_for``
and counts the port's own buffers), so capplan cannot drift from the
engines.

Where the port differs (ROADMAP.md, deliberate divergences): the
byte figures under ``hbm`` are the port's (``sizemodel.hbm_bytes``);
the shapes' ``engine`` labels are the port's (``torch-wgl-batch``);
and CP003's message and fix text describe the port, whose op-count
floor is a constant. Plans, diagnostics and oracles otherwise equal
the JAX package's on the same matrix (``tests/test_torch_capplan.py``).
"""

from __future__ import annotations

import json
import logging
import math
import os

from . import sizemodel
from .diagnostics import ERROR, INFO, WARNING, diag, errors, to_json
from .shapelint import MAX_PLAN_SHAPES

logger = logging.getLogger(__name__)

__all__ = ["CAPACITY_MODES", "PLAN_FILE", "CapacityError",
           "UnknownShape", "register_shapes", "shapes_for_cell",
           "build_plan", "recommend_floor", "auto_slots",
           "predicted_keys", "oracle", "report_section", "dump_plan",
           "load_plan", "render_table", "preflight"]

#: the --capacity knob's legal values (PL021 rejects anything else):
#: "plan" persists capacity_plan.json, "warn" additionally prints the
#: table + diagnostics, "enforce" refuses the campaign on CP/PL021
#: errors at preflight (the only mode allowed to)
CAPACITY_MODES = ("plan", "warn", "enforce")

PLAN_FILE = "capacity_plan.json"

#: generator slack: linearizable_register randomizes per-key limits
#: 90-110% so keys drift off Significant Event Boundaries -- the
#: static bound must cover the top of that band
GENERATOR_SLACK = 1.1

#: checker algorithms that reach a device WGL search (competition
#: races the device engine against the CPU oracle, so it searches on
#: the card too); "jax-wgl" keeps its name in the port
_DEVICE_ALGOS = (None, "jax-wgl", "batch", "competition")

#: the label a register cell's batched search notes its plan under
_BATCH_ENGINE = "torch-wgl-batch"


class CapacityError(ValueError):
    """An ``enforce``-mode capacity preflight refused the campaign."""

    def __init__(self, diags):
        from .diagnostics import render_text
        self.diagnostics = diags
        super().__init__(render_text(diags,
                                     title="capacity preflight failed:"))


class UnknownShape(Exception):
    """A cell whose search shapes cannot be derived statically."""


# ---------------------------------------------------------------------------
# the workload shape registry: params x ModelSpec -> search shapes

_SHAPE_FNS = {}


def register_shapes(workload, fn=None):
    """Register a static shape model for a workload name. ``fn(params)
    -> [{"model", "n_ops", "keys"?, "engine"?}, ...]`` returns the
    device searches one cell of that workload will dispatch ([] for
    host-side-only checkers); it raises `UnknownShape` when the params
    make the op count runtime-bound. Usable as a decorator."""
    if fn is None:
        return lambda f: register_shapes(workload, f)
    # codelint: ok -- import-time registration like models.register_model,
    # serialized by Python's module import lock; never called from
    # worker threads
    _SHAPE_FNS[str(workload)] = fn
    return fn


def _concurrency_of(params):
    """A numeric concurrency bound from the cell params, tolerating
    the CLI's "3n" form; None when underivable."""
    c = params.get("concurrency")
    if c is None:
        return None
    if isinstance(c, bool):
        return None
    if isinstance(c, (int, float)):
        return int(c)
    s = str(c).strip()
    try:
        if s.endswith("n"):
            return int(s[:-1]) * len(params.get("nodes") or [1] * 5)
        return int(s)
    except ValueError:
        return None


@register_shapes("register")
def _register_shapes(params):
    """The linearizable-register family: independent per-key
    subhistories, each bounded by per-key-limit (x the 90-110%
    generator slack), batched through keyshard as one key-batch search
    per window. Every key shares ONE bucket because every key
    shares the limit."""
    algo = params.get("algorithm")
    if algo is not None and str(algo) not in _DEVICE_ALGOS:
        return []    # CPU oracle (linear/wgl): no device compile
    pkl = params.get("per-key-limit", 20)
    if not pkl or not isinstance(pkl, (int, float)) \
            or isinstance(pkl, bool) or pkl <= 0:
        raise UnknownShape(
            f"per-key-limit {pkl!r} leaves the per-key op count "
            "runtime-bound")
    n_max = int(math.ceil(GENERATOR_SLACK * float(pkl)))
    return [{"model": str(params.get("model", "cas-register")),
             "n_ops": n_max, "engine": _BATCH_ENGINE}]


# host-side / non-WGL checkers: no device search, no compile shapes --
# known-empty, NOT unknown
register_shapes("noop", lambda params: [])
register_shapes("bank", lambda params: [])      # host-side bank fold
register_shapes("set", lambda params: [])       # host-side set checker


def _txn_shapes(params):
    """The transactional family (list-append / rw-register): the device
    work is the cycle-closure probe, keyed by pow-2 txn-count buckets
    (``sizemodel.closure_shape``). The txn count is generator-bound:
    ``txn-count`` pins it; otherwise it derives from
    time-limit x rate x concurrency (the suite's generator shape), and
    with neither the cell is an UnknownShape."""
    n = params.get("txn-count")
    if n is None:
        tl = params.get("time-limit")
        rate = params.get("rate", 100)
        conc = _concurrency_of(params) or 1
        if isinstance(tl, (int, float)) and not isinstance(tl, bool) \
                and tl > 0 and isinstance(rate, (int, float)) \
                and not isinstance(rate, bool) and rate > 0:
            n = int(math.ceil(GENERATOR_SLACK * float(tl)
                              * float(rate) * conc))
    if not isinstance(n, (int, float)) or isinstance(n, bool) or n <= 0:
        raise UnknownShape(
            "txn count is runtime-bound: set txn-count, or time-limit "
            "+ rate so it can be derived")
    return [{"model": "txn-closure", "n_ops": int(n),
             "engine": "txn-closure"}]


register_shapes("append", _txn_shapes)
register_shapes("wr", _txn_shapes)


def shapes_for_cell(params):
    """The symbolic search shapes one cell will dispatch:
    ``sizemodel.search_shape`` dicts. Raises `UnknownShape` when the
    workload has no registered shape model (or its own model raises
    it / cannot resolve a ModelSpec)."""
    w = params.get("workload")
    fn = _SHAPE_FNS.get(str(w))
    if fn is None:
        raise UnknownShape(f"no static shape model for workload {w!r}")
    conc = _concurrency_of(params)
    out = []
    for raw in fn(dict(params)):
        try:
            if raw.get("engine") == "txn-closure":
                # the cycle probe has no ModelSpec; its size model is
                # the closure frontier, not a WGL search plan
                out.append(sizemodel.closure_shape(raw["n_ops"]))
            else:
                out.append(sizemodel.search_shape(
                    raw["model"], raw["n_ops"],
                    keys=int(raw.get("keys") or 1),
                    concurrency=conc,
                    engine=raw.get("engine", _BATCH_ENGINE)))
        except (KeyError, TypeError, ValueError) as e:
            raise UnknownShape(
                f"workload {w!r}: {e!r}") from None
    out.extend(_stream_monitor_shapes(params))
    return out


def _stream_monitor_shapes(params):
    """A cell monitored with ``engine: "streamlin"`` additionally
    keeps one device-resident frontier per live stream
    (``sizemodel.stream_frontier_shape``): quote it so the capacity
    fit sees the resident tensors a hundred monitored streams pin
    alongside the offline search's transient ones."""
    mon = params.get("monitor")
    if not isinstance(mon, dict) or mon.get("engine") != "streamlin":
        return []
    opts = mon.get("engine-opts") or {}
    try:
        from ..checker import streamlin
        cap = int(opts.get("frontier-cap")
                  or streamlin.DEFAULT_FRONTIER_CAP)
        window = int(opts.get("window-cap")
                     or streamlin.DEFAULT_WINDOW_CAP)
        return [sizemodel.stream_frontier_shape(cap, window)]
    except (KeyError, TypeError, ValueError):
        # garbage knobs are PL026's complaint, not a planner crash
        return []


# ---------------------------------------------------------------------------
# the plan builder

def _as_cells(matrix_or_cells, base=None):
    """Normalize the input to (cells, base): a campaign matrix dict is
    expanded through campaign.plan (its base merges OVER the explicit
    base); a cell list passes through."""
    base = dict(base or {})
    if isinstance(matrix_or_cells, dict):
        from ..campaign import plan as cplan
        norm = cplan.normalize(matrix_or_cells)
        base.update(norm["base"])
        return cplan.expand(norm), base
    return list(matrix_or_cells), base


def recommend_floor(keys, max_shapes=MAX_PLAN_SHAPES):
    """The SMALLEST pow-2 op-count floor that would collapse the
    predicted ``(model, bucket)`` keys to at most ``max_shapes``
    distinct shapes -- the JX007 fix-hint, solved instead of hinted.
    Returns ``{"set_n_floor", "distinct_before", "distinct_after"}``
    (the reference's dict, key name included) or None when the keys
    already fit. In the port the floor is a constant and a coarser
    bucket buys no reuse, only padding rows, so the dict reports what
    the floor would do; nothing applies it."""
    keys = {(str(m), int(b)) for m, b in keys}
    if len(keys) <= max_shapes:
        return None

    def distinct_at(f):
        return len({(m, max(b, f)) for m, b in keys})

    candidates = sorted({b for _, b in keys})
    floor = candidates[-1]    # collapses every model to one bucket
    for f in candidates:
        if distinct_at(f) <= max_shapes:
            floor = f
            break
    return {"set_n_floor": floor,
            "distinct_before": len(keys),
            "distinct_after": distinct_at(floor)}


def build_plan(matrix_or_cells, base=None, device_mem_budget=None,
               device_slots=None):
    """Build the capacity plan for a campaign matrix (or expanded cell
    list). Returns ``(plan, diagnostics)``; never contacts a device.

    ``device_mem_budget`` (bytes) enables the HBM half: per-cell
    footprints are compared against it (CP004), the ``--device-slots
    auto`` value is computed from it (CP006), and a numeric
    ``device_slots`` request is checked against it (CP005)."""
    cells, base = _as_cells(matrix_or_cells, base)
    diags = []
    plan_cells = []
    bucket_pop = {}          # "model/bucket" -> cell count
    keys = set()             # {(model, bucket)}
    peak = None              # (bytes, cell id) worst single cell
    worst_wall = None        # (frac, cell id, which)
    unknown = 0
    for cell in cells:
        params = dict(base)
        params.update(cell.get("params") or {})
        cid = str(cell.get("id") or params.get("workload") or "?")
        entry = {"cell": cid,
                 "workload": str(params.get("workload"))}
        try:
            shapes = shapes_for_cell(params)
        except UnknownShape as e:
            entry.update(unknown=True, reason=str(e), shapes=[])
            unknown += 1
            if unknown <= 8:
                diags.append(diag(
                    "CP001", WARNING,
                    f"cell has no static shape model: {e}",
                    f"capacity.cell[{cid}]",
                    "register one via capplan.register_shapes, or "
                    "accept an incomplete prediction"))
            plan_cells.append(entry)
            continue
        entry.update(unknown=False, shapes=shapes)
        cell_bytes = 0
        for sh in shapes:
            k = (sh["model"], sh["bucket"])
            keys.add(k)
            slot = bucket_pop.setdefault(f"{k[0]}/{k[1]}",
                                         {"cells": 0, "searches": 0})
            slot["searches"] += 1
            cell_bytes += sh["hbm"]["total"]
            w = sh["int32"]
            if worst_wall is None or w["frac"] > worst_wall[0]:
                worst_wall = (w["frac"], cid, w["which"])
        for k in {(sh["model"], sh["bucket"]) for sh in shapes}:
            bucket_pop[f"{k[0]}/{k[1]}"]["cells"] += 1
        if shapes and (peak is None or cell_bytes > peak[0]):
            peak = (cell_bytes, cid)
        plan_cells.append(entry)
    if unknown > 8:
        diags.append(diag(
            "CP001", WARNING,
            f"{unknown - 8} further unknown-shape cell(s) suppressed",
            "capacity.cells"))

    sorted_keys = sorted(keys)
    diags.append(diag(
        "CP002", INFO,
        f"{len(cells)} cell(s) compile to {len(sorted_keys)} distinct "
        f"(model, bucket) shape(s): "
        f"{['/'.join(map(str, k)) for k in sorted_keys]}"
        + (f" ({unknown} unknown-shape cell(s) excluded)" if unknown
           else ""),
        "capacity"))

    rec = recommend_floor(keys)
    if rec is not None:
        diags.append(diag(
            "CP003", WARNING,
            f"predicted shapes pad to {rec['distinct_before']} "
            f"distinct (model, bucket) keys, more than "
            f"{MAX_PLAN_SHAPES}: the port compiles nothing per shape, so "
            "the buckets cost no compiles, only a plan shape each in "
            "the campaign's counts",
            "capacity.buckets",
            f"a floor of {rec['set_n_floor']} would collapse them to "
            f"{rec['distinct_after']} shape(s), but the port's floor is "
            "a constant: a coarser bucket only adds padding rows"))

    hbm = {"per_cell_peak_bytes": peak[0] if peak else None,
           "peak_cell": peak[1] if peak else None,
           "budget_bytes": int(device_mem_budget)
           if device_mem_budget else None,
           "auto_slots": None,
           # footprints are per padded key LANE: the batch engine's
           # real allocation scales with its pow-2 runtime key axis,
           # which is time-limit-bound and not statically derivable
           "note": "per key-lane; batched searches scale with the "
                   "runtime key axis"}
    if device_mem_budget and peak:
        budget = int(device_mem_budget)
        if peak[0] > budget:
            diags.append(diag(
                "CP004", ERROR,
                f"cell's predicted HBM footprint "
                f"{peak[0]:,} bytes exceeds the device memory budget "
                f"{budget:,}: the cell can never fit on the device",
                f"capacity.cell[{peak[1]}]",
                "raise --device-mem-budget, shrink per-key-limit, or "
                "shard the search (parallel.searchshard)"))
        else:
            slots = max(1, budget // peak[0])
            hbm["auto_slots"] = slots
            diags.append(diag(
                "CP006", INFO,
                f"--device-slots auto = {slots} "
                f"(budget {budget:,} // peak cell footprint "
                f"{peak[0]:,})",
                "capacity.device-slots"))
            if isinstance(device_slots, int) \
                    and not isinstance(device_slots, bool) \
                    and device_slots * peak[0] > budget:
                diags.append(diag(
                    "CP005", WARNING,
                    f"{device_slots} device slot(s) x peak footprint "
                    f"{peak[0]:,} bytes oversubscribes the "
                    f"{budget:,}-byte budget: concurrent searches "
                    "can exhaust HBM",
                    "capacity.device-slots",
                    f"use --device-slots auto (= {slots})"))

    wall = {"max_frac": worst_wall[0] if worst_wall else 0.0,
            "max_cell": worst_wall[1] if worst_wall else None,
            "which": worst_wall[2] if worst_wall else None}
    if worst_wall is not None and worst_wall[0] >= 1.0:
        diags.append(diag(
            "CP008", ERROR,
            f"cell crosses the int32 index wall: its {worst_wall[2]} "
            f"spans {worst_wall[0]:.2f}x the 2^31 cell limit -- "
            "device index arithmetic overflows",
            f"capacity.cell[{worst_wall[1]}]",
            "shard the history (parallel.keyshard / searchshard) or "
            "wait for the packed-encoding work"))
    elif worst_wall is not None and worst_wall[0] >= 0.5:
        diags.append(diag(
            "CP007", WARNING,
            f"cell within 2x of the int32 index wall "
            f"({worst_wall[2]} at {worst_wall[0]:.2f}x of 2^31)",
            f"capacity.cell[{worst_wall[1]}]",
            "plan key sharding before the workload grows"))

    plan = {
        "schema": 1,
        "n_floor": sizemodel.n_floor(),
        "cells": sorted(plan_cells, key=lambda c: c["cell"]),
        "buckets": bucket_pop,
        "compiles": {"distinct": len(sorted_keys),
                     "keys": [list(k) for k in sorted_keys]},
        "recommendation": rec,
        "hbm": hbm,
        "int32": wall,
        "unknown_cells": unknown,
        "diagnostics": to_json(diags),
    }
    return plan, diags


# ---------------------------------------------------------------------------
# consumers: slots, persistence, the oracle

def auto_slots(plan):
    """The computed ``--device-slots auto`` value, or None when the
    plan has no budget/footprint to derive one from."""
    return ((plan or {}).get("hbm") or {}).get("auto_slots")


def dump_plan(plan, path):
    """Persist a plan byte-deterministically (sorted keys, no wall
    stamps -- re-planning the same matrix diffs clean). Atomic
    write-then-rename like every store artifact."""
    tmp = f"{path}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(plan, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_plan(path):
    """The persisted plan, or None when absent/unparseable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def predicted_keys(plan):
    """The predicted ``{(model, bucket)}`` set from a plan dict."""
    return {(str(m), int(b))
            for m, b in ((plan or {}).get("compiles") or {})
            .get("keys") or []}


def _project(canon_keys):
    out = set()
    for engine, key in canon_keys:
        mb = sizemodel.ledger_key_shape(engine, key)
        if mb is not None:
            out.add(mb)
    return out


def oracle(plan, actual_canon_keys, warm_keys=()):
    """The prediction oracle: diff the plan's predicted
    ``(model, bucket)`` set against the actual plan shapes (canonical
    ``(engine, key)`` pairs noted during the campaign under the port's
    labels).
    ``error_frac`` is the symmetric difference over the union -- 0.0
    means capplan predicted every compiled shape and nothing else.

    ``warm_keys`` are canonical keys the persistent ledger ALREADY
    held before the campaign started. The disk ledger records misses
    only, so a predicted shape a worker used as a warm HIT leaves no
    campaign-scoped evidence either way -- such shapes report under
    ``warm`` (prediction unverifiable, not wrong) instead of
    ``missed``, and stay out of the error denominator. The in-process
    scheduler path needs no warm set: ``compile_cache.noted_counts``
    counts hits too."""
    actual = _project(actual_canon_keys)
    pred = predicted_keys(plan)
    # predicted shapes already on disk before the run and not
    # re-compiled during it: unverifiable from a miss-only ledger
    warm = (pred & _project(warm_keys)) - actual
    pred_v = pred - warm
    union = pred_v | actual
    return {
        "predicted": [list(k) for k in sorted(pred)],
        "actual": [list(k) for k in sorted(actual)],
        "matched": len(pred & actual),
        "missed": [list(k) for k in sorted(pred_v - actual)],
        "unplanned": [list(k) for k in sorted(actual - pred)],
        "warm": [list(k) for k in sorted(warm)],
        "error_frac": round(len(pred_v ^ actual) / len(union), 4)
        if union else 0.0,
    }


def report_section(plan, actual_canon_keys, path=None, warm_keys=()):
    """The ``report.json["capacity"]`` block a campaign attaches at
    finalize: the plan headline plus the prediction oracle."""
    return {
        "path": path,
        "predicted_shapes": ((plan or {}).get("compiles")
                             or {}).get("distinct"),
        "unknown_cells": (plan or {}).get("unknown_cells"),
        "recommendation": (plan or {}).get("recommendation"),
        "oracle": oracle(plan, actual_canon_keys,
                         warm_keys=warm_keys),
    }


def render_table(plan):
    """The human capacity table (``python -m jepsen_tpu_torch.lint
    --matrix``, warn mode)."""
    lines = ["capacity plan:",
             f"{'cell':<40} {'model':<16} {'n_max':>6} {'bucket':>7} "
             f"{'hbm':>12} {'int32':>7}"]
    for cell in (plan or {}).get("cells") or []:
        if cell.get("unknown"):
            lines.append(f"{cell['cell']:<40} "
                         f"(unknown: {cell.get('reason')})")
            continue
        if not cell.get("shapes"):
            lines.append(f"{cell['cell']:<40} (no device search)")
            continue
        for sh in cell["shapes"]:
            lines.append(
                f"{cell['cell']:<40} {sh['model']:<16} "
                f"{sh['n_ops']:>6} {sh['bucket']:>7} "
                f"{sh['hbm']['total']:>12,} "
                f"{sh['int32']['frac'] * 100:>6.2f}%")
    comp = (plan or {}).get("compiles") or {}
    lines.append(f"distinct compile shapes: {comp.get('distinct')} "
                 f"{comp.get('keys')}")
    rec = (plan or {}).get("recommendation")
    if rec:
        lines.append(f"fragmented: a floor of {rec['set_n_floor']} "
                     f"would give {rec['distinct_after']} shape(s) "
                     "(the port's floor is a constant)")
    hbm = (plan or {}).get("hbm") or {}
    if hbm.get("auto_slots"):
        lines.append(f"device-slots auto: {hbm['auto_slots']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the preflight entry point (CLI / run_fleet)

def preflight(matrix_or_cells, base=None, mode=None,
              device_mem_budget=None, device_slots=None):
    """Build the plan + run the PL021 knob lint in one step; the
    campaign entry points call this. Returns ``(plan, diags)``.

    Only ``mode == "enforce"`` may raise (`CapacityError`, on PL021 or
    CP *error* diagnostics). In every other mode -- and on ANY planner
    crash, enforce included -- the campaign proceeds untouched: a
    crashing planner never changes an outcome or exit code (the
    searchplan containment rule, asserted by test).

    A budget with neither a ``mode`` nor ``device_slots == "auto"``
    consuming it builds NO plan -- PL021's ignored-knob warning is the
    whole outcome, and the warning stays truthful."""
    from . import planlint
    diags = planlint.lint_capacity({
        "capacity": mode,
        "device-mem-budget": device_mem_budget,
        "device-slots": device_slots,
    })
    slots_auto = isinstance(device_slots, str) \
        and device_slots.strip() == "auto"
    if mode is None and not slots_auto:
        return None, diags
    budget = device_mem_budget
    if not isinstance(budget, (int, float)) or isinstance(budget, bool) \
            or budget <= 0:
        budget = None    # PL021 already flagged a bad value
    plan = None
    try:
        plan, pdiags = build_plan(
            matrix_or_cells, base=base, device_mem_budget=budget,
            device_slots=device_slots)
        diags = diags + pdiags
    except Exception:  # noqa: BLE001 - contained: planning is advisory
        logger.warning("capacity planner crashed (contained)",
                       exc_info=True)
        return None, diags
    if plan is not None and mode == "enforce" \
            and plan.get("unknown_cells"):
        diags.append(diag(
            "PL021", WARNING,
            f"--capacity enforce over a matrix with "
            f"{plan['unknown_cells']} unknown-shape cell(s): "
            "enforcement only covers the cells the planner can see",
            "capacity.enforce",
            "register shape models for the unknown workloads, or use "
            "--capacity warn"))
    if mode == "enforce" and errors(diags):
        raise CapacityError(errors(diags))
    return plan, diags
