"""Performance plots: latency and throughput graphs rendered with
matplotlib (reference jepsen/src/jepsen/checker/perf.clj, which drives
gnuplot; the port's copy of ``jepsen_tpu/checker/perf.py``). Host-only.

Produces the same artifacts: ``latency-raw.png`` (raw per-op latency
points by f and outcome), ``latency-quantiles.png`` (0.5/0.95/0.99/1
quantiles over time), ``rate.png`` (completion throughput), all with
shaded nemesis activity regions (perf.clj:184-324).
"""

from __future__ import annotations

import logging

from .. import history as h
from .core import Checker

logger = logging.getLogger(__name__)

#: seconds per quantile bucket (perf.clj:516)
QUANTILE_DT = 30
#: seconds per rate bucket (perf.clj:561)
RATE_DT = 10

QUANTILES = (0.5, 0.95, 0.99, 1.0)

TYPES = ("ok", "info", "fail")

TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}

DEFAULT_NEMESIS_COLOR = "#cccccc"
NEMESIS_ALPHA = 0.6


# ---------------------------------------------------------------------------
# history -> latency points

def history_latencies(history):
    """Pairs of (invoke-op, latency-ms) for completed client ops
    (util/history->latencies)."""
    out = []
    open_by_process = {}
    for op in history:
        p = op.get("process")
        if not isinstance(p, int):
            continue
        if h.invoke(op):
            open_by_process[p] = op
        else:
            inv = open_by_process.pop(p, None)
            if inv is not None:
                lat = (op.get("time", 0) - inv.get("time", 0)) / 1e6
                out.append((inv, op, lat))
    return out


def latency_points_by_f_type(history):
    """{f: {type: [(t_secs, latency_ms)]}} (perf.clj invokes-by-f-type)."""
    datasets = {}
    for inv, comp, lat in history_latencies(history):
        f = inv.get("f")
        t = comp.get("type")
        datasets.setdefault(f, {}).setdefault(t, []).append(
            (inv.get("time", 0) / 1e9, max(lat, 1e-3)))
    return datasets


def latencies_to_quantiles(dt, qs, points):
    """Bucket (t, latency) points into dt-second windows and compute
    quantiles per window (perf.clj:63-80). Returns {q: [(t, latency)]}."""
    buckets = {}
    for t, lat in points:
        buckets.setdefault(int(t // dt), []).append(lat)
    out = {q: [] for q in qs}
    for b in sorted(buckets):
        lats = sorted(buckets[b])
        mid_t = b * dt + dt / 2
        n = len(lats)
        for q in qs:
            idx = min(n - 1, int(q * n))
            out[q].append((mid_t, lats[idx]))
    return out


# ---------------------------------------------------------------------------
# nemesis activity

def nemesis_intervals(ops, spec=None):
    """Pairs nemesis (invoke, complete) event pairs into [start, stop]
    activity intervals; multiple starts are closed by the same stops
    (util.clj:736-787). Ops lacking a stop pair with None."""
    spec = spec or {}
    start_fs = set(spec.get("start", {"start"}))
    stop_fs = set(spec.get("stop", {"stop"}))
    # group into (invoke, completion) pairs
    pairs = []
    for i in range(0, len(ops) - 1, 2):
        a, b = ops[i], ops[i + 1]
        if a.get("f") == b.get("f"):
            pairs.append((a, b))
    intervals = []
    starts = []
    for a, b in pairs:
        f = a.get("f")
        if _f_matches(f, start_fs):
            starts.append((a, b))
        elif _f_matches(f, stop_fs):
            for s1, s2 in starts:
                intervals.append([s1, a])
                intervals.append([s2, b])
            starts = []
    for s1, s2 in starts:
        intervals.append([s1, None])
        intervals.append([s2, None])
    return intervals


def _f_matches(f, fs):
    if f in fs:
        return True
    return isinstance(f, str) and any(
        isinstance(x, str) and x in f for x in fs)


def nemesis_ops(nemeses, history):
    """Partition nemesis ops in history among the nemesis specs
    (perf.clj:184-216); unmatched ops fall to a default "nemesis" spec."""
    # nemesis packages store perf specs as frozen item tuples so they can
    # live in sets (nemesis/combined._perf); accept those alongside dicts
    nemeses = [dict(s) if isinstance(s, tuple) else s
               for s in (nemeses or [])]
    index = {}
    for spec in nemeses:
        for f in (list(spec.get("start", ["start"]))
                  + list(spec.get("stop", ["stop"]))
                  + list(spec.get("fs", []))):
            index[f] = spec["name"]
    by_name = {}
    for op in history:
        if op.get("process") != "nemesis":
            continue
        by_name.setdefault(index.get(op.get("f")), []).append(op)
    out = []
    for spec in nemeses:
        ops = by_name.get(spec["name"])
        if ops:
            out.append({**spec, "ops": ops})
    if by_name.get(None):
        out.append({"name": "nemesis", "ops": by_name[None]})
    return out


def nemesis_activity(nemeses, history):
    """Nemesis specs + their ops + [start stop] intervals
    (perf.clj:218-230)."""
    out = []
    for spec in nemesis_ops(nemeses, history):
        out.append({**spec,
                    "intervals": nemesis_intervals(spec["ops"], spec)})
    return out


def shade_nemeses(ax, history, nemeses=None):
    """Shade nemesis activity intervals and draw event lines onto a
    matplotlib axis (perf.clj nemesis-regions + nemesis-lines)."""
    activity = nemesis_activity(nemeses, history)
    t_max = max((op.get("time", 0) for op in history), default=0) / 1e9
    for i, n in enumerate(activity):
        color = n.get("fill-color") or n.get("color") \
            or DEFAULT_NEMESIS_COLOR
        # divide the vertical space into twelfths (perf.clj:254-260)
        height = 0.0834
        bot = 1 - height * (i + 1)
        for start, stop in n["intervals"]:
            t0 = start.get("time", 0) / 1e9
            t1 = stop.get("time", 0) / 1e9 if stop else t_max
            ax.axvspan(t0, t1, ymin=bot + 0.006,
                       ymax=bot + height - 0.006,
                       color=color, alpha=1 - NEMESIS_ALPHA, lw=0,
                       label=None)
        for op in n["ops"]:
            ax.axvline(op.get("time", 0) / 1e9, color=color,
                       lw=n.get("line-width", 1), alpha=0.7)
        # legend proxy
        ax.plot([], [], color=color, lw=6, label=str(n["name"]))


# ---------------------------------------------------------------------------
# the three graphs

def _f_markers(fs):
    markers = ["+", "x", "*", "s", "o", "^", "v", "D", "p", "1", "2", "3"]
    return {f: markers[i % len(markers)] for i, f in enumerate(sorted(
        fs, key=repr))}


def _out_path(test, opts, filename):
    """Resolve the output path BEFORE building any figure, so a missing
    store directory can't leak matplotlib figures."""
    from .. import store
    return store.make_path(test, (opts or {}).get("subdirectory"), filename)


def _axes(title, ylabel, logy=False):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.set_title(title)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel(ylabel)
    if logy:
        ax.set_yscale("log")
    return fig, ax


def point_graph(test, history, opts=None):
    """latency-raw.png: raw latency points by f and outcome
    (perf.clj:484-511)."""
    opts = opts or {}
    datasets = latency_points_by_f_type(history)
    if not datasets:
        return None
    path = _out_path(test, opts, "latency-raw.png")
    import matplotlib.pyplot as plt
    fig, ax = _axes(f"{test.get('name')} latency", "Latency (ms)",
                    logy=True)
    try:
        markers = _f_markers(datasets.keys())
        for f, by_type in sorted(datasets.items(),
                                 key=lambda kv: repr(kv[0])):
            for t in TYPES:
                pts = by_type.get(t)
                if not pts:
                    continue
                ax.scatter([p[0] for p in pts], [p[1] for p in pts],
                           c=TYPE_COLORS[t], marker=markers[f], s=16,
                           label=f"{f} {t}")
        shade_nemeses(ax, history,
                      opts.get("nemeses") or (test.get("plot") or {})
                      .get("nemeses"))
        ax.legend(loc="upper left", bbox_to_anchor=(1.01, 1), fontsize=7)
        fig.tight_layout()
        fig.savefig(path, dpi=100)
    finally:
        plt.close(fig)
    return path


def quantiles_graph(test, history, opts=None):
    """latency-quantiles.png: latency quantiles by f over time
    (perf.clj:513-550)."""
    opts = opts or {}
    datasets = {}
    for inv, comp, lat in history_latencies(history):
        datasets.setdefault(inv.get("f"), []).append(
            (inv.get("time", 0) / 1e9, max(lat, 1e-3)))
    if not datasets:
        return None
    path = _out_path(test, opts, "latency-quantiles.png")
    import matplotlib.pyplot as plt
    fig, ax = _axes(f"{test.get('name')} latency", "Latency (ms)",
                    logy=True)
    try:
        markers = _f_markers(datasets.keys())
        q_colors = {0.5: "#6DB6FE", 0.95: "#FFAA26", 0.99: "#FEB5DA",
                    1.0: "#FF1E90"}
        for f, pts in sorted(datasets.items(), key=lambda kv: repr(kv[0])):
            qmap = latencies_to_quantiles(QUANTILE_DT, QUANTILES, pts)
            for q in QUANTILES:
                data = qmap[q]
                if not data:
                    continue
                ax.plot([p[0] for p in data], [p[1] for p in data],
                        marker=markers[f], ms=4,
                        color=q_colors.get(q, "#888888"),
                        label=f"{f} {q}")
        shade_nemeses(ax, history,
                      opts.get("nemeses") or (test.get("plot") or {})
                      .get("nemeses"))
        ax.legend(loc="upper left", bbox_to_anchor=(1.01, 1), fontsize=7)
        fig.tight_layout()
        fig.savefig(path, dpi=100)
    finally:
        plt.close(fig)
    return path


def rate_graph(test, history, opts=None):
    """rate.png: completion throughput by f and type in RATE_DT buckets
    (perf.clj:559-599)."""
    opts = opts or {}
    datasets = {}
    t_max = 0.0
    for op in history:
        if h.invoke(op) or not isinstance(op.get("process"), int):
            continue
        t = op.get("time", 0) / 1e9
        t_max = max(t_max, t)
        b = int(t // RATE_DT) * RATE_DT
        key = (op.get("f"), op.get("type"))
        datasets[key] = datasets.get(key, {})
        datasets[key][b] = datasets[key].get(b, 0) + 1 / RATE_DT
    if not datasets:
        return None
    path = _out_path(test, opts, "rate.png")
    import matplotlib.pyplot as plt
    fig, ax = _axes(f"{test.get('name')} rate", "Throughput (hz)")
    try:
        markers = _f_markers({f for f, _ in datasets})
        buckets = [b * RATE_DT for b in range(int(t_max // RATE_DT) + 1)]
        for (f, t), m in sorted(datasets.items(),
                                key=lambda kv: repr(kv[0])):
            ys = [m.get(b, 0) for b in buckets]
            ax.plot(buckets, ys, marker=markers[f], ms=4, c=TYPE_COLORS[t],
                    label=f"{f} {t}")
        shade_nemeses(ax, history,
                      opts.get("nemeses") or (test.get("plot") or {})
                      .get("nemeses"))
        ax.legend(loc="upper left", bbox_to_anchor=(1.01, 1), fontsize=7)
        fig.tight_layout()
        fig.savefig(path, dpi=100)
    finally:
        plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# checkers (checker.clj:797-829)

class _LatencyGraph(Checker):
    def __init__(self, opts=None):
        self.opts = opts or {}

    def check(self, test, hist, opts=None):
        o = {**self.opts, **(opts or {})}
        try:
            point_graph(test, hist, o)
            quantiles_graph(test, hist, o)
            return {"valid": True}
        except AssertionError:
            return {"valid": True, "skipped": "no store directory"}


class _RateGraph(Checker):
    def __init__(self, opts=None):
        self.opts = opts or {}

    def check(self, test, hist, opts=None):
        o = {**self.opts, **(opts or {})}
        try:
            rate_graph(test, hist, o)
            return {"valid": True}
        except AssertionError:
            return {"valid": True, "skipped": "no store directory"}


def latency_graph(opts=None):
    """Renders latency-raw.png + latency-quantiles.png
    (checker.clj:797-808)."""
    return _LatencyGraph(opts)


def rate_graph_checker(opts=None):
    """Renders rate.png (checker.clj:810-820)."""
    return _RateGraph(opts)


def perf(opts=None):
    """Composes both latency and rate graphs (checker.clj:822-829)."""
    from .core import compose
    return compose({"latency-graph": latency_graph(opts),
                    "rate-graph": _RateGraph(opts)})
