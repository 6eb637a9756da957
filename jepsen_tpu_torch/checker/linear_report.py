"""Failure-witness rendering for invalid linearizability analyses: the
analogue of knossos.linear.report's linear.svg (the reference renders it
from the checker at checker.clj:206-212); the port's copy of
``jepsen_tpu/checker/linear_report.py``.

Draws the neighborhood of the stuck operation as per-process bars over
time — the witness op in red, ops concurrent with it highlighted — and
annotates the model states that were still reachable when the search got
stuck. Host-only: it needs matplotlib, which a card's machine may lack;
``checkers.Linearizable.check`` contains the render, so a missing
matplotlib is logged and never changes a verdict."""

from __future__ import annotations

import logging

from .. import history as h
from .perf import _out_path

logger = logging.getLogger(__name__)

#: how many ops around the witness to draw
WINDOW = 30


def _op_intervals(history):
    """[(invoke_op, completion_op_or_None)] with numeric processes."""
    return [(inv, comp) for inv, comp in h.pairs(history)
            if inv is not None and isinstance(inv.get("process"), int)]


def _overlaps(a0, a1, b0, b1):
    return a0 <= b1 and b0 <= a1


def render_analysis(test, history, analysis, opts=None):
    """Render linear.png next to the other artifacts; returns the path,
    or None when there's nothing to draw."""
    op = analysis.get("op")
    if op is None or not history:
        return None
    pairs = _op_intervals(history)
    if not pairs:
        return None

    t_end = max(op_.get("time", 0) for op_ in history)

    def interval(inv, comp):
        t0 = inv.get("time", 0)
        t1 = comp.get("time", t_end) if comp is not None else t_end
        return t0, max(t1, t0)

    # locate the witness pair: same process + f + index if present
    def is_witness(inv, comp):
        cand = comp if comp is not None else inv
        if op.get("index") is not None and cand.get("index") is not None:
            return cand["index"] == op["index"] or \
                inv.get("index") == op.get("index")
        return (cand.get("process") == op.get("process")
                and cand.get("f") == op.get("f")
                and cand.get("value") == op.get("value"))

    wpair = next(((inv, comp) for inv, comp in pairs
                  if is_witness(inv, comp)), None)
    if wpair is None:
        wpair = pairs[-1]
    w0, w1 = interval(*wpair)

    # keep ops overlapping the witness, then nearest others, cap WINDOW
    def sort_key(pair):
        t0, t1 = interval(*pair)
        if _overlaps(t0, t1, w0, w1):
            return (0, t0)
        return (1, min(abs(t0 - w1), abs(w0 - t1)))

    chosen = sorted(pairs, key=sort_key)[:WINDOW]
    if wpair not in chosen:      # never truncate away the witness itself
        chosen[-1] = wpair
    chosen.sort(key=lambda p: interval(*p)[0])

    path = _out_path(test, opts or {}, "linear.png")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle
    procs = sorted({inv["process"] for inv, _ in chosen})
    ys = {p: i for i, p in enumerate(procs)}
    fig, ax = plt.subplots(
        figsize=(10, 0.5 * max(4, len(procs)) + 1.2))
    try:
        for inv, comp in chosen:
            t0, t1 = interval(inv, comp)
            t0, t1 = t0 / 1e9, t1 / 1e9
            y = ys[inv["process"]]
            witness = (inv, comp) == wpair
            cand = comp if comp is not None else inv
            color = ("#B31B1B" if witness else
                     "#7FA3CC" if cand.get("type") == "ok" else
                     "#C9B458" if cand.get("type") == "info" else
                     "#AAAAAA")
            ax.add_patch(Rectangle((t0, y - 0.35),
                                   max(t1 - t0, (w1 - w0) / 1e9 / 50
                                       or 1e-6),
                                   0.7, facecolor=color,
                                   edgecolor="black", lw=0.5))
            label = f"{cand.get('f')} {cand.get('value')!r}"
            ax.text(t0, y, label[:28], fontsize=6, va="center",
                    ha="left", clip_on=True)
        ax.set_yticks(range(len(procs)))
        ax.set_yticklabels([f"process {p}" for p in procs], fontsize=7)
        ax.set_ylim(-0.8, len(procs) - 0.2)
        xs = [t / 1e9 for p_ in chosen for t in interval(*p_)]
        ax.set_xlim(min(xs), max(xs) * 1.02 + 1e-6)
        ax.set_xlabel("Time (s)")
        states = [c.get("model") for c in
                  (analysis.get("configs") or [])[:4]
                  if isinstance(c, dict) and c.get("model") is not None]
        title = (f"{test.get('name', 'test')}: not linearizable — "
                 f"stuck before {op.get('f')} {op.get('value')!r} "
                 f"(process {op.get('process')})")
        if states:
            title += f"\nreachable model states: {states}"
        prev = analysis.get("previous_ok")
        if prev:
            title += (f"\nlast linearized ok op: {prev.get('f')} "
                      f"{prev.get('value')!r} "
                      f"(process {prev.get('process')})")
        ax.set_title(title, fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
    finally:
        plt.close(fig)
    return path
