"""Clock-skew analysis: plots the ``clock_offsets`` maps the clock
nemesis embeds in its completions (reference
jepsen/src/jepsen/checker/clock.clj, 75 LoC; the port's copy of
``jepsen_tpu/checker/clock.py``). Host-only."""

from __future__ import annotations

from .core import Checker
from .perf import _out_path, shade_nemeses


def history_datasets(history) -> dict:
    """node -> [(t_seconds, offset_seconds), ...] from ops carrying
    clock_offsets (clock.clj:13-34); each series is extended to the end
    of the history so step plots don't cut off."""
    final_time = (history[-1].get("time", 0) / 1e9) if history else 0
    series: dict = {}
    for op in history:
        offsets = op.get("clock_offsets")
        if not offsets:
            continue
        t = op.get("time", 0) / 1e9
        for node, offset in offsets.items():
            series.setdefault(node, []).append((t, offset))
    for node, points in series.items():
        points.append((final_time, points[-1][1]))
    return series


def short_node_names(nodes) -> list:
    """Shorten node names by stripping common trailing domain components
    (clock.clj:37-45)."""
    parts = [str(n).split(".")[::-1] for n in nodes]
    if len(parts) > 1:
        depth = 0
        while all(len(p) > depth + 1 for p in parts) and \
                len({p[depth] for p in parts}) == 1:
            depth += 1
        parts = [p[depth:] for p in parts]
    return [".".join(p[::-1]) for p in parts]


def plot(test, history, opts=None):
    """Render clock-skew.png; returns the path or None without data
    (clock.clj:47-73)."""
    opts = opts or {}
    datasets = history_datasets(history)
    if not datasets:
        return None
    path = _out_path(test, opts, "clock-skew.png")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(9, 4))
    try:
        ax.set_title(f"{test.get('name')} clock skew")
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Skew (s)")
        nodes = sorted(datasets)
        for node, name in zip(nodes, short_node_names(nodes)):
            pts = datasets[node]
            ax.step([t for t, _ in pts], [o for _, o in pts],
                    where="post", label=name)
        shade_nemeses(ax, history,
                      opts.get("nemeses") or (test.get("plot") or {})
                      .get("nemeses"))
        ax.legend(loc="upper left", bbox_to_anchor=(1.01, 1), fontsize=7)
        fig.tight_layout()
        fig.savefig(path, dpi=100)
    finally:
        plt.close(fig)
    return path


class _ClockPlot(Checker):
    """Always valid; exists for its plot side effect
    (checker.clj:831-837)."""

    def check(self, test, history, opts=None):
        try:
            plot(test, history, opts)
        except Exception:  # noqa: BLE001 - plotting must not affect the
            import logging  # verdict (the checker's contract is valid)
            logging.getLogger(__name__).warning(
                "couldn't render clock-skew.png", exc_info=True)
        return {"valid": True, "valid?": True}


def clock_plot():
    return _ClockPlot()
