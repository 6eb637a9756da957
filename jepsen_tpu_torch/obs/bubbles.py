"""Idle-bubble ledger: classify every non-device-compute gap in a
trace's device lanes into named phases (the port's copy of
``jepsen_tpu/obs/bubbles.py``, host-only).

The duty-cycle headline (``wgl.device_busy_s`` / makespan) says HOW
MUCH of the wall the device computed for; this module says WHERE the
rest went. It walks the phase spans obs/phases.py emitted
(``cat="phase"``, names ``wgl.phase.<name>``), groups them into
per-thread lanes, and folds:

* **device time** — the ``device`` spans (the port's bracket ends at
  a synchronize of the carry's device; the JAX package's at
  ``block_until_ready``): the duty-cycle numerator, excluded from idle;
* **attributed idle** — every other phase span (encode, plan, h2d,
  compile, d2h, host, wait): idle wall with a name on it;
* **residual** — gaps between consecutive phase spans inside an
  episode: host wall nobody bracketed. The acceptance target is that
  this stays under 5% of idle (phases are emitted by a contiguous
  cursor, so residual is only the glue between sessions);
* **inter-episode time** — a lane's quiet stretches longer than
  ``EPISODE_GAP_S`` between spans (a worker thread waiting for its
  next check entirely outside the dispatch pipeline). Reported, but
  excluded from the attribution denominator: the ledger explains the
  dispatch pipeline, not the workload's think time.

Artifact discipline matches fleet_analysis.json / metrics_fold.json:
floats rounded, keys sorted, no wall stamps, atomic tmp+rename —
folding the same trace twice yields byte-identical
``bubble_ledger.json`` (the re-fold test pins this).
"""

from __future__ import annotations

import json
import os

from .trace import load_trace
from .merge import MERGED_TRACE_FILE, _load_run_events

__all__ = ["BUBBLE_FILE", "EPISODE_GAP_S", "fold_events", "fold_run",
           "fold_campaign", "write_ledger", "dumps"]

BUBBLE_FILE = "bubble_ledger.json"

#: a gap this long between consecutive phase spans on one lane ends
#: the episode: dispatch-internal gaps are microseconds (the phase
#: cursor is contiguous), while between-check quiet time is unbounded
EPISODE_GAP_S = 1.0

_PREFIX = "wgl.phase."


def _phase_spans(events):
    """(lane, ts_us, dur_us, phase, engine) for every phase span."""
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "phase":
            continue
        name = str(ev.get("name", ""))
        if not name.startswith(_PREFIX):
            continue
        try:
            ts = float(ev.get("ts", 0.0))
            dur = max(0.0, float(ev.get("dur", 0.0)))
        except (TypeError, ValueError):
            continue
        engine = str((ev.get("args") or {}).get("engine", "?"))
        out.append(((ev.get("pid", 0), str(ev.get("tid", ""))),
                    ts, dur, name[len(_PREFIX):], engine))
    return out


def fold_events(events, gap_s=EPISODE_GAP_S):
    """Fold a trace's (run or merged-campaign) events into one bubble
    ledger dict. Deterministic for a given event list."""
    spans = sorted(_phase_spans(events),
                   key=lambda s: (s[0], s[1], s[2], s[3]))
    lanes = {}
    for lane, ts, dur, phase, engine in spans:
        lanes.setdefault(lane, []).append((ts, dur, phase, engine))

    device_s = idle_s = attributed_s = residual_s = 0.0
    inter_episode_s = 0.0
    episodes = 0
    phases = {}
    engines = {}
    t_min = t_max = None
    gap_us = gap_s * 1e6

    for lane_spans in lanes.values():
        # split the lane into episodes at quiet stretches > gap_s
        groups = []
        for s in lane_spans:
            if groups and s[0] - groups[-1][-1][0] - groups[-1][-1][1] \
                    <= gap_us:
                groups[-1].append(s)
            else:
                if groups:
                    prev = groups[-1][-1]
                    inter_episode_s += max(
                        0.0, (s[0] - prev[0] - prev[1]) / 1e6)
                groups.append([s])
        for g in groups:
            episodes += 1
            start = g[0][0]
            end = max(ts + dur for ts, dur, _, _ in g)
            t_min = start if t_min is None else min(t_min, start)
            t_max = end if t_max is None else max(t_max, end)
            extent = (end - start) / 1e6
            dev = attr = 0.0
            for ts, dur, phase, engine in g:
                sec = dur / 1e6
                phases[phase] = phases.get(phase, 0.0) + sec
                est = engines.setdefault(
                    engine, {"device_s": 0.0, "phases": {}})
                est["phases"][phase] = \
                    est["phases"].get(phase, 0.0) + sec
                if phase == "device":
                    dev += sec
                    est["device_s"] += sec
                else:
                    attr += sec
            device_s += dev
            idle = max(0.0, extent - dev)
            idle_s += idle
            attributed_s += min(attr, idle)
            residual_s += max(0.0, idle - attr)

    ledger = {
        "lanes": len(lanes),
        "episodes": episodes,
        "episode_gap_s": gap_s,
        "makespan_s": round(((t_max - t_min) / 1e6)
                            if t_min is not None else 0.0, 6),
        "device_s": round(device_s, 6),
        "idle_s": round(idle_s, 6),
        "attributed_s": round(attributed_s, 6),
        "residual_s": round(residual_s, 6),
        "inter_episode_s": round(inter_episode_s, 6),
        "attribution_frac": round(attributed_s / idle_s, 6)
        if idle_s > 0 else 1.0,
        "phases": {p: round(s, 6) for p, s in sorted(phases.items())},
        "engines": {e: {"device_s": round(st["device_s"], 6),
                        "phases": {p: round(s, 6) for p, s in
                                   sorted(st["phases"].items())}}
                    for e, st in sorted(engines.items())},
    }
    return ledger


def fold_run(run_dir, gap_s=EPISODE_GAP_S):
    """Bubble ledger for one run directory (finalized trace.jsonl or
    journal fallback)."""
    return fold_events(_load_run_events(run_dir), gap_s=gap_s)


def fold_campaign(campaign_id, persist=True, gap_s=EPISODE_GAP_S):
    """Fold a campaign's MERGED trace (campaign_trace.jsonl — run
    merge_campaign first) into ``store/campaigns/<id>/
    bubble_ledger.json``. Returns the ledger; with ``persist`` the
    artifact's path rides in ``ledger["path"]`` (excluded from the
    written bytes, like the metrics fold)."""
    from .. import store
    p = store.campaign_path(campaign_id, MERGED_TRACE_FILE)
    events = load_trace(p) if os.path.exists(p) else []
    ledger = fold_events(events, gap_s=gap_s)
    if persist:
        out = store.campaign_path(campaign_id, BUBBLE_FILE)
        write_ledger(ledger, out)
        ledger["path"] = out
    return ledger


def dumps(ledger):
    """The ledger's canonical bytes (sorted keys, no wall stamps) —
    what byte-identical re-folds are measured against."""
    clean = {k: v for k, v in ledger.items() if k != "path"}
    return json.dumps(clean, indent=1, sort_keys=True) + "\n"


def write_ledger(ledger, out_path):
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(dumps(ledger))
    os.replace(tmp, out_path)
    return out_path
