"""Campaign trace merge: fold N per-run traces into ONE Perfetto
timeline with a process lane per worker and normalized clocks (the
port's copy of ``jepsen_tpu/obs/merge.py``, host-only: the same trace
files give byte-identical artifacts in both packages. A local campaign
has one ``local`` lane; a fleet campaign has one lane per worker,
stamped by the dispatcher's trace context).

A fleet campaign's story is scattered across the coordinator's own
``store/campaigns/<id>/trace.jsonl`` (dispatch, leases, syncs) and one
``trace.jsonl`` per cell run, each timestamped against its OWN
process's monotonic clock — and, for remote workers, its own wall
clock. This module reassembles them:

* **Anchoring.** Every tracer stamps a ``trace_meta`` event with the
  wall epoch (``epoch_ns``) its ts=0 corresponds to, so a run's
  relative microseconds map onto that host's wall clock.
* **Skew normalization.** Worker wall clocks are NOT trusted. The
  lease handshake records four stamps — the coordinator's send time,
  the worker's spec-receipt time, the worker's result-print time, the
  coordinator's result-receipt time (``rec["clock"]``, journaled on
  the outcome record). The two legs bound the offset:

      worker_done - coord_recv  <=  offset  <=  worker_recv - coord_sent

  but they are wildly ASYMMETRIC here: the forward leg contains the
  worker interpreter's boot and the box's scheduling delay (seconds
  under load — measured +6 s on a busy 2-core host), while the return
  leg is print -> process-exit -> parse (tens of ms). The classic
  symmetric midpoint would split that boot time into a fake seconds-
  scale offset for a LOOPBACK worker, so the estimate uses the tight
  return leg alone: ``offset = worker_done - coord_recv``, biased by
  only the return latency. The per-worker offset is the median over
  that worker's cells, and every event of that worker's runs is
  shifted by it onto the coordinator's clock. This is what makes
  reported detection latencies honest across hosts (the monitoring
  papers' metric — arxiv 2509.17795, 2410.04581 — is meaningless
  under uncorrected skew).
* **Lanes.** The merged trace remaps ``pid``: lane 1 is the
  coordinator, lanes 2.. are workers (sorted by id), each named via a
  ``process_name`` metadata event — Perfetto renders one process
  track per worker with the original thread tracks nested inside.
* **Determinism.** Events are sorted by (ts, lane, tid, ph, name) and
  serialized with sorted keys: the same inputs produce a byte-identical
  ``campaign_trace.jsonl`` (the merge-twice test pins this), so the
  artifact is diffable across resumes.

Runs whose ``trace.jsonl`` never finalized fall back to the
incremental ``trace.jsonl.journal`` (torn tail dropped) — a kill -9'd
worker still contributes everything up to the kill. Runs whose
artifacts were never mirrored home (``synced: false``) are skipped and
counted in the summary, not fatal: planlint PL017 warns ahead of time
when a merge is requested with artifact sync off.
"""

from __future__ import annotations

import json
import logging
import os
import statistics

from .trace import load_trace, trace_meta

logger = logging.getLogger(__name__)

__all__ = ["MERGED_TRACE_FILE", "FOLDED_METRICS_FILE",
           "worker_offsets", "clock_offset", "merge_campaign",
           "fold_campaign_metrics", "introspection_summary"]

MERGED_TRACE_FILE = "campaign_trace.jsonl"
FOLDED_METRICS_FILE = "metrics_fold.json"


def clock_offset(clock):
    """The worker-minus-coordinator wall offset (seconds) from one
    lease handshake, or None when the needed stamps are missing.

    Return-leg estimate: the worker's result stamp measures
    ``offset - d2`` against the coordinator's receipt stamp, where d2
    is the result's print -> exit -> parse latency (tens of ms). The
    forward leg is deliberately NOT averaged in — it contains the
    worker interpreter's boot and scheduling delay (seconds under
    load), and the symmetric midpoint would hand a loopback worker a
    fake seconds-scale offset (see the module docstring)."""
    if not isinstance(clock, dict):
        return None
    try:
        wd = float(clock["worker-result-epoch"])
        cr = float(clock["coord-received-epoch"])
    except (KeyError, TypeError, ValueError):
        return None
    return wd - cr


def worker_offsets(records):
    """{worker_id: offset_s} — the median handshake offset per worker
    over its cell records. Workers with no usable handshake get 0.0
    (loopback workers share the coordinator's clock anyway)."""
    samples = {}
    for rec in records:
        off = clock_offset(rec.get("clock"))
        if off is None:
            continue
        samples.setdefault(str(rec.get("worker")), []).append(off)
    return {w: statistics.median(s) for w, s in samples.items()}


def _load_run_events(run_dir):
    """A run dir's trace events (finalized file or journal fallback);
    [] when neither exists."""
    for name in ("trace.jsonl", "trace.jsonl.journal"):
        p = os.path.join(str(run_dir), name)
        if os.path.exists(p):
            try:
                return load_trace(p)
            except OSError:
                return []
    return []


def _lane_meta(lane, name):
    return {"name": "process_name", "ph": "M", "cat": "__metadata",
            "ts": 0.0, "pid": lane, "tid": 0,
            "args": {"name": str(name)}}


def _shift(events, lane, shift_us):
    """Re-lane and re-clock one trace's events; trace_meta is dropped
    (its anchor is consumed here) and thread-name metadata keeps
    ts=0."""
    out = []
    for ev in events:
        if ev.get("name") == "trace_meta":
            continue
        ev = dict(ev)
        ev["pid"] = lane
        if ev.get("ph") != "M":
            try:
                ev["ts"] = round(float(ev.get("ts", 0.0)) + shift_us, 3)
            except (TypeError, ValueError):
                ev["ts"] = 0.0
        out.append(ev)
    return out


def _sort_key(ev):
    return (float(ev.get("ts", 0.0)) if ev.get("ph") != "M" else -1.0,
            int(ev.get("pid", 0)), str(ev.get("tid", "")),
            str(ev.get("ph", "")), str(ev.get("name", "")))


def merge_campaign(campaign_id, out_path=None):
    """Merge one campaign's traces into
    ``store/campaigns/<id>/campaign_trace.jsonl``. Returns a summary
    dict: event count, per-worker lane/offset/cell counts, runs
    skipped for missing artifacts. Raises FileNotFoundError for an
    unknown campaign; everything per-run is contained."""
    from .. import store

    meta = None
    try:
        with open(store.campaign_path(campaign_id,
                                      "campaign.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        raise FileNotFoundError(
            f"campaign {campaign_id!r} has no campaign.json") from None
    records = store.latest_campaign_records(campaign_id)
    offsets = worker_offsets(records)

    # -- coordinator lane ----------------------------------------------
    coord_events = _load_run_events(store.campaign_path(campaign_id))
    coord_meta = trace_meta(coord_events) or {}
    coord_epoch_ns = coord_meta.get("epoch_ns")
    merged = [_lane_meta(1, "coordinator")]
    merged += _shift(coord_events, 1, 0.0)

    # -- one lane per worker -------------------------------------------
    workers = sorted({str(r.get("worker") or "local") for r in records})
    lanes = {w: i + 2 for i, w in enumerate(workers)}
    for w in workers:
        merged.append(_lane_meta(lanes[w], f"worker {w}"))

    skipped = 0
    cells_merged = {w: 0 for w in workers}
    for rec in sorted(records, key=lambda r: str(r.get("cell"))):
        run_dir = rec.get("path")
        if not run_dir or not os.path.isdir(str(run_dir)):
            skipped += 1
            continue
        events = _load_run_events(run_dir)
        if not events:
            skipped += 1
            continue
        w = str(rec.get("worker") or "local")
        run_meta = trace_meta(events) or {}
        run_epoch_ns = run_meta.get("epoch_ns")
        off_s = offsets.get(w, 0.0)
        if run_epoch_ns is None or coord_epoch_ns is None:
            # no anchor (pre-plane trace): place at the coordinator's
            # origin, un-normalized but visible
            shift_us = 0.0
        else:
            shift_us = (run_epoch_ns - off_s * 1e9
                        - coord_epoch_ns) / 1e3
        merged += _shift(events, lanes[w], shift_us)
        cells_merged[w] += 1

    merged.sort(key=_sort_key)
    out_path = out_path or store.campaign_path(campaign_id,
                                               MERGED_TRACE_FILE)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("[\n")
        for ev in merged:
            f.write(json.dumps(ev, sort_keys=True) + ",\n")
    os.replace(tmp, out_path)
    return {"path": out_path, "events": len(merged),
            "cells": len(records) - skipped, "skipped": skipped,
            "workers": {w: {"lane": lanes[w],
                            "cells": cells_merged[w],
                            "offset_s": round(offsets.get(w, 0.0), 6)}
                        for w in workers},
            "status": (meta or {}).get("status")}


# ---------------------------------------------------------------------------
# campaign metrics fold: per-run metrics.json -> one campaign snapshot

def _fold_histogram(acc, h):
    """Merge one histogram dict into the accumulator (same on-disk
    shape as obs.metrics.Histogram.to_dict). Different bucket bounds
    (a knob changed between cells) keep the first cell's bounds and
    fold sum/count only — counts from mismatched bounds would lie."""
    if acc is None:
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in h.items()}
    if list(acc.get("buckets_le") or []) == list(h.get("buckets_le")
                                                 or []):
        acc["counts"] = [a + b for a, b in
                         zip(acc.get("counts") or [],
                             h.get("counts") or [])]
    acc["sum"] = (acc.get("sum") or 0.0) + (h.get("sum") or 0.0)
    acc["count"] = (acc.get("count") or 0) + (h.get("count") or 0)
    for k, pick in (("min", min), ("max", max)):
        vals = [v for v in (acc.get(k), h.get(k)) if v is not None]
        acc[k] = pick(vals) if vals else None
    return acc


def fold_campaign_metrics(campaign_id, persist=True):
    """Fold the coordinator's and every cell run's metrics snapshots
    into ONE campaign-level view: counters sum, numeric gauges keep
    their max (they are occupancy/high-water series), histograms
    merge. Snapshots come through ``store.load_run_metrics`` (journal
    fallback included, so kill -9'd cells still contribute). With
    ``persist`` the fold lands as deterministic sorted-key
    ``store/campaigns/<id>/metrics_fold.json``.

    This is what turns the per-cell padding/duty-cycle accounting
    (``wgl.cells_real``/``wgl.cells_padded`` per n-bucket,
    ``wgl.device_busy_s``) into the campaign's waste table — each
    cell's series carry their {campaign, cell, worker} default
    labels, so the summed fold stays attributable AND aggregable.

    The coordinator's own snapshot is folded WITHOUT its
    cell-labelled series: those are the dispatcher's live per-cell
    re-folds (``_fold_worker_metrics``) of the very run metrics this
    fold reads directly — summing both would double every re-folded
    counter."""
    from .metrics import parse_flat_key
    from .. import store

    counters, gauges, hists = {}, {}, {}
    records = store.latest_campaign_records(campaign_id)
    dirs = [(store.campaign_path(campaign_id), True)]
    seen = set()
    for rec in records:
        p = rec.get("path")
        if p and os.path.isdir(str(p)) and str(p) not in seen:
            seen.add(str(p))
            dirs.append((str(p), False))
    runs_folded = 0
    for d, coordinator in dirs:
        m = store.load_run_metrics(d)
        if not isinstance(m, dict):
            continue
        runs_folded += 1

        def relevant(k):
            return not (coordinator
                        and "cell" in parse_flat_key(k)[1])

        for k, v in (m.get("counters") or {}).items():
            if not relevant(k):
                continue
            try:
                counters[k] = counters.get(k, 0) + v
            except TypeError:
                continue
        for k, v in (m.get("gauges") or {}).items():
            if not relevant(k):
                continue
            try:
                gauges[k] = v if k not in gauges \
                    else max(gauges[k], v)
            except TypeError:
                gauges.setdefault(k, v)
        for k, h in (m.get("histograms") or {}).items():
            if isinstance(h, dict) and relevant(k):
                hists[k] = _fold_histogram(hists.get(k), h)
    fold = {"campaign": str(campaign_id), "runs_folded": runs_folded,
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": dict(sorted(hists.items()))}
    if persist:
        out = store.campaign_path(campaign_id, FOLDED_METRICS_FILE)
        d = os.path.dirname(out)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(fold, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        os.replace(tmp, out)
        fold["path"] = out
    return fold


def introspection_summary(fold, makespan_s=None):
    """The device-introspection headline from a metrics fold (or any
    snapshot dict): the per-bucket padding-waste table, the device
    duty cycle, and the phase breakdown.

    * ``padding``: {bucket: {real, padded, waste_frac}} summed over
      engines — how many padded batch rows per power-of-two n-bucket
      were real ops vs inert lanes.
    * ``device_busy_s``: summed per engine (device-COMPUTE wall — the
      obs.phases bracket — when phase attribution ran, else the full
      chunk wall); ``duty_cycle`` = total busy wall / ``makespan_s``
      when the caller knows the campaign makespan (the trace summary
      does).
    * ``chunk_s``: per-engine SUM of the host-side dispatch-chunk
      wall (the ``wgl.chunk_s`` histogram — the pre-phase meaning of
      "busy"); busy <= chunk always, and the gap is the per-dispatch
      transfer/harvest overhead.
    * ``phase_s``: {engine: {phase: s}} from the ``wgl.phase_s``
      counters — where the non-device wall went."""
    from .metrics import parse_flat_key
    counters = (fold or {}).get("counters") or {}
    buckets = {}
    busy = {}
    phases = {}
    for k, v in counters.items():
        name, labels = parse_flat_key(k)
        if name in ("wgl.cells_real", "wgl.cells_padded"):
            b = labels.get("bucket") or "?"
            st = buckets.setdefault(b, {"real": 0, "padded": 0})
            st["real" if name.endswith("real") else "padded"] += int(v)
        elif name == "wgl.device_busy_s":
            eng = labels.get("engine") or "?"
            busy[eng] = busy.get(eng, 0.0) + float(v)
        elif name == "wgl.phase_s":
            eng = labels.get("engine") or "?"
            p = labels.get("phase") or "?"
            ep = phases.setdefault(eng, {})
            ep[p] = ep.get(p, 0.0) + float(v)
    chunk = {}
    for k, h in ((fold or {}).get("histograms") or {}).items():
        name, labels = parse_flat_key(k)
        if name == "wgl.chunk_s" and isinstance(h, dict):
            eng = labels.get("engine") or "?"
            chunk[eng] = chunk.get(eng, 0.0) + float(h.get("sum")
                                                     or 0.0)
    for st in buckets.values():
        total = st["real"] + st["padded"]
        st["waste_frac"] = round(st["padded"] / total, 4) if total \
            else 0.0
    out = {"padding": {b: buckets[b] for b in
                       sorted(buckets, key=lambda x:
                              int(x) if str(x).isdigit() else 0)},
           "device_busy_s": {e: round(s, 3)
                             for e, s in sorted(busy.items())},
           "device_busy_total_s": round(sum(busy.values()), 3)}
    if chunk:
        out["chunk_s"] = {e: round(s, 3)
                          for e, s in sorted(chunk.items())}
    if phases:
        out["phase_s"] = {e: {p: round(s, 3)
                              for p, s in sorted(ep.items())}
                          for e, ep in sorted(phases.items())}
    if makespan_s and makespan_s > 0:
        out["duty_cycle"] = round(sum(busy.values()) / makespan_s, 4)
    return out
