"""Summarize a test run's observability artifacts from its store dir
(the port's counterpart of the JAX package's ``tools/trace_summary.py``:
the same arguments, exit codes, sections and text, read through the
port's ``obs``, ``obs.bubbles``, ``obs.merge``, ``store`` and
``analysis.fleetlint``).

Reads ``trace.jsonl`` + ``metrics.json`` (written by
jepsen_tpu_torch.store next to results.json) and prints:

* per-lifecycle-phase wall time (the ``X`` spans with cat=lifecycle),
* op-latency quantiles (p50/p90/p99) from the interpreter's op spans,
  falling back to the metrics histogram when the trace has no op spans,
* op counts by f/type and the WGL search telemetry (states explored,
  chunk count, dedup-table load) from metrics.json,
* the streaming monitor's telemetry (ops consumed, chunk checks,
  detection latency) plus its violation instant from the trace.

Usage::

    python -m jepsen_tpu_torch.trace_summary [STORE_DIR]
    python -m jepsen_tpu_torch.trace_summary --campaign [CAMPAIGN_DIR_OR_ID]

STORE_DIR defaults to ``store/latest``. Accepts either a run directory
(containing trace.jsonl) or anything with those two files in it. Exit
code 0, or 1 when there is no such directory or campaign.

``--campaign`` reads a campaign directory's merged
``campaign_trace.jsonl`` (one Perfetto timeline, one process lane per
worker, clocks skew-normalized -- written by the fleet dispatcher via
``jepsen_tpu_torch.obs.merge``) plus ``metrics.json``/``report.json``
and prints the campaign view: per-worker lanes with their clock
offsets, makespan vs summed cell wall (achieved parallelism),
per-worker utilization and exec/search/sync breakdown, device-slot
wait, fleet lease/steal/sync/chaos counters, and the critical-path
cells. The argument may be a campaign directory or a campaign id
(resolved under ``store/campaigns/``); default: the most recent
campaign.

Lines that say what the port measures where the reference's words
would not (ROADMAP.md C, "The store reader"): the duty-cycle section
reads ``wgl.device_busy_s``, the search's dispatch wall (mostly host
launch time; the card's idle share comes from ``torch.profiler``); the
bubble ledger's ``device`` lap is that wall too; a ``compile`` lap is
the rollout library's build or load; the capacity plan's keys are plan
shapes and its recommendation names the floor, not a setter the port
does not have. Engine labels are printed as the artifacts hold them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import threading

#: the duty-cycle section (the reference's "device duty cycle"): the
#: port's ``wgl.device_busy_s`` is the search's dispatch wall
DUTY_TITLE = "\n-- search dispatch duty cycle (wgl.device_busy_s) --"
DUTY_NOTE = ("the search's dispatch wall, mostly host launch time; the "
             "card's idle share comes from torch.profiler "
             "(python -m jepsen_tpu_torch.profile_main, or --profile)")
#: the bubble ledger's device time is the same ``device`` lap
BUBBLE_TITLE = ("\n-- idle bubbles (makespan minus the device lap: "
                "dispatch wall) --")
#: a ``compile`` lap marks the rollout library's build or load
COMPILE_NOTE = ("(compile: the rollout library's build or load; nothing "
                "is compiled per shape)")
#: a campaign without a merged trace: the merge is the port's
NO_MERGED_TRACE = ("(no campaign_trace.jsonl — run the fleet with trace "
                   "merge enabled, or merge with "
                   "jepsen_tpu_torch.obs.merge.merge_campaign)")
#: the capacity plan's keys are plan shapes, not compiles
CAPACITY_NOTE = ("plan shapes (model, n-bucket): the port compiles "
                 "nothing per shape")


def _load_trace(path):
    from .obs import load_trace
    return load_trace(path)


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return None
    # nearest-rank: smallest index covering a q fraction of the sample
    # (int(q*len) would bias high -- p50 of 2 samples must be the lower)
    i = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


def _fmt_s(us):
    return f"{us / 1e6:10.3f}s"


def _contained(fn):
    """``fn()``, or None when it raises: the summary must print. A
    ``NotImplementedError`` is never contained."""
    try:
        return fn()
    except NotImplementedError:
        raise
    except Exception:  # noqa: BLE001 - the summary must print
        return None


def summarize(store_dir):
    """Render the summary for one run directory; returns the text."""
    lines = [f"== {store_dir} =="]
    trace_path = os.path.join(store_dir, "trace.jsonl")
    metrics_path = os.path.join(store_dir, "metrics.json")

    events = []
    if os.path.exists(trace_path):
        events = _load_trace(trace_path)

    # -- per-phase wall time -------------------------------------------
    phases = [e for e in events
              if e.get("ph") == "X" and e.get("cat") == "lifecycle"]
    if phases:
        lines.append("\n-- lifecycle phases (wall time) --")
        for e in sorted(phases, key=lambda e: e["ts"]):
            lines.append(f"{_fmt_s(e.get('dur', 0.0))}  {e['name']}")

    # -- op latency quantiles ------------------------------------------
    op_durs_us = sorted(e.get("dur", 0.0) for e in events
                        if e.get("ph") == "X" and e.get("cat") == "op")
    if op_durs_us:
        lines.append(f"\n-- op latency ({len(op_durs_us)} ops, "
                     "from trace spans) --")
        for q in (0.5, 0.9, 0.99):
            v = _quantile(op_durs_us, q)
            lines.append(f"p{int(q * 100):<3} {v / 1e3:10.3f} ms")

    metrics = None
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            metrics = json.load(f)

    def _series(section, name):
        """The first series matching ``name`` exactly or with labels
        appended (``name{...}``) -- campaign/fleet runs stamp their
        obs-context as default labels into every snapshot key."""
        for k, v in sorted((section or {}).items()):
            if k == name or k.startswith(name + "{"):
                return v
        return None

    if metrics:
        if not op_durs_us:
            h = _series(metrics.get("histograms"),
                        "interpreter.op_latency_s")
            if h and h.get("count"):
                lines.append(f"\n-- op latency ({h['count']} ops, "
                             "from metrics histogram) --")
                lines.append(
                    f"mean {h['sum'] / h['count'] * 1e3:10.3f} ms   "
                    f"max {h['max'] * 1e3:10.3f} ms")
        counters = metrics.get("counters", {})
        ops = {k: v for k, v in sorted(counters.items())
               if k.startswith("interpreter.ops_completed")}
        if ops:
            lines.append("\n-- op counts --")
            for k, v in ops.items():
                lines.append(f"{v:8d}  {k}")
        wgl = {k: v for k, v in sorted(counters.items())
               if k.startswith("wgl.")}
        wgl.update({k: v for k, v in
                    sorted(metrics.get("gauges", {}).items())
                    if k.startswith("wgl.")})
        if wgl:
            lines.append("\n-- WGL search telemetry --")
            for k, v in wgl.items():
                lines.append(f"{v!s:>12}  {k}")

        # per-bucket padding waste + dispatch duty cycle (the run's
        # whole-trace wall is the duty denominator)
        run_wall_s = None
        xs = [e for e in events if e.get("ph") == "X"]
        if xs:
            run_wall_s = (max(e.get("ts", 0.0) + e.get("dur", 0.0)
                              for e in xs)
                          - min(e.get("ts", 0.0) for e in xs)) / 1e6
        lines += _introspection_lines(metrics, run_wall_s)

    if events:
        from .obs.bubbles import fold_events
        lines += _bubble_lines(_contained(lambda: fold_events(events)))

    if metrics:
        counters = metrics.get("counters", {})

        mon = {k: v for k, v in sorted(counters.items())
               if k.startswith("monitor.")}
        mon.update({k: v for k, v in
                    sorted(metrics.get("gauges", {}).items())
                    if k.startswith("monitor.")})
        mh = _series(metrics.get("histograms"), "monitor.check_s")
        if mon or mh:
            lines.append("\n-- streaming monitor --")
            for k, v in mon.items():
                lines.append(f"{v!s:>12}  {k}")
            if mh and mh.get("count"):
                lines.append(
                    f"check wall: mean "
                    f"{mh['sum'] / mh['count'] * 1e3:.1f} ms   "
                    f"max {mh['max'] * 1e3:.1f} ms over {mh['count']} "
                    "check(s)")
            lines += _stream_lines(mon)

    # the monitor's violation instant, if the run recorded one
    violations = [e for e in events
                  if e.get("ph") == "i"
                  and e.get("name") == "monitor.violation"]
    for e in violations:
        args = e.get("args") or {}
        lines.append(
            f"\n!! monitor violation at history index "
            f"{args.get('detected_at_index')} "
            f"(detection latency {args.get('detection_latency_s')}s)")

    # -- proof-carrying verdict (analysis/certify.py) -------------------
    lines += _certificate_lines(store_dir)

    if len(lines) == 1:
        lines.append("(no trace.jsonl / metrics.json found)")
    return "\n".join(lines)


def _stream_lines(mon):
    """The streamlin digest: frontier size + the per-chunk fold cost
    that MAKES the O(window) claim observable (mirrors the txn
    monitor's ``closure_rebuilds`` contract -- the claim is checked in
    counters, not asserted in wall clock). ``mon`` is the merged
    monitor.* counter/gauge map already printed above; this derives
    the per-fold averages those raw totals hide."""
    seals = mon.get("monitor.seal_folds", 0)
    probes = mon.get("monitor.probe_folds", 0)
    folds = seals + probes
    if not folds:
        return []
    out = []
    fs = mon.get("monitor.frontier_size")
    fp = mon.get("monitor.frontier_peak")
    if fs is not None or fp is not None:
        out.append(f"frontier: {fs if fs is not None else '?'} "
                   f"config(s) live (peak "
                   f"{fp if fp is not None else '?'})")
    cells = mon.get("monitor.fold_cells", 0)
    out.append(f"fold cost: {cells / folds:.1f} cells/fold over "
               f"{folds} fold(s) ({seals} seal / {probes} probe) -- "
               "flat across the stream when re-checks are O(window)")
    flats = mon.get("monitor.stream_flat_checks", 0)
    if flats:
        out.append(f"!! {flats} flat fall-back check(s) "
                   "(degraded streams re-search the prefix)")
    mism = mon.get("monitor.stream_confirm_mismatches", 0)
    if mism:
        out.append(f"!! {mism} frontier suspicion(s) NOT confirmed "
                   "offline (fingerprint collisions; verdicts "
                   "unaffected)")
    return out


def _certificate_lines(store_dir):
    """The run's certificate.json at a glance: the verdict it
    certifies, the checks that ran (witness replay, segment
    re-certification, cross-check, differential), and any VC
    findings; [] for uncertified runs."""
    try:
        with open(os.path.join(store_dir, "certificate.json")) as f:
            cert = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(cert, dict):
        return []
    lines = ["\n-- verdict certificate --"]
    counts = cert.get("counts") or {}
    verdict = "clean" if not counts.get("error") else "FAILED"
    lines.append(f"{verdict}: verdict {cert.get('verdict')!r} "
                 f"(engine {cert.get('engine')}), "
                 f"{cert.get('rows', '?')} row(s); "
                 f"{counts.get('error', 0)} error(s), "
                 f"{counts.get('info', 0)} info")
    for c in (cert.get("checks") or [])[:8]:
        detail = {k: v for k, v in c.items() if k != "name"}
        lines.append(f"  {c.get('name')}: {detail}")
    for d in (cert.get("diagnostics") or [])[:8]:
        loc = f" {d.get('location')}" if d.get("location") else ""
        lines.append(f"  {str(d.get('severity', '?')).upper()} "
                     f"{d.get('code')}{loc}: {d.get('message')}")
    return lines


def _introspection_lines(metrics_like, wall_s=None):
    """The padding-waste table + dispatch duty-cycle lines from any
    metrics snapshot/fold dict; [] when the run recorded no padding
    accounting."""
    from .obs.merge import introspection_summary
    summary = introspection_summary(metrics_like, makespan_s=wall_s)
    lines = []
    if summary.get("padding"):
        lines.append("\n-- padding waste (per n-bucket) --")
        lines.append(f"{'bucket':>8}  {'real':>10}  {'padded':>10}  "
                     "waste")
        for b, st in summary["padding"].items():
            lines.append(f"{b:>8}  {st['real']:>10}  "
                         f"{st['padded']:>10}  "
                         f"{st['waste_frac'] * 100:5.1f}%")
    busy = summary.get("device_busy_s") or {}
    chunk = summary.get("chunk_s") or {}
    if busy:
        lines.append(DUTY_TITLE)
        lines.append(DUTY_NOTE)
        for eng, s in busy.items():
            extra = ""
            if eng in chunk and chunk[eng] > 0:
                extra = (f"   of {chunk[eng]:.3f}s chunk wall "
                         f"({s / chunk[eng] * 100:.1f}%)")
            lines.append(f"{s:10.3f}s  dispatch ({eng}){extra}")
        if summary.get("duty_cycle") is not None:
            lines.append(f"{summary['duty_cycle'] * 100:9.1f}%  "
                         "dispatch duty cycle (dispatch / wall; >100% = "
                         "overlapping searches across workers)")
        elif wall_s is None:
            lines.append("(no trace wall to compute the duty cycle "
                         "against)")
    phase_s = summary.get("phase_s") or {}
    if phase_s:
        lines.append("\n-- where the time goes (per-dispatch "
                     "phases) --")
        for eng, per in phase_s.items():
            total = sum(per.values()) or 1.0
            lines.append(f"{eng}:")
            for p, s in sorted(per.items(), key=lambda kv: -kv[1]):
                lines.append(f"{s:10.3f}s  {p:<8} "
                             f"({s / total * 100:5.1f}%)")
        if any("compile" in per for per in phase_s.values()):
            lines.append(COMPILE_NOTE)
    return lines


def _bubble_lines(ledger):
    """The idle-bubble section from a bubble ledger dict
    (obs.bubbles); [] when the trace carried no phase spans."""
    if not ledger or not ledger.get("episodes"):
        return []
    lines = [BUBBLE_TITLE]
    lines.append(f"{ledger['device_s']:10.3f}s  device lap "
                 f"({ledger['lanes']} lane(s), "
                 f"{ledger['episodes']} episode(s))")
    lines.append(f"{ledger['idle_s']:10.3f}s  idle, "
                 f"{ledger['attribution_frac'] * 100:.1f}% attributed")
    idle = ledger.get("idle_s") or 0.0
    for p, s in sorted((ledger.get("phases") or {}).items(),
                       key=lambda kv: -kv[1]):
        if p == "device" or s <= 0:
            continue
        pct = f" ({s / idle * 100:5.1f}% of idle)" if idle else ""
        lines.append(f"{s:10.3f}s  {p:<8}{pct}")
    if ledger.get("residual_s"):
        lines.append(f"{ledger['residual_s']:10.3f}s  (unattributed "
                     "residual)")
    if ledger.get("inter_episode_s"):
        lines.append(f"{ledger['inter_episode_s']:10.3f}s  between "
                     "episodes (outside the dispatch pipeline)")
    return lines


#: serializes ``_store_rooted_at`` scopes: two summaries in threads of
#: one process would otherwise restore each other's roots out of order
_store_root_lock = threading.Lock()


@contextlib.contextmanager
def _store_rooted_at(campaign_dir):
    """Point jepsen_tpu_torch.store at the store that owns
    ``campaign_dir`` (.../store/campaigns/<id> -> .../store) and restore
    it, also when the body raises -- the one place both in-process
    fallbacks (the fleetlint audit and the metrics fold) mutate the
    module global. Yields the campaign id."""
    from . import store
    with _store_root_lock:
        old = store.base_dir
        store.base_dir = os.path.dirname(os.path.dirname(campaign_dir))
        try:
            yield os.path.basename(campaign_dir)
        finally:
            store.base_dir = old


def _resolve_campaign_dir(arg):
    """A campaign directory from a path, a campaign id, or (None) the
    most recent campaign under store/campaigns/."""
    if arg and os.path.isdir(arg):
        return os.path.realpath(arg)
    base = os.path.join("store", "campaigns")
    if arg:
        p = os.path.join(base, arg)
        return os.path.realpath(p) if os.path.isdir(p) else None
    if not os.path.isdir(base):
        return None
    cands = sorted(e for e in os.listdir(base)
                   if os.path.isdir(os.path.join(base, e)))
    return os.path.realpath(os.path.join(base, cands[-1])) \
        if cands else None


def _span_sum(events, pred):
    return sum(e.get("dur", 0.0) for e in events
               if e.get("ph") == "X" and pred(e))


def _read_json(path):
    """A JSON file's value, or None when it is missing or malformed."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def summarize_campaign(campaign_dir):
    """Render the campaign view of a merged trace; returns the text."""
    lines = [f"== campaign {campaign_dir} =="]
    trace_path = os.path.join(campaign_dir, "campaign_trace.jsonl")
    events = []
    if not os.path.exists(trace_path):
        # keep going: the report-based sections (capacity oracle,
        # metrics fold, fleetlint audit) don't need the merged trace
        lines.append(NO_MERGED_TRACE)
    else:
        events = _load_trace(trace_path)

    report = _read_json(os.path.join(campaign_dir, "report.json")) or {}
    metrics = _read_json(os.path.join(campaign_dir, "metrics.json")) or {}

    # -- lanes ----------------------------------------------------------
    makespan_s = None
    lanes = {int(e["pid"]): (e.get("args") or {}).get("name", "?")
             for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    winfo = (report.get("trace") or {}).get("workers") or {}
    if events:
        lines.append(f"\n-- lanes ({len(events)} events) --")
    for pid in sorted(lanes):
        name = lanes[pid]
        extra = ""
        w = name[len("worker "):] if name.startswith("worker ") else None
        if w in winfo:
            extra = (f"   cells {winfo[w].get('cells')}, clock offset "
                     f"{winfo[w].get('offset_s', 0.0):+.6f}s")
        lines.append(f"lane {pid}: {name}{extra}")

    # -- makespan vs summed cell wall -----------------------------------
    xs = [e for e in events if e.get("ph") == "X"]
    if xs:
        t_lo = min(e.get("ts", 0.0) for e in xs)
        t_hi = max(e.get("ts", 0.0) + e.get("dur", 0.0) for e in xs)
        makespan_us = t_hi - t_lo
        makespan_s = makespan_us / 1e6
        # the coordinator's fleet.cell spans cover lease exec end to
        # end; runs merged from worker lanes carry jepsen.run
        cell_spans = [e for e in xs if e.get("name") == "fleet.cell"] \
            or [e for e in xs if e.get("name") == "jepsen.run"]
        cell_sum_us = sum(e.get("dur", 0.0) for e in cell_spans)
        lines.append("\n-- makespan --")
        lines.append(f"{_fmt_s(makespan_us)}  campaign makespan")
        lines.append(f"{_fmt_s(cell_sum_us)}  summed cell wall "
                     f"({len(cell_spans)} cells)")
        if makespan_us > 0 and cell_sum_us > 0:
            lines.append(f"{cell_sum_us / makespan_us:10.2f}x "
                         " achieved parallelism")

        # -- per-worker utilization + breakdown -------------------------
        lines.append("\n-- per-worker (exec / search / sync) --")
        for pid in sorted(lanes):
            name = lanes[pid]
            lane_evs = [e for e in xs if e.get("pid") == pid]
            if name == "coordinator":
                # the coordinator's view of each worker, keyed by the
                # span's worker arg: exec occupancy + sync wall
                by_worker = {}
                for e in lane_evs:
                    w = (e.get("args") or {}).get("worker")
                    if w is None:
                        continue
                    st = by_worker.setdefault(str(w),
                                              {"exec": 0.0, "sync": 0.0})
                    if e.get("name") == "fleet.cell":
                        st["exec"] += e.get("dur", 0.0)
                    elif e.get("name") == "fleet.artifact_sync":
                        st["sync"] += e.get("dur", 0.0)
                for w, st in sorted(by_worker.items()):
                    busy = st["exec"] / makespan_us * 100 \
                        if makespan_us else 0.0
                    lines.append(
                        f"{w:>16}  exec {st['exec'] / 1e6:8.3f}s "
                        f"({busy:5.1f}% of makespan)   sync "
                        f"{st['sync'] / 1e6:8.3f}s")
            else:
                run_us = _span_sum(lane_evs,
                                   lambda e: e.get("name") == "jepsen.run")
                search_us = _span_sum(lane_evs,
                                      lambda e: e.get("name") == "analyze")
                if run_us or search_us:
                    lines.append(
                        f"{name:>16}  run {run_us / 1e6:8.3f}s   "
                        f"search/analyze {search_us / 1e6:8.3f}s")

        # -- critical path: the longest cells ---------------------------
        longest = sorted(cell_spans, key=lambda e: -e.get("dur", 0.0))
        if longest:
            lines.append("\n-- critical path (longest cells) --")
            for e in longest[:5]:
                args = e.get("args") or {}
                lines.append(
                    f"{_fmt_s(e.get('dur', 0.0))}  "
                    f"{args.get('cell', e.get('name'))} "
                    f"(worker {args.get('worker', '?')})")

    # -- device-slot wait -----------------------------------------------
    dw = (metrics.get("histograms") or {}).get("campaign.device_wait_s")
    if dw and dw.get("count"):
        lines.append("\n-- device-slot wait --")
        lines.append(f"mean {dw['sum'] / dw['count'] * 1e3:10.3f} ms   "
                     f"max {dw['max'] * 1e3:10.3f} ms over "
                     f"{dw['count']} check(s)")

    # -- fleet counters (leases, steals, syncs, chaos) ------------------
    counters = metrics.get("counters") or {}
    fleet = {k: v for k, v in sorted(counters.items())
             if k.startswith(("fleet.", "chaos."))}
    if fleet:
        lines.append("\n-- fleet counters --")
        for k, v in fleet.items():
            lines.append(f"{v!s:>12}  {k}")

    # -- device introspection: per-bucket padding waste + duty cycle ----
    # (metrics_fold.json is the per-cell fold run_fleet writes at
    # finalize; fold in process when it is missing -- read-only)
    fold = _read_json(os.path.join(campaign_dir, "metrics_fold.json"))
    if fold is None:
        from .obs.merge import fold_campaign_metrics

        def fold_here():
            with _store_rooted_at(campaign_dir) as cid:
                return fold_campaign_metrics(cid, persist=False)

        fold = _contained(fold_here)
    if fold is not None:
        lines += _introspection_lines(fold, makespan_s)

    # -- idle-bubble ledger: where the non-device time went -------------
    # (bubble_ledger.json is the fold run_fleet writes at finalize;
    # fold the merged trace in process when it is missing)
    ledger = _read_json(os.path.join(campaign_dir, "bubble_ledger.json"))
    if ledger is None and events:
        from .obs.bubbles import fold_events
        ledger = _contained(lambda: fold_events(events))
    if ledger is not None:
        lines += _bubble_lines(ledger)

    # -- capacity plan: predicted vs actual plan shapes -----------------
    lines += _capacity_lines(campaign_dir, report)

    # -- control-plane audit (analysis.fleetlint) -----------------------
    fa = _fleet_audit(campaign_dir)
    if fa is None:
        lines.append("\n-- fleetlint audit --\n(no fleet_analysis."
                     "json and the audit could not run)")
    else:
        c = fa.get("counts") or {}
        checks = fa.get("checks") or {}
        lines.append("\n-- fleetlint audit --")
        verdict = "clean" if not c.get("error") else "FAILED"
        lines.append(
            f"{verdict}: {c.get('error', 0)} error(s), "
            f"{c.get('warning', 0)} warning(s), {c.get('info', 0)} "
            f"info over {checks.get('records', '?')} journal "
            f"records / {checks.get('runs_audited', '?')} run "
            "traces")
        for d in (fa.get("diagnostics") or [])[:8]:
            loc = f" {d.get('location')}" if d.get("location") else ""
            lines.append(f"  {str(d.get('severity', '?')).upper()} "
                         f"{d.get('code')}{loc}: {d.get('message')}")

    # -- sampled verdict certification (analysis/certify.py) ------------
    certn = (report or {}).get("certification")
    if certn:
        c = certn.get("counts") or {}
        verdict = "clean" if not c.get("error") else "FAILED"
        lines.append("\n-- verdict certification (sampled) --")
        lines.append(
            f"{verdict}: {certn.get('sampled', 0)}/{certn.get('of', 0)}"
            f" run(s) re-certified; {c.get('error', 0)} error(s), "
            f"{c.get('info', 0)} info"
            + (f"; codes {certn.get('codes')}" if certn.get("codes")
               else ""))
        for r in (certn.get("runs") or [])[:8]:
            rc = r.get("counts") or {}
            state = "ok" if not rc.get("error") else \
                f"FAILED {r.get('codes')}"
            lines.append(f"  {r.get('path')}: {state}")

    return "\n".join(lines)


def _capacity_lines(campaign_dir, report):
    """The capacity planner's predicted-vs-actual plan-shape error for a
    planned campaign (report.json["capacity"], the capplan prediction
    oracle); [] when the campaign was never planned."""
    cap = (report or {}).get("capacity")
    if not cap and os.path.exists(os.path.join(campaign_dir,
                                               "capacity_plan.json")):
        cap = {"oracle": None}
    if not cap:
        return []
    lines = ["\n-- capacity plan (predicted vs actual) --"]
    oracle = cap.get("oracle")
    if not oracle:
        lines.append("(capacity_plan.json present but no oracle in "
                     "report.json -- campaign not finalized?)")
        return lines
    pred = {tuple(k) for k in oracle.get("predicted") or []}
    act = {tuple(k) for k in oracle.get("actual") or []}
    lines.append(CAPACITY_NOTE)
    lines.append(f"{'model':<20} {'bucket':>7}  predicted  actual")
    for m, b in sorted(pred | act):
        lines.append(f"{m:<20} {b:>7}  "
                     f"{'yes' if (m, b) in pred else 'no':>9}  "
                     f"{'yes' if (m, b) in act else 'no'}")
    lines.append(f"prediction error: {oracle.get('error_frac')} "
                 f"({len(oracle.get('missed') or [])} missed, "
                 f"{len(oracle.get('unplanned') or [])} unplanned)")
    rec = cap.get("recommendation")
    if rec:
        lines.append(f"recommendation: an op-count floor of "
                     f"{rec['set_n_floor']} would collapse the plan "
                     f"shapes to {rec['distinct_after']} "
                     f"(from {rec['distinct_before']}); the port's floor "
                     "is a constant and a coarser bucket only adds "
                     "padding rows")
    return lines


def _fleet_audit(campaign_dir):
    """The campaign's fleetlint report: the persisted
    fleet_analysis.json when present, else a fresh in-process audit
    (read-only -- nothing is written), else None."""
    fa = _read_json(os.path.join(campaign_dir, "fleet_analysis.json"))
    if fa is not None:
        return fa

    def audit_here():
        from .analysis import fleetlint
        with _store_rooted_at(campaign_dir) as cid:
            report, _diags = fleetlint.audit(cid, persist=False)
        return report

    return _contained(audit_here)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if argv and argv[0] == "--campaign":
        cdir = _resolve_campaign_dir(argv[1] if len(argv) > 1 else None)
        if cdir is None:
            print("no campaign directory found", file=sys.stderr)
            return 1
        print(summarize_campaign(cdir))
        return 0
    store_dir = argv[0] if argv else os.path.join("store", "latest")
    store_dir = os.path.realpath(store_dir)
    if not os.path.isdir(store_dir):
        print(f"not a directory: {store_dir}", file=sys.stderr)
        return 1
    print(summarize(store_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
