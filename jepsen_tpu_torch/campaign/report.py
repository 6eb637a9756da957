"""Campaign outcome aggregation: summary, flakes, triage (the port's
copy of ``jepsen_tpu/campaign/report.py``, host-only).

A finished (or aborted) campaign is a list of cell records::

    {"cell": "seed=1,workload=register", "group": "workload=register",
     "outcome": True|False|"unknown"|"crashed"|"aborted",
     "valid": ..., "path": "store/...", "wall_s": 1.2,
     "error": "...", "abort-reason": "...", "params": {...}}

``summarize`` folds them into one report dict with three derived
views:

* **summary** -- outcome counts (the exit-code inputs).
* **flakes** -- cells that share a *group* (same params minus seed)
  but disagree on validity across seeds: the classic seed-sensitive
  test. Only decided outcomes (True/False/"unknown") participate;
  aborted cells say nothing about the workload.
* **triage** -- every non-passing cell bucketed by its failure
  signature (outcome + first line of error / abort reason), so a sweep
  that crashed forty cells the same way reads as one line, not forty.
"""

from __future__ import annotations

__all__ = ["summarize", "results_map", "render_text"]

#: outcomes that represent a full run with a verdict
DECIDED = (True, False, "unknown")


def _signature(rec):
    """One-line failure signature for triage grouping."""
    outcome = rec.get("outcome")
    reason = rec.get("abort-reason") if outcome == "aborted" \
        else rec.get("error")
    if reason:
        reason = str(reason).strip().splitlines()[-1][:160]
        return f"{outcome}: {reason}"
    return str(outcome)


def flakes(records):
    """Groups (same params minus seed) whose decided cells disagree on
    validity across seeds."""
    groups = {}
    for rec in records:
        if rec.get("outcome") not in DECIDED:
            continue
        groups.setdefault(rec.get("group") or rec.get("cell"),
                          []).append(rec)
    out = []
    for gid, recs in sorted(groups.items()):
        if len(recs) < 2:
            continue
        validities = sorted({str(r.get("valid")) for r in recs})
        if len(validities) > 1:
            out.append({
                "group": gid,
                "validities": validities,
                "cells": [{"cell": r.get("cell"),
                           "valid": r.get("valid"),
                           "path": r.get("path")} for r in recs],
            })
    return out


def triage(records):
    """{signature: [cell ids]} over every non-passing cell."""
    out = {}
    for rec in records:
        if rec.get("outcome") is True:
            continue
        out.setdefault(_signature(rec), []).append(rec.get("cell"))
    return {k: sorted(v) for k, v in sorted(out.items())}


def results_map(records):
    """cli.test_all_* shaped results: outcome -> [{"cell", "path"}].
    Keys are str() outcomes ("True"/"False"/"unknown"/...) so the map
    survives a report.json round trip unchanged -- json.dump would
    silently lowercase raw bool keys to "true"/"false", and a consumer
    reloading the report would then compute the wrong exit code. The
    cli group/exit helpers accept both spellings."""
    out = {}
    for rec in records:
        out.setdefault(str(rec.get("outcome")), []).append(
            {"cell": rec.get("cell"), "path": rec.get("path")})
    return out


def summarize(records, meta=None, compile_cache=None, aborted=False,
              abort_reason=None, skipped=0):
    """The aggregate campaign report dict (persisted as
    report.json)."""
    records = list(records)
    counts = {}
    for rec in records:
        key = str(rec.get("outcome"))
        counts[key] = counts.get(key, 0) + 1
    return {
        "campaign": (meta or {}).get("id"),
        "status": "aborted" if aborted else "complete",
        **({"abort-reason": str(abort_reason)} if abort_reason else {}),
        "summary": {"cells": len(records), "skipped-resumed": skipped,
                    "outcomes": counts},
        "flakes": flakes(records),
        "triage": triage(records),
        **({"compile_cache": compile_cache} if compile_cache is not None
           else {}),
        "cells": records,
        "results": results_map(records),
    }


def render_text(report):
    """Human-readable campaign summary for the CLI."""
    lines = [f"# Campaign {report.get('campaign')}: "
             f"{report.get('status')}"]
    if report.get("abort-reason"):
        lines.append(f"  abort reason: {report['abort-reason']}")
    s = report.get("summary") or {}
    lines.append(f"  cells: {s.get('cells', 0)} "
                 f"({s.get('skipped-resumed', 0)} of them from a "
                 "previous run)")
    for outcome, n in sorted((s.get("outcomes") or {}).items()):
        lines.append(f"    {outcome}: {n}")
    cc = report.get("compile_cache")
    if cc is not None:
        lines.append(f"  compile cache: {cc.get('hits', 0)} hits / "
                     f"{cc.get('misses', 0)} misses")
    if report.get("flakes"):
        lines.append("  flaky groups (validity differs across seeds):")
        for fl in report["flakes"]:
            lines.append(f"    {fl['group']}: "
                         f"{' vs '.join(fl['validities'])}")
    if report.get("triage"):
        lines.append("  triage:")
        for sig, cells in report["triage"].items():
            lines.append(f"    {sig} ({len(cells)}): "
                         f"{', '.join(c or '?' for c in cells[:6])}"
                         + (" ..." if len(cells) > 6 else ""))
    return "\n".join(lines)
