"""How often does the trend gate fail A/A on this machine?

Runs ``jepsen_tpu_torch.obs.trend.mini_bench`` back to back in one
process, in pairs, and gates each pair's second record against its
first with ``trend.compare`` (the gate ``python -m
jepsen_tpu_torch.obs.trend gate`` runs). No code differs between the
two records of a pair, so every regression the gate reports is a false
one: the rung's own noise. It does this for each ``--repeats`` value
asked for, so the number of repeats a record needs can be read off.
Each record also notes the card's SM clock as ``nvidia-smi`` reads it
just before the record (null where nvidia-smi is missing).

Prints one JSON object: the card's name and power limit, and for each
repeats value the pairs' best ops/s, their samples, the gate's verdict
and the count of false regressions.

Usage::

    python tools/trend_aa.py [--pairs 12] [--repeats 3 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def smi(query):
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--repeats", type=int, nargs="+", default=[3, 10])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from jepsen_tpu_torch.obs import trend

    fp = trend.fingerprint()
    out = {"card": smi("name,power.limit"), "fingerprint": fp, "runs": []}
    rung = "mini-cas-batch"
    for repeats in args.repeats:
        pairs = []
        for _ in range(args.pairs):
            recs, clocks = [], []
            for _ in range(2):
                clocks.append(smi("clocks.sm"))
                recs.append({"fingerprint": fp, "rungs": trend.mini_bench(
                    repeats=repeats, device=args.device)})
            verdict = trend.compare(recs[:1], recs[1])
            pairs.append({
                "best": [r["rungs"][rung]["metrics"]["ops_per_s"]
                         for r in recs],
                "samples": [r["rungs"][rung]["samples"]["ops_per_s"]
                            for r in recs],
                "sm_clock": clocks,
                "regressions": verdict["regressions"]})
        out["runs"].append({
            "repeats": repeats, "pairs": pairs,
            "false_regressions": sum(1 for p in pairs if p["regressions"]),
            "best_min": min(b for p in pairs for b in p["best"]),
            "best_max": max(b for p in pairs for b in p["best"])})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
