"""Persistent bench trend log + noise-aware regression gate (the port's
copy of ``jepsen_tpu/obs/trend.py``).

Nothing tracked perf ACROSS runs: a duty-cycle or ops/s regression
could only be noticed by a human rereading a bench line. This module
gives a bench rung a durable trend record and a comparator a CI job can
gate on:

* ``record()`` appends one JSON line per bench run to
  ``store/bench/trend.jsonl``: the rung metrics (best value + the raw
  repeat samples), and an environment **fingerprint**. The port's
  fingerprint names the torch build, the CUDA device's name and compute
  capability, the device count, ``CUDA_VISIBLE_DEVICES`` and the
  hostname, in place of the JAX package's jax version, platform and
  ``JAX_PLATFORMS`` (ROADMAP.md, deliberate divergences). trend.jsonl
  is a log, not a deterministic artifact -- wall stamps are fine here.
* ``compare()`` is the gate: a metric's signal is the BEST of its
  repeat samples (min wall <=> max rate -- the quiet floor is what the
  machine can do, everything above it is scheduler noise), and the
  baseline's own spread ``(best - worst) / best`` is the measured
  noise floor. A regression fires only when the current quiet floor
  drops below ``baseline_best * (1 - max(threshold, noise))`` -- so
  back-to-back A/A runs pass with zero false regressions while a
  genuine slowdown (injected via ``JEPSEN_BENCH_INJECT_SLEEP_MS``)
  lands well outside the floor.
* Comparisons REFUSE to gate across differing fingerprints: a faster
  card is not a perf win and a slower one is not a regression.
  Mismatched baseline records are skipped and counted; planlint PL022
  warns ahead of time when ``trend-baseline`` points at records from
  another environment.

``mini_bench()`` is the self-contained rung: a small cas-register key
batch through the port's ``keyshard.check_batch_encoded`` on the
caller's device (the card unless ``device="cpu"``), warm, min-of-N
over the repeats. The sleep knob is honored INSIDE the measured
region, so the injected run is slower in exactly the way a real
host-loop regression would be.

    python -m jepsen_tpu_torch.obs.trend record [--device cpu]
    python -m jepsen_tpu_torch.obs.trend gate
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time as _time

__all__ = ["TREND_FILE", "GATE_KEYS", "fingerprint", "trend_path",
           "record", "load", "compare", "mini_bench", "main"]

TREND_FILE = "trend.jsonl"

#: metrics the gate compares (higher is better); everything else in a
#: record is context for humans reading the trend
GATE_KEYS = ("ops_per_s",)

#: default regression allowance when the baseline's measured noise
#: floor is smaller (CPU CI boxes jitter; the injected-slowdown CI
#: case lands far below 1 - this)
DEFAULT_THRESHOLD = 0.2

INJECT_ENV = "JEPSEN_BENCH_INJECT_SLEEP_MS"


def fingerprint():
    """The environment identity a trend record is only comparable
    within. Device probing is contained: a host whose CUDA runtime
    cannot initialize still fingerprints (the device fields become
    None, and ``platform`` says "cpu")."""
    fp = {"hostname": socket.gethostname(),
          "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
          "torch": None, "platform": None, "device": None,
          "capability": None, "device_count": None}
    try:
        import torch
        fp["torch"] = torch.__version__
        if torch.cuda.is_available():
            fp["platform"] = "cuda"
            fp["device"] = torch.cuda.get_device_name(0)
            fp["capability"] = list(torch.cuda.get_device_capability(0))
            fp["device_count"] = torch.cuda.device_count()
        else:
            fp["platform"] = "cpu"
            fp["device_count"] = 0
    except Exception:  # noqa: BLE001 - the fingerprint never raises
        pass
    return fp


def trend_path():
    from .. import store
    return os.path.join(store.base_dir, "bench", TREND_FILE)


def record(rungs, path=None, fp=None, label=None):
    """Append one trend record ``{"t", "fingerprint", "rungs"}``.
    ``rungs`` is {rung_name: {"metrics": {k: best}, "samples":
    {k: [per-repeat values]}}}."""
    path = path or trend_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    rec = {"t": round(_time.time(), 3),
           "fingerprint": fp or fingerprint(), "rungs": rungs}
    if label:
        rec["label"] = str(label)
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec


def load(path=None):
    """All parseable records in a trend log (missing file -> [])."""
    path = path or trend_path()
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip().rstrip(",")
                if not line or line in ("[", "]"):
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "rungs" in rec:
                    out.append(rec)
    except OSError:
        return []
    return out


def _samples(rec, rung, key):
    r = (rec.get("rungs") or {}).get(rung) or {}
    vals = [v for v in (r.get("samples") or {}).get(key, [])
            if isinstance(v, (int, float))]
    if not vals:
        m = (r.get("metrics") or {}).get(key)
        if isinstance(m, (int, float)):
            vals = [m]
    return vals


def compare(baseline, current, threshold=DEFAULT_THRESHOLD,
            keys=GATE_KEYS):
    """Gate ``current`` (one record) against ``baseline`` (a list of
    records). Returns a verdict dict; ``regressions`` is empty iff the
    gate passes. Baseline records whose fingerprint differs from the
    current record's are REFUSED (skipped + counted), never
    compared."""
    if threshold is None:
        threshold = DEFAULT_THRESHOLD
    threshold = float(threshold)
    cur_fp = current.get("fingerprint")
    usable = [r for r in baseline if r.get("fingerprint") == cur_fp]
    out = {"compared": 0, "regressions": [],
           "baseline_records": len(usable),
           "skipped_mismatched_env": len(baseline) - len(usable),
           "threshold": threshold}
    for rung in sorted((current.get("rungs") or {})):
        for key in keys:
            c_vals = _samples(current, rung, key)
            b_vals = [v for r in usable
                      for v in _samples(r, rung, key)]
            if not c_vals or not b_vals:
                continue
            b_best, c_best = max(b_vals), max(c_vals)
            if b_best <= 0:
                continue
            noise = (b_best - min(b_vals)) / b_best
            allowed = max(threshold, noise)
            out["compared"] += 1
            if c_best < b_best * (1.0 - allowed):
                out["regressions"].append({
                    "rung": rung, "metric": key,
                    "baseline": round(b_best, 4),
                    "current": round(c_best, 4),
                    "drop_frac": round(1.0 - c_best / b_best, 4),
                    "allowed_frac": round(allowed, 4)})
    return out


# ---------------------------------------------------------------------------
# the CI rung

def mini_bench(n_keys=6, n_ops=120, repeats=5, seed=3, device=None):
    """One small cas-register key batch, warm, min-of-N: the rung a
    perf-trend job records and gates. Returns the ``rungs`` map
    ``record()`` expects, with duty cycle and the phase breakdown
    folded in as context metrics. The batch runs on ``device`` (None:
    the card, raising without one; tests pass "cpu"); the key batch
    pins the scan rollout, so it launches no rollout kernel."""
    import random as _r

    from .. import obs
    from ..models import cas_register_spec
    from ..obs.metrics import parse_flat_key
    from ..parallel import keyshard
    from ..simulate import random_history

    sleep_s = 0.0
    try:
        sleep_s = max(0.0, float(os.environ.get(INJECT_ENV) or 0.0)
                      / 1e3)
    except ValueError:
        pass

    pairs = [cas_register_spec.encode(
        random_history(_r.Random(seed + i), "cas-register",
                       n_procs=4, n_ops=n_ops, crash_p=0.0))
        for i in range(n_keys)]
    total_ops = sum(len(e) for e, _ in pairs)

    keyshard.check_batch_encoded(cas_register_spec, pairs,
                                 chunk_iters=64,
                                 device=device)  # warm-up
    reg = obs.Registry()
    samples = []
    with obs.bind(None, reg):
        for _ in range(max(1, int(repeats))):
            t0 = _time.monotonic()
            keyshard.check_batch_encoded(cas_register_spec, pairs,
                                         chunk_iters=64, device=device)
            if sleep_s:
                _time.sleep(sleep_s)
            samples.append(total_ops / (_time.monotonic() - t0))
    wall_s = sum(total_ops / s for s in samples)
    snap = reg.snapshot()["counters"]
    busy = sum(v for k, v in snap.items()
               if parse_flat_key(k)[0] == "wgl.device_busy_s")
    phase_s = {}
    for k, v in snap.items():
        name, labels = parse_flat_key(k)
        if name == "wgl.phase_s":
            p = labels.get("phase") or "?"
            phase_s[p] = round(phase_s.get(p, 0.0) + float(v), 6)
    metrics = {"ops_per_s": round(max(samples), 2),
               "duty_cycle": round(busy / wall_s, 4) if wall_s else 0.0,
               "ops": total_ops, "keys": n_keys}
    return {"mini-cas-batch": {
        "metrics": metrics,
        "samples": {"ops_per_s": [round(s, 2) for s in samples]},
        "phase_s": dict(sorted(phase_s.items()))}}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.obs.trend",
        description="bench trend log: record a rung, gate the latest "
                    "record against its history")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rec = sub.add_parser("record", help="run mini_bench, append one "
                                        "trend record")
    rec.add_argument("--path", default=None)
    rec.add_argument("--repeats", type=int, default=5)
    rec.add_argument("--label", default=None)
    rec.add_argument("--device", default=None, choices=["cuda", "cpu"],
                     help="Where the rung's key batch runs (default: "
                          "cuda; without a card it fails).")
    gate = sub.add_parser("gate", help="compare the newest record "
                                       "against prior ones")
    gate.add_argument("--path", default=None)
    gate.add_argument("--threshold", type=float,
                      default=DEFAULT_THRESHOLD)
    gate.add_argument("--window", type=int, default=8,
                      help="how many prior records form the baseline")
    ns = ap.parse_args(argv)

    if ns.cmd == "record":
        rungs = mini_bench(repeats=ns.repeats, device=ns.device)
        rec = record(rungs, path=ns.path, label=ns.label)
        print(json.dumps(rec, sort_keys=True))
        return 0

    records = load(ns.path)
    if len(records) < 2:
        print(json.dumps({"gate": "refused",
                          "reason": "need >= 2 trend records",
                          "records": len(records)}))
        return 0
    current = records[-1]
    baseline = records[:-1][-max(1, ns.window):]
    verdict = compare(baseline, current, threshold=ns.threshold)
    verdict["gate"] = "fail" if verdict["regressions"] else (
        "refused-env" if not verdict["baseline_records"] else "pass")
    print(json.dumps(verdict, sort_keys=True))
    return 1 if verdict["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
