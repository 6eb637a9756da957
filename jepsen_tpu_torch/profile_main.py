"""Where the main path's time goes on the card.

``python -m jepsen_tpu_torch.profile_main`` (from the root of a checkout,
on a machine with one CUDA device) checks the two main-path histories of
``chip_smoke.py`` -- 10k ops, 64 processes, cas-register and mutex,
seeded with ``random.Random(45100)`` -- once to warm up, then again under
``torch.profiler``, and prints one JSON line per history: wall time;
the trace split at its first and last kernel into host time before the
search (encode, prepare), the search loop and host time after it
(witness decode and replay); kernel launches per iteration; device busy
time (the sum of kernel times: the search runs on one stream) and the
device's idle share; the rollout kernel's share; and the kernels that
take the most device time. ``--trace-dir DIR`` also writes the Chrome
trace of each profiled check there (default: ``build/profile``).
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

HISTORIES = (("cas-register", 0.05), ("mutex", 0.02))


def profile_case(model, crash_p, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import simulate
    from .checker import checkers, rollout
    hist = simulate.random_history(random.Random(45100), model, 64, 10_000,
                                   crash_p)
    chk = checkers.linearizable({"model": model, "algorithm": "jax-wgl"})
    chk.check({}, hist)                              # warm-up
    torch.cuda.synchronize()
    rollout.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        r = chk.check({}, hist)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace-{model}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    start = min(e["ts"] for e in ev)
    span_us = max(e["ts"] + e["dur"] for e in ev) - start
    kern = sorted((e for e in ev if e.get("cat") == "kernel"),
                  key=lambda e: e["ts"])
    first_us = kern[0]["ts"] - start
    last_us = kern[-1]["ts"] + kern[-1]["dur"] - start
    busy_us = sum(e["dur"] for e in kern)
    by_name = {}
    for e in kern:
        us, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + e["dur"], c + 1)
    roll_us = sum(us for k, (us, _) in by_name.items()
                  if "jt_rollout_kernel" in k)
    its = r.get("iterations") or 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"model": model, "valid": r["valid"],
            "iterations": r.get("iterations"),
            "configs_explored": r.get("configs_explored"),
            "rollout_launches": rollout.launches, "wall_s": wall,
            "trace_span_s": span_us / 1e6,
            # the trace split at the first and last kernel: host encode
            # and prepare before, the search loop between, the witness
            # decode and replay after
            "host_before_first_kernel_s": first_us / 1e6,
            "search_loop_s": (last_us - first_us) / 1e6,
            "host_after_last_kernel_s": (span_us - last_us) / 1e6,
            "search_loop_per_iteration_s": (last_us - first_us) / 1e6
            / its,
            "kernel_launches": len(kern),
            "kernel_launches_per_iteration": len(kern) / its,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / span_us,
            "device_idle_share_in_search_loop":
                1 - busy_us / (last_us - first_us),
            "rollout_kernel_s": roll_us / 1e6,
            "rollout_share_of_busy": roll_us / busy_us,
            "top_kernels": [{"name": k[:90], "device_s": us / 1e6,
                             "count": c} for k, (us, c) in top]}


def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.profile_main")
    ap.add_argument("--trace-dir", default=os.path.join("build", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    for model, crash_p in HISTORIES:
        print(json.dumps(profile_case(model, crash_p, args.trace_dir)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
