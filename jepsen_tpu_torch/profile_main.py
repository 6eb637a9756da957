"""Where the time goes on the card, for the main path and the key batch.

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

``--batch`` profiles the key batch of ``chip_smoke.py`` instead: the JAX
package's headline batch (``simulate.bench_histories``: 256 cas-register
keys of 200 ops) through ``parallel.check_batch_encoded``, one warm-up
call and one profiled call, printed as one JSON line with the same
fields but the host time before and after the search (iterations are
the batch's: its longest-running key's), plus the compactions and the
invalid keys. Its trace is not written: it holds hundreds of thousands
of kernels.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

HISTORIES = (("cas-register", 0.05), ("mutex", 0.02))


def split(events, iterations):
    """The profiled run's time split from its events, each ``(start_us,
    end_us, name, is_kernel)``: the span from the first to the last
    event split at the first and last kernel, kernel launches (per
    iteration), device busy time and idle share, and the kernels that
    take the most device time."""
    start = min(e[0] for e in events)
    span = max(e[1] for e in events) - start
    kern = sorted((e for e in events if e[3]), key=lambda e: e[0])
    first = kern[0][0] - start
    last = kern[-1][1] - start
    busy = sum(e[1] - e[0] for e in kern)
    by_name = {}
    for e in kern:
        us, c = by_name.get(e[2], (0.0, 0))
        by_name[e[2]] = (us + e[1] - e[0], c + 1)
    roll = sum(us for k, (us, _) in by_name.items()
               if "jt_rollout_kernel" in k)
    its = iterations or 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"iterations": iterations, "trace_span_s": span / 1e6,
            # host encode and prepare before the first kernel, the search
            # loop between, the witness decode and replay after the last
            "host_before_first_kernel_s": first / 1e6,
            "search_loop_s": (last - first) / 1e6,
            "host_after_last_kernel_s": (span - last) / 1e6,
            "search_loop_per_iteration_s": (last - first) / 1e6 / its,
            "kernel_launches": len(kern),
            "kernel_launches_per_iteration": len(kern) / its,
            "device_busy_s": busy / 1e6,
            "device_idle_share": 1 - busy / span,
            "device_idle_share_in_search_loop": 1 - busy / (last - first),
            "rollout_kernel_s": roll / 1e6,
            "rollout_share_of_busy": roll / busy,
            "top_kernels": [{"name": k[:90], "device_s": us / 1e6,
                             "count": c} for k, (us, c) in top]}


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
        ev = [(e["ts"], e["ts"] + e["dur"], e["name"],
               e.get("cat") == "kernel")
              for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return {"model": model, "valid": r["valid"],
            "configs_explored": r.get("configs_explored"),
            "rollout_launches": rollout.launches, "wall_s": wall,
            **split(ev, r.get("iterations"))}


def profile_batch(spec, pairs):
    """One profiled call of the key batch on ``pairs``: kernel launches
    (per iteration), device busy time and idle share, the search loop
    (first to last kernel) and the top kernels, plus the batch's
    compactions and verdict counts. Its trace (hundreds of thousands of
    kernels) is read from the profiler's events, not written; those
    events' device timestamps are not aligned with the host's as the
    Chrome trace's are, so the host time before and after the search is
    not split out here."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import parallel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = parallel.check_batch_encoded(spec, pairs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    ev = [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
           e.device_type() == DeviceType.CUDA
           and not e.name().startswith(("Memcpy", "Memset")))
          for e in prof.profiler.kineto_results.events()]
    out = split(ev, max((r.get("iterations") or 0) for r in res))
    del out["host_before_first_kernel_s"], out["host_after_last_kernel_s"]
    return {"keys": len(pairs),
            "history_ops": sum(len(e) for e, _ in pairs),
            "compactions": max((r.get("compactions") or 0) for r in res),
            "invalid_keys": sum(r["valid"] is False for r in res),
            "unknown_keys": sum(r["valid"] == "unknown" for r in res),
            "wall_s": wall, **out}


def main(argv=None):
    import argparse

    import torch
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.profile_main")
    ap.add_argument("--trace-dir", default=os.path.join("build", "profile"))
    ap.add_argument("--batch", action="store_true",
                    help="profile the 256-key batch instead of the main "
                    "path")
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
    if args.batch:
        from . import models, parallel, simulate
        spec = models.cas_register_spec
        pairs = [spec.encode(h) for h in simulate.bench_histories()[0]]
        parallel.check_batch_encoded(spec, pairs)       # warm-up
        print(json.dumps({"batch": "cas-register",
                          **profile_batch(spec, pairs)}), flush=True)
        return 0
    for model, crash_p in HISTORIES:
        print(json.dumps(profile_case(model, crash_p, args.trace_dir)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
