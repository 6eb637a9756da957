"""The command line's monitored register run, by the interpreter's switch
interval during the monitor's checks.

``python -m jepsen_tpu_torch.monitor_ab`` (from the root of a checkout,
on a machine with one CUDA device) runs the demo's register workload as
``chip_smoke.py``'s ``cli`` phase does (``test --workload register
--no-ssh --concurrency 10n --per-key-limit 200``, in process, each
store in a temporary directory) for ``--time-limit`` seconds: in
``--turns`` turns, once unmonitored, then with ``--monitor`` and with
``--monitor --bug dirty-read --monitor-chunk 8`` once per interval of
``--intervals`` (``checkers.MONITOR_SWITCH_INTERVAL`` set to it), in an
order that alternates between turns. It prints the card's
``nvidia-smi`` name and power limit, then one JSON line per run: the
interval, the exit code, the wall, the interpreter's client ops/s (the
completed client ops over their span of history time), the monitor's
checks, its time to the first verdict and detection latency, the abort
reason, the rollout kernel's launches and the chunk graphs captured,
taken from the cache and replayed (``graphs``). Last, on the card, one
clean monitored run at the default interval under ``torch.profiler``
(``profile_main.profile_call``): the host's launch calls (a graph launch
counts as 1) per replayed iteration, the captured graphs' node counts,
and the card's idle share over the monitor's search loop (its first
kernel to its last). ``--device cpu`` rehearses it on the CPU (no card,
no ``nvidia-smi``, no profiled run).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time


def run_once(argv):
    """One in-process run of ``python -m jepsen_tpu_torch`` with
    ``argv`` in a temporary store: its row (the run's own printing goes
    to standard error)."""
    from . import __main__ as demo_main
    from . import store
    from .checker import checkers, rollout, torch_wgl
    from .profile_main import graphs_since
    base = store.base_dir
    tmp = tempfile.mkdtemp(prefix="jepsen-monitor-ab-")
    store.base_dir = tmp
    rollout.launches = 0
    before = torch_wgl.chunk_graph.stats()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            try:
                demo_main.main(argv)
                code = 0
            except SystemExit as exc:
                code = exc.code
        wall = time.monotonic() - t0
        checkers.join_racers()
        test = store.latest()
    finally:
        store.base_dir = base
    shutil.rmtree(tmp, ignore_errors=True)
    r = test["results"]
    ops = [o for o in test["history"] if isinstance(o["process"], int)]
    span = (max(o["time"] for o in ops) - min(o["time"] for o in ops)) / 1e9
    row = {"exit": code, "wall_s": wall, "valid": r.get("valid"),
           "client_ops_per_s": sum(o["type"] != "invoke" for o in ops)
           / span, "abort_reason": r.get("abort-reason"),
           "rollout_launches": rollout.launches,
           "graphs": graphs_since(before)}
    mon = r.get("monitor")
    if isinstance(mon, dict):
        row.update(checks=mon["checks"], chunks=mon["chunks"],
                   time_to_first_verdict_s=mon["time_to_first_verdict_s"],
                   detection_latency_s=mon.get("detection_latency_s"),
                   monitor_verdict=mon["verdict"])
    return row


def main(argv=None):
    import torch

    from .checker import checkers
    ap = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.monitor_ab")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--intervals", default="0.005,5e-4,5e-5,5e-6",
                    help="switch intervals in seconds, comma-separated")
    ap.add_argument("--time-limit", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("monitor_ab: needs a CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip(), flush=True)
    intervals = [float(x) for x in args.intervals.split(",")]
    base = ["test", "--workload", "register", "--no-ssh", "--concurrency",
            "10n", "--per-key-limit", "200", "--time-limit",
            str(args.time_limit)] \
        + (["--device", "cpu"] if args.device == "cpu" else [])
    cases = {"clean": ["--monitor"],
             "dirty-read": ["--monitor", "--bug", "dirty-read",
                            "--monitor-chunk", "8"]}
    default = checkers.MONITOR_SWITCH_INTERVAL
    try:
        for turn in range(args.turns):
            print(json.dumps({"turn": turn, "case": "unmonitored",
                              **run_once(base)}), flush=True)
            order = intervals if turn % 2 == 0 else intervals[::-1]
            for interval in order:
                checkers.MONITOR_SWITCH_INTERVAL = interval
                for case, extra in cases.items():
                    print(json.dumps({"turn": turn, "case": case,
                                      "interval_s": interval,
                                      **run_once(base + extra)}),
                          flush=True)
        if args.device == "cuda":
            from .profile_main import profile_call, split
            row, wall, ev = profile_call(
                lambda: run_once(base + cases["clean"]), host_ops=False)
            st = split(ev, None)
            print(json.dumps({"case": "clean-profiled", **row,
                              "profiled_wall_s": wall, **{k: st[k] for k in (
                                  "host_launches", "graph_launches",
                                  "host_launches_per_replayed_iteration",
                                  "kernel_launches", "search_loop_s",
                                  "device_busy_s",
                                  "device_idle_share_in_search_loop")}}),
                  flush=True)
    finally:
        checkers.MONITOR_SWITCH_INTERVAL = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
