"""The competition's device racer against the flat device search, by the
interpreter's switch interval during the race.

``python -m jepsen_tpu_torch.race_ab`` (from the root of a checkout, on a
machine with one CUDA device) checks the cas-register main-path history
of ``chip_smoke.py`` (10k ops, 64 processes, crash_p 0.05, seeded with
``random.Random(45100)``) once flat with "jax-wgl" to warm up, then in
``--turns`` turns: flat once, and through the default gate
("competition") once per switch interval of ``--intervals``, in an order
that alternates between turns. Each competition check waits for every
racer (``checkers.join_racers``). It prints the card's ``nvidia-smi``
name and power limit, then one JSON line per check: the interval, the
check's wall, the winner, the device racer's wall and each racer's, and
the seconds the last racer took to exit after the verdict.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time


def main(argv=None):
    import torch

    from . import simulate
    from .checker import checkers
    ap = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.race_ab")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--intervals", default="0.005,5e-5,5e-6",
                    help="switch intervals in seconds, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("race_ab: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    intervals = [float(x) for x in args.intervals.split(",")]
    hist = simulate.random_history(random.Random(45100), "cas-register",
                                   64, 10_000, 0.05)
    flat = checkers.linearizable({"model": "cas-register",
                                  "algorithm": "jax-wgl"})
    flat.check({"searchplan?": False}, hist)                 # warm-up
    default = checkers.RACE_SWITCH_INTERVAL
    try:
        for turn in range(args.turns):
            t0 = time.monotonic()
            r = flat.check({"searchplan?": False}, hist)
            torch.cuda.synchronize()
            print(json.dumps({"turn": turn, "check": "flat",
                              "valid": r["valid"],
                              "wall_s": time.monotonic() - t0}), flush=True)
            order = intervals if turn % 2 == 0 else intervals[::-1]
            for interval in order:
                checkers.RACE_SWITCH_INTERVAL = interval
                t0 = time.monotonic()
                r = checkers.linearizable({"model": "cas-register"}).check(
                    {}, hist)
                wall = time.monotonic() - t0
                race = checkers.join_racers()[0]
                print(json.dumps({
                    "turn": turn, "check": "competition",
                    "switch_interval_s": interval, "valid": r["valid"],
                    "wall_s": wall, "winner": race["winner"],
                    "device_racer_wall_s":
                        race["racers"]["jax-wgl"]["wall_s"],
                    "exit_after_verdict_s": race["exit_after_verdict_s"],
                    "racers": race["racers"]}), flush=True)
    finally:
        checkers.RACE_SWITCH_INTERVAL = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
