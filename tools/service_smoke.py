"""Run ``chip_smoke.py``'s ``service`` phase alone (optionally with its
``fleet`` phase after it): ``/api/check`` tenants solo and coalesced,
the txn and fold lanes, ``python -m jepsen_tpu_torch serve`` in a
subprocess, and the admission burst.

It builds the kernels first, as the smoke does, and decides the CPU
oracle of the batch keys the phase posts (the sequential WGL search in
worker processes). Prints the card's name and power limit
(``nvidia-smi``), then the phase rows as JSON. On a machine without a
card, ``--device cpu`` rehearses the phase (slowly: the fold lane's
streams are the 200-op batch keys at the hard frontier cap).

Usage::

    python tools/service_smoke.py [--device cpu] [--fleet]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tools/service_smoke.py")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--fleet", action="store_true",
                   help="also run the fleet phase after the service's")
    ns = p.parse_args(argv)
    import torch

    import chip_smoke
    from jepsen_tpu_torch import simulate
    if ns.device == "cuda":
        if not torch.cuda.is_available():
            print("service_smoke: no CUDA device (pass --device cpu to "
                  "rehearse)", file=sys.stderr)
            return 2
        from jepsen_tpu_torch import _build
        print(chip_smoke.nvidia_smi(), flush=True)
        print(json.dumps({"build_s": _build.build_all()}), flush=True)
    dev = torch.device(ns.device)
    n = max(chip_smoke.SERVICE_TENANTS * chip_smoke.SERVICE_KEYS_PER,
            chip_smoke.SERVICE_STREAMS, chip_smoke.SERVICE_BURST)
    keys, _fifo = simulate.bench_histories(n)
    t0 = time.monotonic()
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 4,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        oracle = list(pool.map(chip_smoke.oracle_verdict, keys))
    print(json.dumps({"oracle_keys": n,
                      "oracle_s": time.monotonic() - t0}), flush=True)
    row = chip_smoke.service_phase(dev, keys, oracle)
    print(json.dumps(row, default=str), flush=True)
    if ns.fleet:
        row = chip_smoke.fleet_phase(dev)
        print(json.dumps(row, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
