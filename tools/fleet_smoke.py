"""Run ``chip_smoke.py``'s ``fleet`` phase alone: campaign (a)'s matrix
with every cell in a fleet worker process (``--workers local,local
--backends gpu,cpu``), then the same cells with one seeded worker kill.

It builds the kernels first, as the smoke does, so the worker processes
load the rollout library instead of each starting its own nvcc. Prints
the card's name and power limit (``nvidia-smi``), then the phase's JSON
row. On a machine without a card, ``--device cpu`` rehearses the phase
on the cpu tier (the gpu probe fails there).

Usage::

    python tools/fleet_smoke.py [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tools/fleet_smoke.py")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ns = p.parse_args(argv)
    import torch

    import chip_smoke
    if ns.device == "cuda":
        if not torch.cuda.is_available():
            print("fleet_smoke: no CUDA device (pass --device cpu to "
                  "rehearse)", file=sys.stderr)
            return 2
        from jepsen_tpu_torch import _build
        print(chip_smoke.nvidia_smi(), flush=True)
        print(json.dumps({"build_s": _build.build_all()}), flush=True)
    row = chip_smoke.fleet_phase(torch.device(ns.device))
    print(json.dumps(row, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
