"""Split the fold kernel's cycles by phase, and time it against an earlier
version of its source in turns, on one CUDA card.

    python -m jepsen_tpu_torch.checker.fold_ab
    git show 36a86ec:jepsen_tpu_torch/checker/csrc/fold.cu > build/fold_first.cu
    python -m jepsen_tpu_torch.checker.fold_ab build/fold_first.cu

(from the root of a checkout; ``build/`` is not committed). The fold is
``chip_smoke.py``'s lane batch of its streamlin phase (b): the first
``--keys`` cas-register keys of ``simulate.bench_histories``, whole
histories, folded as one batch of that many lanes at ``--rows`` rows, C
the largest open-op bucket among them. The kernel is held bit for bit
against ``fold_kernel.plain`` on it, then run once with its statistics
on (``fold_kernel.run``'s ``clocks``): the split of the longest lane's
cycles by phase (``fold_kernel.PHASES``) and its counts. An earlier
source, whose launcher is the one of the first fold kernel (sixteen
pointers, the layout, eight ints, the stream, no statistics), is built
as the package's own kernels are (``_build.library_of``), held against
the plain fold too, and timed with the current kernel with CUDA events
in turns -- earlier, current, current, earlier -- so that a drift of the
card's clock falls on both. The first kernel's scratch layout is
rebuilt here from its own parts (``first_plan``).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import _build, models, simulate
from . import fold_kernel, streamlin
from .rollout_ab import cuda_ms

#: the first fold kernel's per-lane scratch parts (its
#: ``fold_kernel.plan``), in the order of its ``JfLayout``
FIRST_PARTS = ("lin_alt", "st_alt", "seen", "work", "worklist", "ops",
               "key0", "val0", "key1", "val1", "efp")


class _FirstLayout(ctypes.Structure):
    _fields_ = [("lane_bytes", ctypes.c_longlong)] + [
        (n, ctypes.c_longlong) for n in FIRST_PARTS]


def first_plan(F, B, S, A, C):
    """The first fold kernel's layout: its parts' byte offsets, each
    16-byte aligned, and the lane's bytes."""
    P = F * (C + 1)
    sizes = (4 * F * B, 4 * F * S, F, F, 4 * F, 4 * C * (2 + 2 * A),
             4 * P, 4 * P, 4 * P, 4 * P, 16 * P)
    offs, off = [], 0
    for n in sizes:
        offs.append(off)
        off += (n + 15) // 16 * 16
    return off, offs


def earlier_kernel(src):
    """``fold_kernel.run``'s counterpart for the first fold kernel's
    launcher in ``src``."""
    fn = _build.library_of(src).jf_fold_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.POINTER(_FirstLayout)] \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(step, arrays, ev_kind, ev_slot, C):
        K, F, B = arrays["lin"].shape
        S, A = arrays["st"].shape[2], arrays["w_args"].shape[2]
        dev = arrays["lin"].device
        ev_kind = np.asarray(ev_kind, np.int32)
        ev_slot = np.asarray(ev_slot, np.int32)
        E = ev_kind.shape[1]
        n = 4 * (B + S)
        host = np.concatenate([
            fold_kernel.fingerprint_words(B + S).view(np.int32).ravel(),
            np.stack([ev_kind, ev_slot], 1).ravel()])
        up = torch.from_numpy(host).to(dev)
        lane_bytes, offs = first_plan(F, B, S, A, int(C))
        i32 = torch.int32
        out = (torch.empty((K, F, B), dtype=i32, device=dev),
               torch.empty((K, F, S), dtype=i32, device=dev),
               torch.empty((K, F), dtype=torch.bool, device=dev),
               torch.empty((K, B), dtype=i32, device=dev))
        res = torch.empty((K, 5), dtype=i32, device=dev)
        scratch = torch.empty(K * lane_bytes, dtype=torch.uint8, device=dev)
        err = fn(*(arrays[k].data_ptr() for k in (
            "lin", "st", "live", "open_w", "w_f", "w_args", "w_ret",
            "clear_w")), up.data_ptr(), up[n:].data_ptr(),
            *(x.data_ptr() for x in out), res.data_ptr(),
            scratch.data_ptr(), ctypes.byref(_FirstLayout(lane_bytes, *offs)),
            K, F, B, S, A, int(C), E, fold_kernel.MODEL_IDS[step],
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"earlier fold kernel: CUDA error {err}")
        return (*out, res[:, 0], res[:, 1], res[:, 2], res[:, 3], res[:, 4])
    return run


def batch_inputs(n_keys, F, dev):
    """The smoke's lane batch: ``n_keys`` bench keys' whole histories at
    F rows, one shape."""
    spec = models.cas_register_spec
    keys = simulate.bench_histories(n_keys)[0]
    jobs = [streamlin.history_job(spec, *spec.encode(h), F, dev)
            for h in keys]
    C = max(j.C for j in jobs)
    for j in jobs:
        j.C = C
    return streamlin.fold_inputs(jobs)


def same(got, want):
    """Every output array equal (dtype and values)."""
    return all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


def split(clocks):
    """The longest lane's statistics: its phases' shares of its cycles
    and its counts (``clocks``: a (K, STATS) host int64 array)."""
    cycles = clocks[:, :len(fold_kernel.PHASES)].sum(1)
    k = int(cycles.argmax())
    row = dict(zip(fold_kernel.STAT_NAMES, (int(x) for x in clocks[k])))
    total = int(cycles[k])
    return {"lane": k, "cycles": total,
            "shares": {p: row[p] / max(1, total)
                       for p in fold_kernel.PHASES},
            "counts": {n: row[n] for n in fold_kernel.STAT_NAMES
                       if n not in fold_kernel.PHASES}}


def stats(args, dev):
    """One run of the kernel with its statistics on: (outputs, the
    (K, STATS) statistics on the host)."""
    K = args[1]["lin"].shape[0]
    clocks = torch.zeros((K, fold_kernel.STATS), dtype=torch.int64,
                         device=dev)
    out = fold_kernel.run(*args, clocks=clocks)
    return out, clocks.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "jepsen_tpu_torch.checker.fold_ab")
    ap.add_argument("earlier", nargs="?",
                    help="an earlier fold.cu (the first kernel's launcher)")
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fold_ab: no CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    args = batch_inputs(a.keys, a.rows, dev)
    want = fold_kernel.plain(*args)
    got, clocks = stats(args, dev)
    if not same(got, want) or not same(fold_kernel.run(*args), want):
        raise SystemExit("fold_ab: the kernel differs from the plain fold")
    K, F, B = args[1]["lin"].shape
    shape = {"K": K, "F": F, "B": B, "S": args[1]["st"].shape[2],
             "C": int(args[4]), "E": int(args[2].shape[1])}
    print(json.dumps({"what": "split", "shape": shape,
                      "passes": want[6].tolist(), **split(clocks)}),
          flush=True)
    current = {"kernel_ms": cuda_ms(lambda: fold_kernel.run(*args), a.reps)}
    if a.earlier:
        earlier = earlier_kernel(a.earlier)
        if not same(earlier(*args), want):
            raise SystemExit("fold_ab: the earlier kernel differs from the "
                             "plain fold")
        turns = [cuda_ms(lambda: earlier(*args), a.reps),
                 cuda_ms(lambda: fold_kernel.run(*args), a.reps),
                 cuda_ms(lambda: fold_kernel.run(*args), a.reps),
                 cuda_ms(lambda: earlier(*args), a.reps)]
        current = {"earlier_ms": (turns[0] + turns[3]) / 2,
                   "kernel_ms": (turns[1] + turns[2]) / 2,
                   "turns_ms": turns}
    print(json.dumps({"what": "time", "shape": shape, "reps": a.reps,
                      **current}), flush=True)


if __name__ == "__main__":
    main()
