"""Time the rollout kernel against an earlier version of its source, in
turns, on one CUDA card.

    git show e82efea:jepsen_tpu_torch/checker/csrc/rollout.cu \\
        > build/rollout_first_port.cu
    python -m jepsen_tpu_torch.checker.rollout_ab build/rollout_first_port.cu

(from the root of a checkout; ``build/`` is not committed). The earlier
source is the first port's ``rollout.cu``, whose launcher takes ten
pointers, six ints (NS, R, n, B, A, model) and the stream; it is built as
the package's own kernels are (``_build.library_of``). At every
main-path shape (``rollout_cases.MAIN_SHAPES``) and on the worst case of
the search past the frontier word (the ``failing-tail`` case), both
kernels are held bit for bit against the plain version, then timed with
CUDA events in turns -- earlier, current, current, earlier -- so that a
drift of the card's clock falls on both. Prints the card's ``nvidia-smi``
name and power limit, then one JSON line per shape: ``earlier_ms`` and
``kernel_ms`` (the mean of each kernel's two turns) and ``turns_ms``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from .. import _build, models
from . import rollout, rollout_cases


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls,
    after one warm-up call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def earlier_kernel(src):
    """``run``'s counterpart for the first port's launcher in ``src``."""
    fn = _build.library_of(src).jt_rollout_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(step_fn, seed_lin, seed_st, seed_ok, invoke, ret, fop, args,
            rets, R):
        NS, B = seed_lin.shape
        n, A = args.shape
        dev = seed_lin.device
        j = torch.empty((NS, R), dtype=torch.int32, device=dev)
        st = torch.empty((NS, R, 1), dtype=torch.int32, device=dev)
        err = fn(seed_lin.data_ptr(), seed_st.data_ptr(), seed_ok.data_ptr(),
                 invoke.data_ptr(), ret.data_ptr(), fop.data_ptr(),
                 args.data_ptr(), rets.data_ptr(), j.data_ptr(),
                 st.data_ptr(), NS, R, n, B, A, rollout.MODEL_IDS[step_fn],
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"earlier rollout kernel: CUDA error {err}")
        return j, st
    return run


def compare(earlier, name, step_fn, xs, R, reps):
    """Both kernels against the plain version on ``xs``, then timed in
    turns; raises if either disagrees."""
    args = (step_fn, *xs, R)
    want = rollout.plain(*args)
    for label, run in (("earlier", earlier), ("current", rollout.run)):
        j, st = run(*args)
        torch.cuda.synchronize()
        if not (torch.equal(j, want[0]) and torch.equal(st, want[1])):
            raise AssertionError(f"{label} rollout kernel disagrees with "
                                 f"the plain version ({name})")
    t = [cuda_ms(lambda: earlier(*args), reps),
         cuda_ms(lambda: rollout.run(*args), reps),
         cuda_ms(lambda: rollout.run(*args), reps),
         cuda_ms(lambda: earlier(*args), reps)]
    NS, B = xs[0].shape
    return {"shape": name, "NS": NS, "R": R, "n": 32 * B,
            "earlier_ms": (t[0] + t[3]) / 2, "kernel_ms": (t[1] + t[2]) / 2,
            "turns_ms": t, "parity": "exact"}


def main(argv):
    if len(argv) != 1:
        print("usage: python -m jepsen_tpu_torch.checker.rollout_ab "
              "EARLIER_ROLLOUT_CU", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("rollout_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    earlier = earlier_kernel(argv[0])
    for model, n_ops, crash_p in rollout_cases.MAIN_SHAPES:
        xs, _ = rollout_cases.main_path(model, n_ops, crash_p, dev)
        n = xs[3].shape[0]
        print(json.dumps(compare(earlier, f"{model}, n={n}",
                                 models.model_spec(model).step,
                                 xs, 1024, 10 if n <= 8192 else 3)),
              flush=True)
    case = {c.name: c for c in rollout_cases.adversarial()}["failing-tail"]
    print(json.dumps(compare(earlier, "failing-tail", case.step,
                             case.tensors(dev), 1024, 10)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
