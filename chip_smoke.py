#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``jepsen_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and exits non-zero without one, printing no result. It
imports neither JAX nor the JAX package. Phases, one JSON line each:

1. ``env``: the card (``nvidia-smi`` name and power limit, also printed
   raw on a line of its own), torch and CUDA versions, and the time to
   build every kernel from ``jepsen_tpu_torch/checker/csrc``.
2. ``kernels``: each kernel against its plain PyTorch version on the
   card, on the ops of real encoded histories and seeds from their
   search; outputs must be bit-identical. Kernel and plain times come
   from CUDA events after warm-up; ``bound_ms`` is the least time the
   card could take for the same work (bytes over 3.35 TB/s, or integer
   operations over 67 T/s, whichever is larger).
3. ``main``: ``checkers.linearizable`` decides the 10k-op, 64-process
   cas-register and mutex histories on the card; both must be valid and
   the rollout kernel must have been launched. The same histories then
   run with ``rollout_kernel="scan"`` and must agree.
4. ``invalid``: six corrupted 220-op cas-register histories; the device
   verdict must equal the CPU oracle's and every invalid verdict must
   carry a witness op.

Then a ``{"kernels": [...]}`` line (with each kernel's launches in the
main phase) and, last, ``{"ok": true, "device": {...}}``. Any failure
raises and the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

# the port must stand without JAX: make any import of it fail loudly
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT_OPS_PER_S = 67e12         # H100 SXM 32-bit rate outside tensor cores
MAIN_HISTORIES = (("cas-register", 0.05), ("mutex", 0.02))
ROLLOUT_REPLACES = "jepsen_tpu/checker/pallas_rollout.py:179"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls,
    after one warm-up call, timed with CUDA events."""
    import torch
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


def search_seeds(spec, hist, dev, NS=8, iters=3):
    """Op columns of ``hist`` as the search sees them, and NS seed
    configurations from its search: the top of the stack after a few
    iterations without rollout. The last seed is marked dead so the
    dead-seed path runs too."""
    import torch
    from jepsen_tpu_torch.checker import torch_wgl as tw
    e, init_state = spec.encode(hist)
    kind, prep = tw._prepare_search(spec, e, init_state)
    assert kind == "search", f"{spec.name}: history decided by a fast path"
    (_, inv32, ret32, fop, args, rets, ok_words, init_state, n_pad, C, A,
     S) = prep
    B, W, O, T = tw._plan_sizes(n_pad, S, C)
    init_carry, _, run_chunk = tw._build_search(
        spec.step, 1, n_pad, B, S, C, A, W, O, T, R=0,
        rollout_kernel="scan", device=str(dev))
    consts = tw.make_consts(inv32, ret32, fop, args, rets, ok_words, dev)
    carry = run_chunk(init_carry(init_state[None]), consts, iters)
    top = int(carry[tw.IDX_TOP][0])
    pos = torch.tensor([(top - 1 - k) % O for k in range(NS)],
                       device=dev)
    seed_ok = torch.tensor([k < top for k in range(NS)], device=dev)
    seed_ok[-1] = False
    cols = tuple(x[0].contiguous() for x in consts[:5])
    return (carry[tw.IDX_BUF_LIN][pos].contiguous(),
            carry[tw.IDX_BUF_STATE][pos].contiguous(), seed_ok, cols,
            len(e))


def rollout_case(model, n_ops, crash_p, dev, R, reps):
    """Hold the rollout kernel against its plain version at one shape."""
    import torch
    from jepsen_tpu_torch import models, simulate
    from jepsen_tpu_torch.checker import rollout
    spec = models.model_spec(model)
    hist = simulate.random_history(random.Random(45100), model, 64, n_ops,
                                   crash_p)
    seed_lin, seed_st, seed_ok, cols, n_enc = search_seeds(spec, hist, dev)
    args = (spec.step, seed_lin, seed_st, seed_ok, *cols, R)
    j_k, st_k = rollout.run(*args)
    j_p, st_p = rollout.plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(j_k, j_p) and torch.equal(st_k, st_p)):
        bad = int((j_k != j_p).sum())
        raise AssertionError(f"rollout kernel disagrees with its plain "
                             f"version ({model}, n={cols[0].shape[0]}): "
                             f"{bad} of {j_k.numel()} steps differ")
    err = max(int((j_k - j_p).abs().max()), int((st_k - st_p).abs().max()))
    kernel_ms = cuda_ms(lambda: rollout.run(*args), reps)
    plain_ms = cuda_ms(lambda: rollout.plain(*args), 1)
    NS, B = seed_lin.shape
    n = cols[0].shape[0]
    S = seed_st.shape[1]
    A = cols[3].shape[1]
    # bytes each input read once and each output written once; the work
    # is what this run's chains did: one dozen-op pass over the n ops
    # for every step a chain entered alive
    nbytes = n * (3 + 2 * A) * 4 + NS * (B + S) * 4 + NS \
        + NS * R * (1 + S) * 4
    live = int((j_k >= 0).sum()) + int(
        (seed_ok & (j_k < 0).any(dim=1)).sum())
    ops = 12 * n * live
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    return {"name": "rollout", "replaces": ROLLOUT_REPLACES,
            "library_ms": None, "model": model, "history_ops": n_ops,
            "encoded_ops": n_enc,
            "shape": {"NS": NS, "R": R, "n": n, "S": S, "A": A},
            "live_steps": live, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err, "parity": "exact"}


def main_case(model, crash_p, kernel, n_ops=10_000):
    """One main-path check of an ``n_ops``-op, 64-process history."""
    import torch
    from jepsen_tpu_torch import simulate
    from jepsen_tpu_torch.checker import checkers
    hist = simulate.random_history(random.Random(45100), model, 64, n_ops,
                                   crash_p)
    opts = {} if kernel else {"rollout_kernel": "scan"}
    chk = checkers.linearizable({"model": model, "algorithm": "jax-wgl",
                                 "engine_opts": opts})
    t0 = time.monotonic()
    r = chk.check({}, hist)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_ops = sum(1 for o in hist if o["type"] == "invoke")
    return r, {"model": model, "rollout": "kernel" if kernel else "scan",
               "valid": r["valid"], "wall_s": wall,
               "iterations": r.get("iterations"),
               "configs_explored": r.get("configs_explored"),
               "history_ops": n_ops, "ops_per_s": n_ops / wall,
               "table_load": r.get("table_load")}


def invalid_trials(dev):
    """Six 220-op cas-register histories, the odd ones corrupted with
    reads kept in range so the search, not a fast path, decides (as
    tests/test_jax_wgl.py's rollout trials are made): device verdict ==
    CPU oracle, and at least one is invalid."""
    from jepsen_tpu_torch import models, simulate
    from jepsen_tpu_torch.checker import torch_wgl, wgl
    spec = models.cas_register_spec
    rng = random.Random(45100)
    rows = []
    for trial in range(6):
        hist = simulate.random_history(rng, "cas-register", 6, 220, 0.05)
        if trial % 2:
            hist = simulate.corrupt(rng, hist)
            for o in hist:
                if o["type"] == "ok" and o["f"] == "read" \
                        and isinstance(o.get("value"), int):
                    o["value"] = o["value"] % 4
        e, st = spec.encode(hist)
        got = torch_wgl.check_encoded(spec, e, st, device=dev)
        want = wgl.check_encoded(spec, e, st)
        if got["valid"] != want["valid"]:
            raise AssertionError(f"invalid trial {trial}: device "
                                 f"{got['valid']} != oracle {want['valid']}")
        if got["valid"] is False and "op" not in got:
            raise AssertionError(f"invalid trial {trial}: no witness op")
        rows.append({"trial": trial, "valid": got["valid"],
                     "engine": got.get("engine"),
                     "iterations": got.get("iterations"),
                     "witness_op": got.get("op", {}).get("index")})
    if not any(r["valid"] is False for r in rows):
        raise AssertionError("no invalid trial: the phase checked nothing")
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test needs one "
              "card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import jepsen_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke.py: jepsen_tpu_torch not found beside this "
              f"script ({exc}); run it from a checkout", file=sys.stderr)
        return 2
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.checker import rollout
    dev = torch.device("cuda")

    # -- 1. env ------------------------------------------------------------
    smi = nvidia_smi()
    build = _build.build_all()
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build})

    # -- 2. kernels against their plain versions ---------------------------
    t0 = time.monotonic()
    # the main-path shape (NS=8, R=1024, n=8192) for each kernel model
    # (7.5k register ops encode to 7.5k rows, 10k cas/mutex ops to fewer)
    cases = [rollout_case(m, k, p, dev, 1024, 10)
             for m, k, p in (("register", 7_500, 0.05),
                             ("cas-register", 10_000, 0.05),
                             ("mutex", 10_000, 0.02))]
    cases.append(rollout_case("cas-register", 100_000, 0.05, dev, 1024, 3))
    emit({"phase": "kernels", "seconds": time.monotonic() - t0,
          "kernels": cases})

    # -- 3. the main path --------------------------------------------------
    rollout.launches = 0
    main_rows = []
    for model, crash_p in MAIN_HISTORIES:
        r, row = main_case(model, crash_p, kernel=True)
        if r["valid"] is not True:
            raise AssertionError(f"main path: {model} history decided "
                                 f"{r['valid']!r}, expected True")
        main_rows.append(row)
    main_launches = rollout.launches
    if main_launches <= 0:
        raise AssertionError("main path never launched the rollout kernel")
    for model, crash_p in MAIN_HISTORIES:
        r, row = main_case(model, crash_p, kernel=False)
        if r["valid"] is not True:
            raise AssertionError(f"scan path: {model} history decided "
                                 f"{r['valid']!r}, expected True")
        main_rows.append(row)
    emit({"phase": "main", "rollout_launches": main_launches,
          "checks": main_rows})

    # -- 4. invalid histories against the CPU oracle -----------------------
    emit({"phase": "invalid", "trials": invalid_trials(dev)})

    main_shape = cases[1]
    emit({"kernels": [{
        "name": "rollout", "route": "cuda",
        "source": "jepsen_tpu_torch/checker/csrc/rollout.cu",
        "replaces": ROLLOUT_REPLACES,
        "launches": main_launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_shape["kernel_ms"], "kernel_ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "shape": main_shape["shape"], "parity": "exact",
        "shapes": cases}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
