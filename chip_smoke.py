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
   search (the main-path shapes of ``rollout_cases.MAIN_SHAPES``), then
   on the adversarial cases of
   ``jepsen_tpu_torch/checker/rollout_cases.py`` under every launch
   plan the kernel has (op columns staged in shared memory or not,
   chain state in shared or global memory); outputs must be
   bit-identical. Kernel and plain times come from CUDA events after
   warm-up; each adversarial case's kernel is timed under the default
   plan. ``bound_ms`` is the least time the card could take for the
   work these inputs need (bytes over 3.35 TB/s, or integer operations
   over 67 T/s, whichever is larger), counted as ``bound`` says;
   ``bound_ms_sweep`` is the first port's count (a full n-op pass per
   live step) on the same inputs. ``latency_floor_ms`` is the longest
   chain's live steps times ``step_ns``, the dependent latency of the
   kernel's common step alone, measured in this run
   (``jt_step_probe``).
3. ``main``: ``checkers.linearizable`` decides the 10k-op, 64-process
   cas-register and mutex histories on the card; both must be valid and
   the rollout kernel must have been launched. The same histories then
   run with ``rollout_kernel="scan"`` and must agree.
4. ``invalid``: six corrupted 220-op cas-register histories; the device
   verdict must equal the CPU oracle's and every invalid verdict must
   carry a witness op.
5. ``batch``: the JAX package's headline key batch at full width
   (``simulate.bench_histories``, as ``bench.py`` rungs 2 and 2b draw
   it): 256 cas-register keys, 8 processes, 200 ops per key, crash_p
   0.02, every 8th key corrupted, through
   ``parallel.check_batch_encoded`` on the card: one call under
   ``torch.profiler``, which also warms up (kernel launches per
   iteration, device idle share; ``profile_main.profile_batch``), then
   one timed call (wall, ops/s, iterations, compactions, invalid keys).
   Both calls must decide alike. No key may be
   unknown, at least one must be invalid, and the first 32 verdicts must
   equal the CPU oracle's (``wgl.check_encoded``, 2M configs).
6. ``independent``: the first 64 of those keys wrapped in
   ``independent.tuple_`` and merged into one history, through
   ``independent.checker(compose({"linearizable": ..., "ok":
   unbridled_optimism()}))``: exactly one call of
   ``parallel.check_batch_encoded``, with 64 pairs, and ``failures``
   equal to the corrupted keys.
7. ``queues``: a 64-key fifo-queue batch and a 64-key unordered-queue
   batch (150 ops and 6 processes per key, crash_p 0.02, every 8th key
   corrupted) with the fast check off, so the device search with padded
   queue states decides, within ``QUEUE_MAX_CONFIGS`` (256 iterations
   at the batch's 64 lanes x 64 keys). The CPU oracle for queues is the
   model's exact polynomial decision (the aspect fast check, which the
   batch was denied), and, for every key the sequential WGL oracle
   decides within 5,000 configurations, that oracle too. Every decided
   verdict must equal the oracles', every valid key must be decided, and
   a key may come back unknown only if the oracle finds it invalid: the
   proof that a corrupted 150-op FIFO key has no linearization is an
   exhaustive search, which for some keys outlasts any budget (the JAX
   engine does not finish it for some of these keys either). Then
   ``bench.py``'s rung-4 FIFO history through
   ``checkers.linearizable``, fast check on.

The batch, independent and queue paths run the search's scan rollout
(the batch pins it, as the JAX package's does): each of them is run
with the rollout kernel's launch count set to 0 and must leave it at 0.
Then a ``{"kernels": [...]}`` line (with each kernel's launches in the
main phase, and on every path) and, last, ``{"ok": true, "device":
{...}}``. Any failure raises and the script exits non-zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
#: integer operations to test one op at a rollout step: the bit test, the
#: invoke < rm compare, the model step (field loads, compares, selects)
#: and the first-success select
OPS_PER_OP = 12
MAIN_HISTORIES = (("cas-register", 0.05), ("mutex", 0.02))
QUEUES = ("fifo-queue", "unordered-queue")
#: the batch phases' sizes: keys of the headline batch, of the
#: independent history, and per queue batch, with each queue key's ops
BATCH_KEYS, INDEPENDENT_KEYS, QUEUE_KEYS, QUEUE_OPS = 256, 64, 64, 150
#: every batch here corrupts the history of one key in this many
CORRUPT_EVERY = 8
#: the queue batches' search budget: 256 iterations at 64 lanes x 64 keys
QUEUE_MAX_CONFIGS = 256 * 64 * 64
ROLLOUT_REPLACES = "jepsen_tpu/checker/pallas_rollout.py:179"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def step_ns(steps=1 << 18):
    """Nanoseconds of one common rollout step alone: ``jt_step_probe``
    (csrc/rollout.cu) rolls one warp ``steps`` steps with its frontier
    word in registers, timed with CUDA events after a warm-up launch."""
    import torch
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.checker.rollout_ab import cuda_ms
    fn = _build.library("rollout").jt_step_probe_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(1, 1, steps, out.data_ptr(), stream):   # cas-register writes
            raise RuntimeError("step probe failed to launch")
    return cuda_ms(launch, 3) * 1e6 / steps


def bound(seed_lin, seed_ok, j, n, A, S, step):
    """The least time for a rollout with outputs ``j`` on these inputs.
    Bytes: each input read once, each output written once. Operations:
    OPS_PER_OP for every op a step must look at, from the chain's
    frontier word to the op taken (to n for the step that wedges), which
    is what these inputs need (``rollout_cases.work``). The earlier count
    (``bound_ms_sweep``) charged a full n-op pass per live step, as the
    first port's kernel did; both are returned, with the latency floor:
    the longest chain's live steps times ``step`` ns (``step_ns``)."""
    import numpy as np
    from jepsen_tpu_torch.checker import rollout_cases
    NS, B = seed_lin.shape
    R = j.shape[1]
    w = rollout_cases.work(seed_lin.cpu().numpy().view(np.uint32),
                           seed_ok.cpu().numpy(), j.cpu().numpy(), n)
    nbytes = n * (3 + 2 * A) * 4 + NS * (B + S) * 4 + NS \
        + NS * R * (1 + S) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_OP * w["scanned"] / INT_OPS_PER_S * 1e3
    old_ms = OPS_PER_OP * n * w["live"] / INT_OPS_PER_S * 1e3
    return {"live_steps": w["live"], "live_max": w["live_max"],
            "scanned_ops": w["scanned"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_sweep": max(bytes_ms, old_ms),
            "bound_by_sweep": "bytes" if bytes_ms >= old_ms else "operations",
            "latency_floor_ms": w["live_max"] * step * 1e-6}


def same(name, got, want):
    import torch
    j_k, st_k = got
    j_p, st_p = want
    torch.cuda.synchronize()
    if not (torch.equal(j_k, j_p) and torch.equal(st_k, st_p)):
        bad = int((j_k != j_p).sum())
        raise AssertionError(f"rollout kernel disagrees with its plain "
                             f"version ({name}): {bad} of {j_k.numel()} "
                             f"steps differ")
    return max(int((j_k - j_p).abs().max()), int((st_k - st_p).abs().max()))


def rollout_case(model, n_ops, crash_p, dev, R, reps, step):
    """Hold the rollout kernel against its plain version at one
    main-path shape, and time both."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checker import rollout, rollout_cases
    from jepsen_tpu_torch.checker.rollout_ab import cuda_ms
    spec = models.model_spec(model)
    xs, n_enc = rollout_cases.main_path(model, n_ops, crash_p, dev)
    args = (spec.step, *xs, R)
    want = rollout.plain(*args)
    j_k, _ = got = rollout.run(*args)
    seed_lin, seed_st, seed_ok = xs[:3]
    NS, B = seed_lin.shape
    n, A = xs[6].shape
    S = seed_st.shape[1]
    return {"name": "rollout", "replaces": ROLLOUT_REPLACES,
            "library_ms": None, "model": model, "history_ops": n_ops,
            "encoded_ops": n_enc,
            "shape": {"NS": NS, "R": R, "n": n, "S": S, "A": A},
            "plan": rollout.plan(NS, n, B)._asdict(),
            **bound(seed_lin, seed_ok, j_k, n, A, S, step),
            "max_abs_err": same(f"{model}, n={n}", got, want),
            "parity": "exact",
            "kernel_ms": cuda_ms(lambda: rollout.run(*args), reps),
            "plain_ms": cuda_ms(lambda: rollout.plain(*args), 1)}


def adversarial_cases(dev, step, R=1024):
    """The adversarial cases, at R = 1024, each held bit for bit against
    the plain version under every launch plan: the default, every op
    column read through L1/L2, and chain state in global scratch (the
    last two forced by a smaller shared-memory budget); then timed under
    the default plan."""
    from jepsen_tpu_torch.checker import rollout, rollout_cases
    from jepsen_tpu_torch.checker.rollout_ab import cuda_ms
    rows = []
    budget = rollout.SMEM_BUDGET
    for case in rollout_cases.adversarial():
        xs = case.tensors(dev)
        args = (case.step, *xs, R)
        want = rollout.plain(*args)
        NS, B = case.seed_lin.shape
        n = len(case.invoke)
        sb = rollout.state_bytes(B)
        plans = []
        err = 0
        for label, smem in (("default", budget),
                            ("columns via L2", 24 * n + sb),
                            ("state in global", sb - 16)):
            rollout.SMEM_BUDGET = min(smem, budget)
            try:
                p, got = rollout.plan(NS, n, B), rollout.run(*args)
                err = max(err, same(f"{case.name}, {label}", got, want))
            finally:
                rollout.SMEM_BUDGET = budget
            plans.append({"plan": label, **p._asdict()})
        rows.append({"case": case.name, "model": case.model, "NS": NS,
                     "n": n, "R": R, "plans": plans, "max_abs_err": err,
                     "kernel_ms": cuda_ms(lambda: rollout.run(*args), 5),
                     **bound(xs[0], xs[2], want[0], n, case.args.shape[1],
                             1, step)})
    return rows


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


def scan_only(what):
    """Fail unless the path just run left the rollout kernel's launch
    count at 0 (set to 0 just before it): the batch rolls on the scan."""
    from jepsen_tpu_torch.checker import rollout
    if rollout.launches != 0:
        raise AssertionError(f"{what}: the rollout kernel was launched "
                             f"{rollout.launches} times on the batch path")
    return rollout.launches


def batch_phase():
    """The 256-key headline batch: a profiled call (the warm-up), then a
    timed call; the first 32 verdicts against the CPU oracle."""
    import torch
    from jepsen_tpu_torch import models, parallel, simulate
    from jepsen_tpu_torch.checker import rollout, wgl
    from jepsen_tpu_torch.profile_main import profile_batch
    spec = models.cas_register_spec
    keys, fifo = simulate.bench_histories(BATCH_KEYS)
    pairs = [spec.encode(h) for h in keys]
    n_ops = sum(len(e) for e, _ in pairs)
    prof = profile_batch(spec, pairs)                   # warms up too
    torch.cuda.synchronize()
    rollout.launches = 0
    t0 = time.monotonic()
    res = parallel.check_batch_encoded(spec, pairs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = scan_only("batch")
    unknown = [k for k, r in enumerate(res) if r["valid"] not in (True,
                                                                 False)]
    if unknown:
        raise AssertionError(f"batch: keys {unknown} undecided")
    invalid = [k for k, r in enumerate(res) if r["valid"] is False]
    if not invalid:
        raise AssertionError("batch: no invalid key: the phase checked "
                             "nothing")
    if prof["unknown_keys"] or prof["invalid_keys"] != len(invalid):
        raise AssertionError(f"batch: the profiled call decided "
                             f"differently: {prof['invalid_keys']} invalid, "
                             f"{prof['unknown_keys']} unknown")
    t0 = time.monotonic()
    for k, (e, st) in enumerate(pairs[:32]):
        want = wgl.check_encoded(spec, e, st, max_configs=2_000_000)
        if res[k]["valid"] != want["valid"]:
            raise AssertionError(f"batch key {k}: device {res[k]['valid']}"
                                 f" != oracle {want['valid']}")
    oracle_s = time.monotonic() - t0
    searched = [r for r in res if r.get("engine") == "jax-wgl"]
    row = {"phase": "batch", "model": "cas-register", "keys": len(pairs),
           "history_ops": n_ops, "wall_s": wall, "ops_per_s": n_ops / wall,
           "iterations": max(r.get("iterations") or 0 for r in res),
           "compactions": max(r.get("compactions") or 0 for r in res),
           "keys_searched": len(searched),
           "keys_decided_on_host": len(res) - len(searched),
           "invalid_keys": len(invalid), "rollout_launches": launches,
           "oracle_keys": 32, "oracle_s": oracle_s,
           "profiled": {k: v for k, v in prof.items()
                        if k != "top_kernels"},
           "top_kernels": prof["top_kernels"][:5]}
    return row, keys, fifo


def keyed_history(hists):
    """One history of many keys: each key's ops wrapped in
    ``independent.tuple_``, with processes disjoint across keys."""
    from jepsen_tpu_torch import independent
    out = []
    for k, hist in enumerate(hists):
        for o in hist:
            o = dict(o)
            o["process"] = o["process"] + 1000 * k
            o["value"] = independent.tuple_(k, o.get("value"))
            o["index"] = len(out)
            out.append(o)
    return out


def independent_phase(keys):
    """64 keys through ``independent.checker``: one batched call."""
    from jepsen_tpu_torch import independent, parallel
    from jepsen_tpu_torch.checker import checkers, core, rollout
    hist = keyed_history(keys)
    calls = []
    real = parallel.check_batch_encoded

    def counting(spec, pairs, **kw):
        calls.append(len(pairs))
        return real(spec, pairs, **kw)

    chk = independent.checker(core.compose({
        "linearizable": checkers.linearizable({"model": "cas-register"}),
        "ok": core.unbridled_optimism()}))
    parallel.check_batch_encoded = counting
    rollout.launches = 0
    try:
        t0 = time.monotonic()
        r = core.check(chk, {}, hist)
        wall = time.monotonic() - t0
    finally:
        parallel.check_batch_encoded = real
    launches = scan_only("independent")
    corrupted = [k for k in range(len(keys))
                 if k % CORRUPT_EVERY == CORRUPT_EVERY - 1]
    if calls != [len(keys)]:
        raise AssertionError(f"independent: batched calls {calls}, "
                             f"expected one of {len(keys)} pairs")
    if sorted(r["failures"]) != corrupted or r["valid"] is not False:
        raise AssertionError(f"independent: failures {r['failures']} "
                             f"(valid {r['valid']}), expected the "
                             f"corrupted keys {corrupted}")
    return {"phase": "independent", "keys": len(keys), "events": len(hist),
            "batched_calls": calls, "wall_s": wall,
            "failures": r["failures"], "rollout_launches": launches}


def queue_oracle(spec, e, st):
    """The CPU verdicts for a queue key: the model's exact polynomial
    decision (its fast check; the sequential WGL oracle, 2M configs,
    where that declines), and the sequential WGL oracle within 5,000
    configurations (None where it does not decide in them)."""
    from jepsen_tpu_torch.checker import torch_wgl, wgl
    inv32, ret32, _ = torch_wgl._encode_arrays(e)
    fast = spec.fast_check(e, inv32, ret32)
    exact = (fast if fast is True else fast[0]) if fast is not None \
        else wgl.check_encoded(spec, e, st, max_configs=2_000_000)["valid"]
    bounded = wgl.check_encoded(spec, e, st, max_configs=5_000)["valid"]
    return exact, (bounded if bounded in (True, False) else None)


def queue_phase(fifo):
    """64-key fifo-queue and unordered-queue batches with the fast check
    off, against the CPU oracles; then rung 4's FIFO history through
    ``checkers.linearizable``."""
    import torch
    from jepsen_tpu_torch import models, parallel, simulate
    from jepsen_tpu_torch.checker import checkers, rollout
    rows = []
    for name in QUEUES:
        spec = models.model_spec(name)
        search = dataclasses.replace(spec, fast_check=None)
        rng = random.Random(45100)
        hists = []
        for k in range(QUEUE_KEYS):
            hist = simulate.random_history(rng, name, 6, QUEUE_OPS, 0.02)
            hists.append(simulate.corrupt(rng, hist)
                         if k % CORRUPT_EVERY == CORRUPT_EVERY - 1 else hist)
        pairs = [search.encode(h) for h in hists]
        rollout.launches = 0
        t0 = time.monotonic()
        res = parallel.check_batch_encoded(search, pairs,
                                           max_configs=QUEUE_MAX_CONFIGS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = scan_only(name)
        t0 = time.monotonic()
        bounded_n = 0
        undecided = []
        for k, (e, st) in enumerate(pairs):
            exact, bounded = queue_oracle(spec, e, st)
            got = res[k]["valid"]
            if got == "unknown" and exact is False:
                undecided.append(k)     # an exhaustion proof out of budget
            elif got != exact or (bounded is not None and got != bounded):
                raise AssertionError(f"{name} key {k}: device {got!r}, "
                                     f"oracle {exact!r} / {bounded!r}")
            if got is False and "op" not in res[k]:
                raise AssertionError(f"{name} key {k}: no witness op")
            bounded_n += bounded is not None
        if not any(r["valid"] is False for r in res):
            raise AssertionError(f"{name}: no key decided invalid: the "
                                 f"phase checked nothing")
        rows.append({"model": name, "keys": len(pairs),
                     "history_ops": sum(len(e) for e, _ in pairs),
                     "wall_s": wall,
                     "iterations": max(r.get("iterations") or 0
                                       for r in res),
                     "compactions": max(r.get("compactions") or 0
                                        for r in res),
                     "invalid_keys": sum(r["valid"] is False for r in res),
                     "undecided_invalid_keys": undecided,
                     "max_configs": QUEUE_MAX_CONFIGS,
                     "wgl_oracle_decided": bounded_n,
                     "oracle_s": time.monotonic() - t0,
                     "rollout_launches": launches})
    spec = models.fifo_queue_spec
    t0 = time.monotonic()
    r = checkers.linearizable({"model": "fifo-queue"}).check({}, fifo)
    wall = time.monotonic() - t0
    exact, bounded = queue_oracle(spec, *spec.encode(fifo))
    if r["valid"] != exact or (bounded is not None and r["valid"] != bounded):
        raise AssertionError(f"rung-4 fifo history: {r['valid']!r}, oracle "
                             f"{exact!r} / {bounded!r}")
    rows.append({"model": "fifo-queue", "check": "linearizable, fast check "
                 "on", "history_ops": sum(1 for o in fifo
                                          if o["type"] == "invoke"),
                 "valid": r["valid"], "engine": r.get("engine"),
                 "wall_s": wall})
    return {"phase": "queues", "checks": rows}


def main(argv):
    import torch
    if argv:
        print("usage: chip_smoke.py (no arguments)", file=sys.stderr)
        return 2
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
    from jepsen_tpu_torch.checker import rollout, rollout_cases
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
    step = step_ns()
    cases = [rollout_case(m, k, p, dev, 1024, 10 if k <= 10_000 else 3, step)
             for m, k, p in rollout_cases.MAIN_SHAPES]
    adversarial = adversarial_cases(dev, step)
    emit({"phase": "kernels", "seconds": time.monotonic() - t0,
          "step_ns": step, "kernels": cases, "adversarial": adversarial})

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

    # -- 5-7. the key batch, independent, the queue models -----------------
    row, keys, fifo = batch_phase()
    emit(row)
    ind = independent_phase(keys[:INDEPENDENT_KEYS])
    emit(ind)
    queues = queue_phase(fifo)
    emit(queues)
    by_path = {"main": main_launches, "batch": row["rollout_launches"],
               "independent": ind["rollout_launches"],
               **{c["model"]: c["rollout_launches"]
                  for c in queues["checks"] if "rollout_launches" in c}}

    main_shape = cases[1]
    emit({"kernels": [{
        "name": "rollout", "route": "cuda",
        "source": "jepsen_tpu_torch/checker/csrc/rollout.cu",
        "replaces": ROLLOUT_REPLACES,
        "launches": main_launches, "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases + adversarial),
        "ms": main_shape["kernel_ms"], "kernel_ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "bound_ms_sweep": main_shape["bound_ms_sweep"],
        "latency_floor_ms": main_shape["latency_floor_ms"],
        "step_ns": step,
        "shape": main_shape["shape"], "parity": "exact",
        "adversarial_cases": len(adversarial),
        "adversarial_max_abs_err": max(a["max_abs_err"]
                                       for a in adversarial),
        "shapes": cases}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
