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
5. ``gate``: the linearizable gate at the JAX package's defaults. (a)
   The two main-path histories through ``core.check`` with
   ``checkers.linearizable({"model": m})``, whose default is now
   "competition": both decide valid; the winner, each racer's wall and
   verdict (the device racer's launches of the rollout kernel, which
   must be more than 0), the seconds the last racer took to exit after
   the verdict (every racer is waited for before the counts are read),
   beside the flat "jax-wgl" wall of phase 3. (b) The first 64 keys of
   the batch below through ``independent.checker(linearizable(
   {"algorithm": "jax-wgl"}))`` once planned and once with
   ``searchplan?`` off, each one batched call: verdicts equal key for
   key and equal to the CPU oracle (``wgl``, 2M configs, in worker
   processes beside the card's runs); the port's planner must split the
   keys into ``GATE_SEGMENTS``, the JAX planner's counts; one segmented
   key through ``Linearizable`` directly; the planned and unplanned
   batches' walls, and one profiled iteration of each. (c) The
   cas-register main-path history with ``checkpoint=``, stopped by
   ``max_configs`` after ``CKPT_ITERS`` iterations and resumed: verdict
   and iterations equal to an uninterrupted run at the same
   ``chunk_iters``; the snapshot's size and load/save seconds; the same
   for the 64-key unplanned batch against (b)'s run. (d) Every verdict
   of (a) and the six ``invalid`` trials certified by ``core.check``
   (``analysis/certify.py``): no VC error, every invalid verdict
   confirmed by the cross-check, every device replay of the
   differential decided (the trials sample one segment each; the main
   histories' certificates are their witness replays, ``GATE_CERTIFY``).
6. ``obs``: the obs core, the search hooks and the failure render with
   the store (``jepsen_tpu_torch/obs``, ``store.py``), the store's
   ``base_dir`` in a temporary directory. (a) The two main-path
   histories through ``core.check_safe`` with
   ``checkers.linearizable(jax-wgl)``, unbound, under ``obs.run_scope``
   and under it with ``phases?`` off, in turns, ``OBS_ROUNDS`` times,
   the bound runs persisted by ``store.write_obs``: all valid (the walls
   of each kind and their medians beside phase 3's); ``trace.jsonl`` read
   back by ``obs.load_trace``, its ``wgl.phase.*`` spans contiguous
   within each search and covering at least ``PHASE_COVERAGE`` of its
   wall; ``metrics.json`` holding the phase seconds, the heartbeat
   series and ``checker.checks``; rollout launches equal to phase 3's,
   bound and bound with ``phases?`` off; the cas-register history once
   profiled unbound and once bound with ``phases?`` off, kernel
   launches per iteration equal. (b) The first 64 batch keys through
   ``parallel.check_batch_encoded`` bound, at the gate's unplanned run's
   ``chunk_iters=1`` (its wall beside the gate's): verdicts equal to the
   gate's oracle, heartbeats with keys_alive, keys_running and compactions,
   explored never decreasing; one profiled iteration bound with
   ``phases?`` off against one unbound, launches equal. (c) The
   cas-register history through the default gate under a run scope:
   the device racer's heartbeats in that run's registry, nothing in the
   next step's registry after ``checkers.join_racers``. (d) An invalid
   trial of phase 4 through ``independent.checker(linearizable(wgl))``:
   phase 4's verdict; without matplotlib no ``linear.png``, and the
   render's containment caught exactly one ModuleNotFoundError naming
   it; ``results.json``, ``test.json`` and the history written by the
   port's store and read back equal.
7. ``mesh``: the multi-device search over ``torch.distributed`` at world
   size 1 (NCCL, a ``HashStore``, a 1-D "cuda" ``DeviceMesh``: the smoke
   runs on one card). (a) The two main-path histories
   through ``core.check`` with ``linearizable(jax-wgl, {"mesh": mesh})``
   (the sharded single search, ``parallel/searchshard.py``): valid, the
   certificate clean, iterations, explored configs and rollout kernel
   launches equal to phase 3's flat runs, with the collective calls per
   iteration and the walls beside phase 3's. (b) The six ``invalid``
   trials through the same gate: phase 4's verdicts, every witness
   certified clean. (c) The gate phase's 64 keys through
   ``independent.checker`` with the mesh at ``chunk_iters=1`` (the mesh
   key batch), planned and unplanned: per-key verdicts equal to the
   gate's oracle, the walls beside the gate's unmeshed ones, no rollout
   kernel launch. (d) A 2-D
   (1, 1) mesh is refused with ValueError. The process group is torn
   down at the end of the phase.
8. ``run``: ``core.run`` drives a test from its first op to its verdict
   on the card (dummy remote, each test's store in a temporary
   directory, certification left to the gate phase). (a) The main-path
   shape recorded live: 10,000 read/write/cas ops over five nodes at 64
   workers, 5% left indeterminate by the atom client, the
   ``partition_random_halves`` nemesis switching every 0.5 s, checked by
   ``compose({linearizable(jax-wgl), timeline.html()})``: valid, no
   ``error`` anywhere in the results, rollout launches > 0, 20,000
   client entries beside the nemesis's, the history, results and
   timeline in the store, partition commands in the dummy log; the
   run's wall, the interpreter's ops/s, the analyze and checker
   seconds. (b) The register workload (``tests/linearizable_register``)
   at its defaults ("competition") with a keyed atom client,
   per-key-limit 200, 12,800 ops (about 64 keys): every key valid, one
   store directory per key. (c) 2,000 ops at concurrency 16 against a
   register that drops 1 write in 50 yet answers ok: ``False``, equal to
   ``oracle_verdict``; ``linear.png`` in the store with matplotlib, its
   contained ModuleNotFoundError without. (d) A ``time-limit-s`` of 1 s
   on an endless generator: results salvaged, the partial history
   decided True or False on the card with no error, no journal left.
9. ``monitor``: monitored runs through ``core.run`` (``test["monitor"]``),
   with run's harness and clients, each case's rollout launches counted
   from 0. (a) Run (a)'s register run at the monitor's default chunk
   (64) and engine ("jax-wgl", the flat search with the rollout
   kernel): the monitor's verdict True and equal to the offline one,
   ``monitor.json`` in the store, the monitor's checks (counted until
   ``analyze`` starts) launching the kernel; its checks, chunks, check
   seconds, time to the first verdict and the interpreter's client ops/s
   beside run (a)'s. (b) Run (c)'s lost writes: the monitor aborts the
   run ("monitor-violation"), the offline verdict on the salvaged history
   False and equal to ``oracle_verdict``, the monitor's evidence
   certified (the cross-check confirms, no VC error); again with
   ``skip-offline?`` (``monitor-only``). (c) The "streamlin" engine at
   chunk 8 on a clean and a lost-write run of 300 ops: each verdict equal
   to the CPU oracle's, no fall-back; seconds per event. (d) The
   list-append workload (``tests/cycle/append``) against a serializable
   in-memory client, 8,192 txns at 8 processes, monitored by the txn
   family at chunks of 1,024: the monitor's verdict True and equal to the
   offline check's; (e) a stale-read copy of 2,048 txns: aborted, False
   offline with the monitor's anomaly types, its cycle witness
   certified. The txn cases launch no rollout kernel.
10. ``cli``: the command line as a user runs it, through
   ``jepsen_tpu_torch.__main__.main(argv)`` and the suites' ``main``
   called in process (each run's exit code from its ``SystemExit``,
   its store in a temporary directory, its rollout launches counted
   from 0). (a) ``test --workload register --no-ssh --monitor
   --concurrency 10n --per-key-limit 200 --time-limit 10``: exit 0,
   valid, the monitor's verdict True, the history, results, test map,
   log and ``monitor.json`` in the store, rollout launches > 0; its
   keys, ops, client ops/s, monitor checks and the ``run-case`` and
   ``analyze`` spans beside the wall. (b) The same with ``--bug
   dirty-read --monitor-chunk 8`` and 30 s to abort in: exit 1,
   aborted by the monitor
   ("monitor-violation", salvaged), invalid with a numeric
   ``detected_at_index``, the offline failures equal to the CPU
   oracle's (``wgl``) on the stored history, the monitor's evidence
   certified. (c) ``analyze`` with (b)'s options: exit 1, the same
   failures. (d) A subprocess, ``python3 -m jepsen_tpu_torch.suites.etcd
   test --stub --no-ssh ... --time-limit 60 --hard-time-limit 4``:
   salvaged with ``"abort-reason": "time-limit"``, no journal left, the
   exit code ``hard_main`` maps from the verdict. (e) ``suites.txn test
   --workload append --nemesis faketime --monitor --time-limit 8``: exit
   0, the clock nemesis's ops contained as info completions under the
   dummy remote, the txn monitor's verdict True; then with ``--bug
   future-read --monitor-chunk 8``: exit 1, aborted mid-run, a G1c
   anomaly, its cycle witness certified. (f) ``--profile``
   (``--per-key-limit 50 --time-limit 3``): ``profile.json`` with status
   "done" naming a non-empty Chrome trace whose CUDA kernel events
   ``profile_main.kernel_stats`` counts, with the device's idle share
   over the capture.
11. ``campaign``: the campaign runner on one host
   (``jepsen_tpu_torch/campaign``), its store in a temporary directory.
   (a) ``campaign --no-ssh --axis workload=register,append --seeds 2
   --parallel 2 --device-slots 1 --monitor --concurrency 10n
   --per-key-limit 200 --time-limit 3`` through ``__main__.main``: exit
   0, the four cells True, the report's fleetlint audit without error
   and its certification of all four runs without error, no two checks
   overlapping in time (a probe around each cell's checker and each
   monitor's chunk check, the txn monitor's included), the rollout
   kernel launched (the register cells' monitors); each cell's wall and
   the slot waits. (b) The same matrix through
   ``campaign.run_cells`` with a latch set when its first cell finishes,
   then ``--resume``: exactly the unjournaled cells rerun, the outcomes
   equal to (a)'s. (c) ``campaign --lint --campaign-id`` (a)'s: exit 0.
   (d) ``obs.trend.mini_bench`` on the card twice, each the best of
   10 repeats, recorded, the ``gate`` passing A/A; ops/s and the
   fingerprint.
12. ``fleet``: the fleet (``jepsen_tpu_torch/fleet``), its store in a
   temporary directory. (a) Campaign (a)'s matrix with ``--workers
   local,local --backends gpu,cpu --worker-store <tmp>`` (every cell a
   ``python -m jepsen_tpu_torch.fleet.worker`` process of its own)
   through ``__main__.main``: exit 0, every cell True and on the ``gpu``
   tier, every run mirrored home, the audit and ``certify_campaign`` of
   all four runs without error, two worker lanes in the merged trace,
   and the phase plane's ``compile`` lap in a register cell's mirrored
   ``metrics.json`` (the worker process loaded the rollout library and
   searched with it on the card). (b) The same cells through
   ``fleet.run_fleet`` with one seeded worker kill: the cell is leased,
   its lease fails, it is leased again and decided as in (a). Each
   cell's wall, each worker's start-up and each part's seconds; the
   workers' launches are not in this process's counter, which must
   stay at 0.
13. ``batch``: the JAX package's headline key batch at full width
   (``simulate.bench_histories``, as ``bench.py`` rungs 2 and 2b draw
   it): 256 cas-register keys, 8 processes, 200 ops per key, crash_p
   0.02, every 8th key corrupted, through
   ``parallel.check_batch_encoded`` on the card: one call under
   ``torch.profiler``, which also warms up (kernel launches per
   iteration, device idle share; ``profile_main.profile_batch``), then
   one timed call (wall, ops/s, iterations, compactions, invalid keys).
   Both calls must decide alike. No key may be
   unknown, at least one must be invalid, and the first 32 verdicts must
   equal the CPU oracle's (the gate phase's).
14. ``independent``: the first 64 of those keys wrapped in
   ``independent.tuple_`` and merged into one history, through
   ``independent.checker(compose({"linearizable": ..., "ok":
   unbridled_optimism()}))`` with the default gate and planning on:
   exactly one call of ``parallel.check_batch_encoded``, with every
   key's segments (92 pairs), and ``failures`` equal to the corrupted
   keys.
15. ``queues``: a 32-key fifo-queue batch and a 32-key unordered-queue
   batch (150 ops and 6 processes per key, crash_p 0.02, every 8th key
   corrupted) with the fast check off, so the device search with padded
   queue states decides, within ``QUEUE_MAX_CONFIGS`` (96 iterations of
   128 lanes). The CPU oracle for queues is the
   model's exact polynomial decision (the aspect fast check, which the
   batch was denied), and, for every key the sequential WGL oracle
   decides within 1,000 configurations, that oracle too. Every decided
   verdict must equal the oracles', every valid key must be decided, and
   a key may come back unknown only if the oracle finds it invalid: the
   proof that a corrupted 150-op FIFO key has no linearization is an
   exhaustive search, which for some keys outlasts any budget (the JAX
   engine does not finish it for some of these keys either). Then
   ``bench.py``'s rung-4 FIFO history through
   ``checkers.linearizable``, fast check on.

16. ``streamlin``: the streaming frontier fold (``checker/streamlin.py``,
   torch ops) on keys of the batch above: (a) the offline face at the
   hard frontier cap on ``OFFLINE_KEYS`` (one of them corrupted), each
   verdict equal to the CPU sweep's (``linear``) and each violating op
   the return at which the sweep fails; (b) one lane-batched fold of
   ``FOLD_BATCH_KEYS`` keys' whole histories at ``FOLD_BATCH_F`` rows,
   every lane equal to its solo fold, only corrupted keys invalid, the
   lanes that overflowed listed: seconds and host syncs per event step;
   (c) ``StreamCheck`` on ``STREAM_KEYS`` (key 7) fed op by op, checked every ``STREAM_CHUNK`` completions, each
   verdict equal to the CPU WGL oracle's on the same prefix, no
   fall-back, the corrupted keys caught by the frontier and confirmed
   by the port's WGL engine: seconds, host syncs, passes and frontier
   peak per event. (b) and (c) are not profiled: gathering the
   profiler's events costs more than the run itself (PERF.md).
17. ``txn``: the cycle checkers at ``bench.py`` rung 15's txn shape, a
   serial list-append history of 8,192 txns (1 read + 7 appends, 8
   processes; ``simulate.txn_append_history``): ``cycle.append.check``
   decides it valid on the card (one profiled call: squarings, closure
   device seconds, launches, idle share, peak device memory); a 2,048-txn
   copy with one injected G1c cycle is decided invalid with G1c;
   ``TxnCheck``
   at chunks of 1,024 txns agrees with the offline check of the prefix
   at the chunks of ``TXN_OFFLINE_AT`` txns and at the last;
   one closure at n=2048 and a seeded 2,048-txn wr check equal the
   same on the CPU; one squaring at n=16384 timed in float32, TF32 and
   bf16, all three boolean-identical.

The competition, checkpoint, certify, obs, mesh, run, monitor, cli and
campaign paths run the rollout kernel (each counted; the fleet's in its
worker processes, shown by their compile laps, not counted here; ``run_keyed`` may
not, as the key batch rolls on the scan; the monitor's txn paths do
not). The planned, batch, independent, queue, streamlin, trend and
txn paths do not run it: each of them is run with the rollout kernel's
launch
count set to 0 and must leave it at 0. The batch pins the scan rollout,
as the JAX package's does; the txn path has no linearizability search;
the streamlin path's only search is the confirm of a frontier
violation, and on the corrupted keys here ``torch_wgl``'s host
pre-check (``_state_abstraction_check``: a read of a value no reachable
state holds) decides it before any search starts, so its
``confirmed_by`` is ``aspect``. Then a ``{"kernels": [...]}`` line (with each
kernel's launches in the main phase, and on every path) and, last,
``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero.
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
BATCH_KEYS, INDEPENDENT_KEYS, QUEUE_KEYS, QUEUE_OPS = 256, 64, 32, 150
#: every batch here corrupts the history of one key in this many
CORRUPT_EVERY = 8
#: the queue batches' search budget. The fifo batch's corrupted keys that
#: the search cannot exhaust run to it, and each iteration is a host loop
#: of about 11,000 launches, so the budget sets the phase's length: 64
#: keys at 256 iterations of 64 lanes took 120 s of the run (PERF.md);
#: cut to 32 keys at 128 iterations of 128 lanes, the same 16,384
#: configs per key (16 keys at 64 iterations decided no key invalid),
#: then to 96 iterations (12,288 configs per key) for the fleet phase's
#: room: the fifo batch's two keys that run to the budget took 59.5 s
QUEUE_MAX_CONFIGS = 96 * 128 * QUEUE_KEYS
#: the sequential WGL oracle's budget per queue key: at 5,000 configs it
#: decided 5 of the 32 fifo keys in 29.1 s of the phase, the exact
#: polynomial oracle checking every key besides; cut for the fleet
#: phase's room
QUEUE_WGL_ORACLE_CONFIGS = 1_000
#: the gate phase: the first GATE_KEYS batch keys through the planner,
#: which splits GATE_SEGMENTS[k] searches out of key k (the JAX planner's
#: counts, which tests/test_torch_searchplan.py pins), the CPU oracle in
#: ORACLE_WORKERS processes beside the card's runs, and checkpointed runs
#: stopped after CKPT_ITERS iterations
GATE_KEYS, ORACLE_WORKERS, CKPT_ITERS = INDEPENDENT_KEYS, 4, 3
#: the obs phase: the share of each search's wall its phase spans must
#: cover (the attribution target of jepsen_tpu_torch/obs/phases.py)
PHASE_COVERAGE = 0.95
#: the obs phase runs each main-path history unbound, bound and bound with
#: phases off, in turns, this many times: one call's walls vary by tens of
#: percent on the card's host (PERF.md)
OBS_ROUNDS = 3
#: the certifier's settings for the 10k-op main-path verdicts: the
#: witness replay, and no differential sample. Its CPU replays cannot
#: decide a 10k-op, 64-process history within any budget the run
#: affords: at 20,000 configs they ran out after 167 s (cas-register)
#: and 43 s (mutex) in one H100 run (PERF.md). The six 220-op trials
#: keep the defaults (one sample, 100,000 configs)
GATE_CERTIFY = {"samples": 0}
GATE_SEGMENTS = (1, 1, 1, 1, 1, 1, 2, 2, 1, 2, 1, 1, 1, 1, 2, 1,
                 3, 1, 1, 1, 1, 1, 3, 1, 2, 1, 1, 1, 2, 3, 3, 2,
                 2, 2, 1, 1, 1, 1, 1, 1, 5, 2, 2, 1, 2, 1, 2, 1,
                 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1)
ROLLOUT_REPLACES = "jepsen_tpu/checker/pallas_rollout.py:179"
#: the streamlin phase. The offline face runs key 0 and the corrupted
#: key 7 of the batch (key 15 was cut for the gate phase's room: its CPU
#: sweeps), the stream the corrupted key 7 (key 15 was cut for the
#: fleet phase's room; each is
#: checked about 20 times before its violation), both at the hard
#: frontier cap (with crashed ops left open, a 200-op key's closure can
#: outgrow the default cap of 4,096 configs); the lane batch runs the
#: first FOLD_BATCH_KEYS keys at FOLD_BATCH_F rows each, every lane held
#: against its solo fold; the stream is checked every STREAM_CHUNK
#: completions. Fewer keys than the batch's 256: the fold is a host
#: loop of torch ops, about 800 launches and 4 host reads per event
#: (PERF.md), so each key costs seconds, and the two phases together
#: are to take about two minutes of the run. FOLD_BATCH_F holds every
#: one of the first 8 keys' closures but key 4's: the CPU sweep's
#: largest config set per return is 8,168 configs for key 0 and 49,280
#: for key 4, so lane 4 overflows (status 2) and the batch says which.
#: The device time of a pass grows with lanes x rows (PERF.md)
OFFLINE_KEYS, STREAM_KEYS = (0, 7), (7,)
FOLD_BATCH_KEYS, FOLD_BATCH_F = 8, 8192
STREAM_CHUNK = 8
#: the txn phase at bench.py rung 15's txn shape, cut from its 16,384
#: txns to 8,192 for the fleet phase's room: txns of 1 read and
#: 7 appends over 8 processes, TxnCheck chunks of 1,024 txns; the G1c
#: copy, cut to TXN_G1C_TXNS txns for the gate phase's room (at 16,384
#: it took 21.8 s), ties the first txns of keys 128 and 129; the closure
#: and the wr history compared with the CPU
TXN_TXNS, TXN_APPENDS, TXN_PROCS, TXN_CHUNK = 8192, 7, 8, 1024
TXN_G1C_TXNS, TXN_G1C = 2048, (1024, 1032)
#: TxnCheck's chunk verdicts are held against the offline check of the
#: same prefix at these txn counts (powers of two) and at the last chunk
#: (the whole history): each offline check costs up to the whole
#: history's (mostly host work on n^2 arrays), which the phase cannot
#: afford at every chunk
TXN_OFFLINE_AT = (1024, 2048, 4096, 8192)
CLOSURE_N, WR_TXNS = 2048, 2048
#: the one timed squaring stays at rung 15's 16,384 txns
SQUARING_N = 16384


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
    from jepsen_tpu_torch.checker import checkers, rollout
    hist = simulate.random_history(random.Random(45100), model, 64, n_ops,
                                   crash_p)
    opts = {} if kernel else {"rollout_kernel": "scan"}
    chk = checkers.linearizable({"model": model, "algorithm": "jax-wgl",
                                 "engine_opts": opts})
    launched = rollout.launches
    t0 = time.monotonic()
    r = chk.check({}, hist)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_ops = sum(1 for o in hist if o["type"] == "invoke")
    return r, {"model": model, "rollout": "kernel" if kernel else "scan",
               "valid": r["valid"], "wall_s": wall,
               "rollout_launches": rollout.launches - launched,
               "iterations": r.get("iterations"),
               "configs_explored": r.get("configs_explored"),
               "history_ops": n_ops, "ops_per_s": n_ops / wall,
               "table_load": r.get("table_load")}


def invalid_trials(dev):
    """Six 220-op cas-register histories, the odd ones corrupted with
    reads kept in range so the search, not a fast path, decides (as
    tests/test_jax_wgl.py's rollout trials are made): device verdict ==
    CPU oracle, and at least one is invalid. Returns the rows and the
    histories."""
    from jepsen_tpu_torch import models, simulate
    from jepsen_tpu_torch.checker import torch_wgl, wgl
    spec = models.cas_register_spec
    rng = random.Random(45100)
    rows, hists = [], []
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
        hists.append(hist)
    if not any(r["valid"] is False for r in rows):
        raise AssertionError("no invalid trial: the phase checked nothing")
    return rows, hists


def scan_only(what):
    """Fail unless the path just run left the rollout kernel's launch
    count at 0 (set to 0 just before it): the batch rolls on the scan."""
    from jepsen_tpu_torch.checker import rollout
    if rollout.launches != 0:
        raise AssertionError(f"{what}: the rollout kernel was launched "
                             f"{rollout.launches} times on that path")
    return rollout.launches


def oracle_verdict(hist):
    """The CPU oracle's verdict on one cas-register key: the sequential
    WGL search within 2M configurations (run in a worker process)."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checker import wgl
    spec = models.cas_register_spec
    return wgl.check_encoded(spec, *spec.encode(hist),
                             max_configs=2_000_000)["valid"]


class Certified:
    """``checker.core.certify_verdict`` wrapped for the gate phase: before
    each certification it waits for every competition racer to end
    (``checkers.join_racers``), so no straggler's launches fall into the
    certification's count; then it times the certification and counts
    its rollout kernel launches."""

    def __init__(self, dev):
        from jepsen_tpu_torch.checker import core
        self.dev, self.core, self.real = dev, core, core.certify_verdict
        self.runs = []

    def __enter__(self):
        self.core.certify_verdict = self
        return self

    def __exit__(self, *exc):
        self.core.certify_verdict = self.real

    def __call__(self, checker, test, hist, result, key=None):
        from jepsen_tpu_torch.checker import checkers, rollout
        t_in = time.monotonic()
        races = checkers.join_racers()
        run = {"entered": t_in, "races": races,
               "launches_before": rollout.launches,
               "join_s": time.monotonic() - t_in}
        t0 = time.monotonic()
        self.real(checker, test, hist, result, key=key)
        sync(self.dev)
        run.update(certify_s=time.monotonic() - t0,
                   launches=rollout.launches - run["launches_before"])
        self.runs.append(run)


def certificate_clean(what, test, result):
    """Fail unless ``checker.core.check`` certified ``result`` into
    ``test`` with no error finding; an invalid verdict must have been
    cross-checked (VC008's check) and confirmed, and a device verdict's
    differential replay must have decided on every engine it ran."""
    cert = test.get("certificate")
    if cert is None:
        raise AssertionError(f"{what}: no certificate (the certifier did "
                             f"not run, or crashed)")
    counts = test["analysis"]["certify"]["counts"]
    if counts["error"] or cert["verdict"] is not result["valid"]:
        raise AssertionError(f"{what}: certificate {counts}, verdict "
                             f"{cert['verdict']!r}: {cert['diagnostics']}")
    checks = {c["name"]: c for c in cert["checks"]}
    if result["valid"] is False \
            and checks.get("cross-check", {}).get("status") != "confirmed":
        raise AssertionError(f"{what}: invalid verdict not confirmed by the "
                             f"cross-check: {checks.get('cross-check')}")
    diff = [c for c in cert["checks"] if c["name"] == "differential"]
    if any(v not in (True, False) for c in diff
           if "jax-wgl" in c["verdicts"]
           for v in [c["verdicts"]["jax-wgl"]]):
        raise AssertionError(f"{what}: the differential's device replay "
                             f"did not decide: {diff}")
    return {"codes": sorted({d["code"] for d in cert["diagnostics"]}),
            "checks": cert["checks"]}


def gate_phase(dev, keys, flat, trials, trial_rows, n_ops=10_000,
               gate_keys=GATE_KEYS, ckpt_opts=None):
    """The linearizable gate at the JAX package's defaults: (a)
    competition on the two main-path histories through ``core.check``
    (winner, the device racer's wall and launches, each racer's exit
    after the verdict, against ``flat``, the flat "jax-wgl" walls of
    phase 3), each verdict certified (d); (b) the first ``gate_keys``
    batch keys through ``independent.checker`` with planning on and off,
    key for key equal to each other and to the CPU oracle, the port's
    segment counts equal to ``GATE_SEGMENTS``, one segmented key through
    ``Linearizable`` directly, and one profiled iteration of the planned
    and the unplanned batch; (c) checkpoint and resume of the
    cas-register main-path history and of the unplanned batch, each
    equal to an uninterrupted run at the same ``chunk_iters``; (d) the
    six ``invalid`` trials through ``core.check``, every certificate
    free of VC errors and every invalid verdict cross-checked. The
    main-path histories have ``n_ops`` ops; ``ckpt_opts`` go to the
    checkpointed single-key runs (a rehearsal on the CPU, where the
    plain rollout decides a short history in one iteration, passes a
    shallow ``rollout_depth``). Returns the phase's row and
    the oracle's verdicts of the ``gate_keys`` keys."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    from jepsen_tpu_torch import history as h
    from jepsen_tpu_torch import independent, models, parallel, simulate
    from jepsen_tpu_torch.analysis import searchplan
    from jepsen_tpu_torch.checker import checkers, core, rollout, torch_wgl
    from jepsen_tpu_torch.profile_main import profile_call, split
    spec = models.cas_register_spec
    t_start = time.monotonic()
    out = {"phase": "gate"}
    launches = {}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "gate")
    os.makedirs(work, exist_ok=True)

    # (a) + (d): competition, then certification, on the main path
    comp = []
    with Certified(dev) as cert:
        for model, crash_p in MAIN_HISTORIES:
            hist = simulate.random_history(random.Random(45100), model, 64,
                                           n_ops, crash_p)
            test = {"certify": dict(GATE_CERTIFY)}
            rollout.launches = 0
            t0 = time.monotonic()
            r = core.check(checkers.linearizable({"model": model}), test,
                           hist)
            wall = time.monotonic() - t0
            run = cert.runs[-1]
            if r["valid"] is not True:
                raise AssertionError(f"competition: {model} decided "
                                     f"{r['valid']!r}")
            race = run["races"][-1]
            dev_racer = race["racers"]["jax-wgl"]
            comp.append({
                "model": model, "winner": r["engine"], "valid": True,
                "check_s": run["entered"] - t0,
                "decided_s": race["decided_s"],
                "exit_after_verdict_s": race["exit_after_verdict_s"],
                "device_racer_wall_s": dev_racer["wall_s"],
                "device_racer": dev_racer,
                "cpu_racers": {k: v for k, v in race["racers"].items()
                               if k != "jax-wgl"},
                "flat_wall_s": flat[model],
                "device_racer_launches": run["launches_before"],
                "certify_s": run["certify_s"],
                "certify_launches": run["launches"], "wall_s": wall,
                "certificate": certificate_clean(f"competition {model}",
                                                 test, r)})
        launches["competition"] = sum(c["device_racer_launches"]
                                      for c in comp)
        if dev.type == "cuda" and launches["competition"] <= 0:
            raise AssertionError("competition never launched the rollout "
                                 "kernel")
        out["competition"] = comp

        # (d) the six invalid trials, their device verdicts certified
        rows = []
        for i, hist in enumerate(trials):
            test = {}
            r = core.check(checkers.linearizable(
                {"model": "cas-register", "algorithm": "jax-wgl"}), test,
                hist)
            if r["valid"] is not trial_rows[i]["valid"]:
                raise AssertionError(f"certify trial {i}: {r['valid']!r} "
                                     f"!= phase 4's")
            run = cert.runs[-1]
            rows.append({"trial": i, "valid": r["valid"],
                         "segments": r.get("searchplan", {}).get("segments",
                                                                 1),
                         "certify_s": run["certify_s"],
                         "certify_launches": run["launches"],
                         **certificate_clean(f"certify trial {i}", test, r)})
        certified = comp + rows
        launches["certify"] = sum(c["certify_launches"] for c in certified)
        out["certify"] = {"trials": rows,
                          "checks": len(certified),
                          "certify_s": sum(c["certify_s"]
                                           for c in certified),
                          "vc_errors": 0,
                          "cross_checked_invalid": sum(
                              r["valid"] is False for r in rows)}

    # (b) the planned path, the CPU oracle running beside it
    sub = keys[:gate_keys]
    pool = concurrent.futures.ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        t_oracle = time.monotonic()
        futures = [pool.submit(oracle_verdict, hh) for hh in sub]
        counts = [len(searchplan.plan_segments(spec, hh)[0]) for hh in sub]
        if tuple(counts) != GATE_SEGMENTS[:len(sub)]:
            raise AssertionError(f"planner: segments per key {counts} != "
                                 f"GATE_SEGMENTS")
        hist = keyed_history(sub)
        calls = []
        real = parallel.check_batch_encoded

        def counting(spec_, pairs, **kw):
            t0 = time.monotonic()
            res = real(spec_, pairs, **kw)
            sync(dev)
            calls.append({"pairs": pairs, "kw": kw, "results": res,
                          "batch_s": time.monotonic() - t0})
            return res

        lin = checkers.linearizable({"model": "cas-register",
                                     "algorithm": "jax-wgl",
                                     "engine_opts": {"chunk_iters": 1}})
        chk = independent.checker(lin)
        runs = {}
        parallel.check_batch_encoded = counting
        rollout.launches = 0
        try:
            for name, test in (("planned", {"certify?": False}),
                               ("unplanned", {"searchplan?": False,
                                              "certify?": False})):
                t0 = time.monotonic()
                r = core.check(chk, test, hist)
                runs[name] = (r, time.monotonic() - t0, calls[-1])
        finally:
            parallel.check_batch_encoded = real
        launches["planned"] = scan_only("planned")
        if len(calls) != 2:
            raise AssertionError(f"planned: {len(calls)} batched calls, "
                                 f"expected one per run")
        oracle = [f.result() for f in futures]
        oracle_s = time.monotonic() - t_oracle
    rp, ru = runs["planned"][0], runs["unplanned"][0]
    for k in range(len(sub)):
        got = (rp["results"][k]["valid"], ru["results"][k]["valid"])
        if got != (oracle[k], oracle[k]):
            raise AssertionError(f"planned key {k}: planned/unplanned "
                                 f"{got} != oracle {oracle[k]!r}")
    seg_keys = [k for k, c in enumerate(counts) if c > 1]
    direct = checkers.linearizable({"model": "cas-register",
                                    "algorithm": "jax-wgl"})
    k = seg_keys[0]
    t0 = time.monotonic()
    rd = direct.check({}, sub[k])
    direct_s = time.monotonic() - t0
    if rd.get("searchplan", {}).get("segments") != counts[k] \
            or rd["valid"] != oracle[k]:
        raise AssertionError(f"direct planned key {k}: {rd['valid']!r}, "
                             f"{rd.get('searchplan')}")
    launches["planned"] += scan_only("planned (direct)")

    def one_iteration(pairs):
        def run():
            return parallel.check_batch_encoded(spec, pairs, max_configs=1)
        if dev.type != "cuda":          # a rehearsal: nothing to profile
            t0 = time.monotonic()
            run()
            return {"searches": len(pairs), "wall_s": time.monotonic() - t0}
        _, wall, ev = profile_call(run, host_ops=False)
        st = split(ev, 1)
        return {"searches": len(pairs), "wall_s": wall,
                "kernel_launches": st["kernel_launches"],
                "device_idle_share": st["device_idle_share"]}

    plan_s = sum(r.get("searchplan", {}).get("plan_s", 0.0)
                 for r in rp["results"].values())
    out["planned"] = {
        "keys": len(sub), "split_keys": len(seg_keys),
        "searches": sum(counts),
        "batch_width": torch_wgl._bucket(sum(counts), 1),
        "cuts": sum(r.get("searchplan", {}).get("cuts", 0)
                    for r in rp["results"].values()),
        "plan_s": plan_s,
        "planned_wall_s": runs["planned"][1],
        "unplanned_wall_s": runs["unplanned"][1],
        "planned_batch_s": runs["planned"][2]["batch_s"],
        "unplanned_batch_s": runs["unplanned"][2]["batch_s"],
        "planned_iterations": max(r.get("iterations") or 0
                                  for r in runs["planned"][2]["results"]),
        "unplanned_iterations": max(
            r.get("iterations") or 0
            for r in runs["unplanned"][2]["results"]),
        "failures": rp["failures"], "oracle_s": oracle_s,
        "oracle_workers": ORACLE_WORKERS,
        "direct": {"key": k, "segments": counts[k], "valid": rd["valid"],
                   "wall_s": direct_s},
        "first_iteration": {
            "planned": one_iteration(runs["planned"][2]["pairs"]),
            "unplanned": one_iteration(runs["unplanned"][2]["pairs"])}}
    launches["planned"] += scan_only("planned (profiled iterations)")

    # (c) checkpoint and resume: the cas-register main-path history...
    hist = simulate.random_history(random.Random(45100), "cas-register", 64,
                                   n_ops, 0.05)
    e, st = spec.encode(hist)
    prep = torch_wgl._prepare_search(spec, e, st)[1]
    W = torch_wgl._plan_sizes(prep[8], prep[11], prep[9])[1]
    ck = os.path.join(work, "main.npz")
    rollout.launches = 0
    ckpt_opts = dict(ckpt_opts or {}, chunk_iters=1)
    want = torch_wgl.check_encoded(spec, e, st, **ckpt_opts)
    stop = min(CKPT_ITERS, want["iterations"] - 1)
    if stop < 1:
        raise AssertionError(f"checkpoint: the history decides in "
                             f"{want['iterations']} iteration(s)")
    r1 = torch_wgl.check_encoded(spec, e, st, checkpoint=ck,
                                 max_configs=stop * W, **ckpt_opts)
    if r1["valid"] != "unknown" or not os.path.exists(ck):
        raise AssertionError(f"checkpoint: the stopped run decided "
                             f"{r1['valid']!r}")
    size = os.path.getsize(ck)
    t0 = time.monotonic()
    with np.load(ck) as data:
        fp = bytes(data["fingerprint"]).decode()
    snap = torch_wgl.read_snapshot(ck, fp)
    carry = torch_wgl.carry_from_numpy(
        [snap[f"c{i}"] for i in range(torch_wgl.N_CARRY)], dev)
    sync(dev)
    load_s = time.monotonic() - t0
    t0 = time.monotonic()
    torch_wgl.save_carry(os.path.join(work, "resave.npz"), fp, carry)
    save_s = time.monotonic() - t0
    t0 = time.monotonic()
    r2 = torch_wgl.check_encoded(spec, e, st, checkpoint=ck, **ckpt_opts)
    resume_s = time.monotonic() - t0
    if (r2["valid"], r2["iterations"]) != (want["valid"],
                                           want["iterations"]) \
            or os.path.exists(ck):
        raise AssertionError(f"checkpoint: resumed {r2['valid']!r} in "
                             f"{r2['iterations']} iterations, "
                             f"uninterrupted {want['valid']!r} in "
                             f"{want['iterations']}")
    launches["checkpoint"] = rollout.launches
    main_ck = {"iterations": want["iterations"],
               "stopped_at": r1["iterations"], "snapshot_bytes": size,
               "save_s": save_s, "load_s": load_s, "resume_s": resume_s}
    # ... and the unplanned 64-key batch, against (b)'s run at the same
    # chunk_iters; stopped after a few iterations at its live width
    pairs = runs["unplanned"][2]["pairs"]
    base = runs["unplanned"][2]["results"]
    n_live = sum(r.get("engine") == "jax-wgl" for r in base)
    ck = os.path.join(work, "batch.npz")
    rollout.launches = 0
    t0 = time.monotonic()
    b1 = parallel.check_batch_encoded(spec, pairs, chunk_iters=1,
                                      checkpoint=ck,
                                      max_configs=CKPT_ITERS * 64 * n_live)
    stop_s = time.monotonic() - t0
    if not os.path.exists(ck) \
            or not any(r["valid"] == "unknown" for r in b1):
        raise AssertionError("batch checkpoint: the stopped run decided "
                             "every key")
    with np.load(ck) as data:
        width, at = len(data["alive"]), int(data["it"])
    bsize = os.path.getsize(ck)
    t0 = time.monotonic()
    b2 = parallel.check_batch_encoded(spec, pairs, chunk_iters=1,
                                      checkpoint=ck)
    bresume_s = time.monotonic() - t0
    fields = ("valid", "iterations", "configs_explored")
    bad = [k for k, (g, w) in enumerate(zip(b2, base))
           if [g.get(f) for f in fields] != [w.get(f) for f in fields]]
    if bad or os.path.exists(ck):
        raise AssertionError(f"batch checkpoint: resumed keys {bad} differ "
                             f"from the uninterrupted run")
    launches["checkpoint"] += scan_only("checkpoint")
    out["checkpoint"] = {"main": main_ck, "batch": {
        "keys": len(pairs), "stopped_at": at, "snapshot_width": width,
        "snapshot_bytes": bsize, "stop_s": stop_s, "resume_s": bresume_s,
        "iterations": max(r.get("iterations") or 0 for r in base)}}
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t_start
    return out, oracle


class SearchWalls:
    """``torch_wgl.check_encoded`` wrapped for the obs phase: each bound
    search's start and end on the tracer's clock (ns), so its phase
    spans can be held against its wall."""

    def __init__(self):
        from jepsen_tpu_torch.checker import torch_wgl
        self.mod, self.real = torch_wgl, torch_wgl.check_encoded
        self.walls = []

    def __enter__(self):
        self.mod.check_encoded = self
        return self

    def __exit__(self, *exc):
        self.mod.check_encoded = self.real

    def __call__(self, *a, **k):
        from jepsen_tpu_torch import obs
        tr = obs.current_sinks()[0]
        if tr is None:                      # unbound: nothing to hold
            return self.real(*a, **k)
        t0 = tr.now_ns()
        try:
            return self.real(*a, **k)
        finally:
            self.walls.append((t0, tr.now_ns()))


def phase_coverage(events, walls):
    """Fail unless the trace's ``wgl.phase.*`` spans are contiguous and do
    not overlap within each search, and cover at least PHASE_COVERAGE of
    each search's wall. Returns per search its wall, coverage and seconds
    per phase."""
    spans = sorted((e for e in events if e.get("cat") == "phase"
                    and e["name"].startswith("wgl.phase.")),
                   key=lambda e: e["ts"])
    out = []
    for t0, t1 in walls:
        mine = [e for e in spans
                if t0 / 1e3 - 1 <= e["ts"] <= t1 / 1e3 + 1]
        if not mine:
            raise AssertionError("obs: a search left no phase spans")
        for a, b in zip(mine, mine[1:]):
            if abs(a["ts"] + a["dur"] - b["ts"]) > 1.0:
                raise AssertionError(f"obs: phase spans not contiguous: "
                                     f"{a} then {b}")
        wall = (t1 - t0) / 1e9
        per = {}
        for e in mine:
            name = e["name"][len("wgl.phase."):]
            per[name] = per.get(name, 0.0) + e["dur"] / 1e6
        cov = sum(per.values()) / wall
        if cov < PHASE_COVERAGE:
            raise AssertionError(f"obs: phases cover {cov:.4f} of a "
                                 f"{wall:.4f} s search: {per}")
        out.append({"wall_s": wall, "coverage": cov, "phase_s": per})
    return out


def kernels_per_iteration(run, iterations):
    """Kernel launches per iteration of one profiled call of ``run``."""
    from jepsen_tpu_torch.profile_main import profile_call
    _, wall, ev = profile_call(run, host_ops=False)
    return sum(e[3] for e in ev) / max(1, iterations), wall


def obs_phase(dev, keys, main_rows, gate_verdicts, gate_batch_s, trials,
              trial_rows, n_ops=10_000, gate_keys=GATE_KEYS):
    """The obs core, the search hooks and the failure render with the
    store, on the card. (a) The two main-path histories through
    ``core.check_safe`` with ``checkers.linearizable(jax-wgl)`` unbound,
    under ``obs.run_scope`` and under it with ``phases?`` off, in turns,
    OBS_ROUNDS times: valid, the trace's phase spans contiguous and
    covering at least PHASE_COVERAGE of each search's wall, the metrics
    holding the phase, heartbeat and checker series; rollout launches
    equal to phase 3's (``main_rows``) every time, and in one profiled
    run of the cas-register history unbound and one with ``phases?``
    off kernel launches per iteration equal. (b) The first ``gate_keys``
    batch keys through ``parallel.check_batch_encoded`` bound at
    ``chunk_iters=1``, as the gate's unplanned run (``gate_batch_s``):
    verdicts equal to the gate's (``gate_verdicts``), heartbeats with
    keys_alive, keys_running and compactions, explored never decreasing;
    one profiled iteration bound with ``phases?`` off against one
    unbound, launches equal. (c) The
    cas-register history through the default gate under a run scope:
    the device racer's heartbeats in the run's registry, nothing in the
    next step's after ``join_racers``. (d) One invalid trial through
    ``independent.checker(linearizable(wgl))``: the verdict equal to
    phase 4's; without matplotlib no ``linear.png`` and exactly one
    contained ModuleNotFoundError; ``results.json`` and the history
    written by the port's store and read back equal. The store's
    ``base_dir`` is a temporary directory, removed at the end."""
    import contextlib
    import logging
    import shutil
    import tempfile

    from jepsen_tpu_torch import independent, models, obs, parallel
    from jepsen_tpu_torch import simulate, store
    from jepsen_tpu_torch.checker import checkers, core, rollout
    spec = models.cas_register_spec
    t_start = time.monotonic()
    out = {"phase": "obs"}
    launches = {}
    base, store.base_dir = store.base_dir, tempfile.mkdtemp(prefix="jt-obs-")
    try:
        # (a) the single-key search unbound, bound and with phases off,
        # in turns, OBS_ROUNDS times
        flat = {r["model"]: r for r in main_rows if r["rollout"] == "kernel"}
        modes = (("unbound", None), ("bound", {}),
                 ("phases_off", {"phases?": False}))
        rows = []
        launches["obs"] = 0
        for model, crash_p in MAIN_HISTORIES:
            hist = simulate.random_history(random.Random(45100), model, 64,
                                           n_ops, crash_p)
            chk = checkers.linearizable({"model": model,
                                         "algorithm": "jax-wgl"})
            want = flat[model]["rollout_launches"]
            row = {"model": model, "phase3_wall_s": flat[model]["wall_s"],
                   "phase3_launches": want, "searches": []}
            for rnd in range(OBS_ROUNDS):
                for name, extra in modes:
                    test = {"name": f"obs-{model}-{name}-{rnd}",
                            "start-time": store.local_time(),
                            "certify?": False, **(extra or {})}
                    rollout.launches = 0
                    scope = obs.run_scope(test) if extra is not None \
                        else contextlib.nullcontext()
                    with scope, SearchWalls() as sw:
                        t0 = time.monotonic()
                        r = core.check_safe(chk, test, hist)
                        sync(dev)
                        wall = time.monotonic() - t0
                    launches["obs"] += rollout.launches
                    if r["valid"] is not True:
                        raise AssertionError(f"obs {model} {name}: "
                                             f"{r['valid']!r} "
                                             f"{r.get('error')}")
                    if dev.type == "cuda" and rollout.launches != want:
                        raise AssertionError(
                            f"obs {model} {name}: {rollout.launches} "
                            f"rollout launches, phase 3 made {want}")
                    row.setdefault(f"{name}_wall_s", []).append(wall)
                    row[f"{name}_iterations"] = r.get("iterations")
                    if extra is None:
                        continue
                    store.write_obs(test, final=True)
                    run = store.path(test)
                    evs = obs.load_trace(os.path.join(run, "trace.jsonl"))
                    with open(os.path.join(run, "metrics.json")) as f:
                        snap = json.load(f)
                    keys_ = set(snap["counters"]) | set(snap["histograms"]) \
                        | set(snap["gauges"])
                    need = ["wgl.chunks{engine=jax-wgl}",
                            "wgl.chunk_s{engine=jax-wgl}",
                            "wgl.states_explored{engine=jax-wgl}",
                            "wgl.search_depth{engine=jax-wgl}",
                            "checker.checks{checker=Linearizable,valid=True}"]
                    if name == "bound":
                        need.append("wgl.phase_s{engine=jax-wgl,phase=device}")
                    missing = [k for k in need if k not in keys_]
                    if missing:
                        raise AssertionError(f"obs {model} {name}: "
                                             f"metrics.json lacks {missing}")
                    if name == "bound":
                        row["searches"] += phase_coverage(evs, sw.walls)
                        row["heartbeats"] = sum(
                            e["name"] == "wgl.heartbeat.jax-wgl"
                            for e in evs)
                    elif any(k.startswith("wgl.phase_s") for k in keys_):
                        raise AssertionError(f"obs {model}: phases? false, "
                                             f"yet phase seconds were "
                                             f"recorded")
            for name, _ in modes:
                w = sorted(row[f"{name}_wall_s"])
                row[f"{name}_median_s"] = w[len(w) // 2]
            rows.append(row)
        # one profiled run of the cas-register history each way
        model, crash_p = MAIN_HISTORIES[0]
        hist = simulate.random_history(random.Random(45100), model, 64,
                                       n_ops, crash_p)
        chk = checkers.linearizable({"model": model, "algorithm": "jax-wgl"})
        its = rows[0]["unbound_iterations"]
        prof = {}
        if dev.type == "cuda":
            prof["unbound"] = kernels_per_iteration(
                lambda: chk.check({}, hist), its)
            with obs.run_scope({"phases?": False}):
                prof["phases_off"] = kernels_per_iteration(
                    lambda: chk.check({}, hist), its)
            if prof["unbound"][0] != prof["phases_off"][0]:
                raise AssertionError(f"obs: kernels per iteration {prof}")
        out["single_key"] = {"checks": rows, "profiled": {
            k: {"kernels_per_iteration": v[0], "wall_s": v[1]}
            for k, v in prof.items()}}

        # (b) the key batch under a bound registry
        pairs = [spec.encode(hh) for hh in keys[:gate_keys]]
        test = {}
        with obs.run_scope(test):
            t0 = time.monotonic()
            res = parallel.check_batch_encoded(spec, pairs, chunk_iters=1)
            sync(dev)
            bwall = time.monotonic() - t0
        got = [r["valid"] for r in res]
        if got != list(gate_verdicts[:gate_keys]):
            raise AssertionError(f"obs batch: verdicts differ from the "
                                 f"gate's: {got} vs {gate_verdicts}")
        hb = [e["args"] for e in test["obs"]["tracer"].events()
              if e["name"] == "wgl.heartbeat.jax-wgl-batch"]
        if not hb or not {"keys_alive", "keys_running",
                          "compactions"} <= set(hb[-1]):
            raise AssertionError(f"obs batch: heartbeats {hb[-1:]}")
        explored = [a["explored"] for a in hb]
        if explored != sorted(explored):
            raise AssertionError("obs batch: explored decreased")

        def one(bound):
            def run():
                return parallel.check_batch_encoded(spec, pairs,
                                                    max_configs=1)
            if not bound:
                return kernels_per_iteration(run, 1)
            with obs.run_scope({"phases?": False}):
                return kernels_per_iteration(run, 1)
        bprof = {}
        if dev.type == "cuda":
            bprof = {"unbound": one(False), "phases_off": one(True)}
            if bprof["unbound"][0] != bprof["phases_off"][0]:
                raise AssertionError(f"obs batch: launches {bprof}")
        out["batch"] = {
            "keys": len(pairs), "wall_s": bwall, "chunk_iters": 1,
            "gate_unplanned_batch_s": gate_batch_s, "heartbeats": len(hb),
            "compactions": hb[-1]["compactions"],
            "iterations": max(r.get("iterations") or 0 for r in res),
            "first_iteration": {k: {"kernels": v[0], "wall_s": v[1]}
                                for k, v in bprof.items()}}

        # (c) the default gate: the device racer's heartbeats stay in
        # its run's registry
        hist = simulate.random_history(random.Random(45100), model, 64,
                                       n_ops, crash_p)
        test_a = {"certify?": False}
        rollout.launches = 0
        with obs.run_scope(test_a):
            t0 = time.monotonic()
            r = core.check(checkers.linearizable({"model": model}), test_a,
                           hist)
            cwall = time.monotonic() - t0
        test_b = {}
        with obs.run_scope(test_b):
            races = checkers.join_racers()
        launches["obs"] += rollout.launches
        reg_a, reg_b = test_a["obs"]["registry"], test_b["obs"]["registry"]
        chunks = reg_a.counter_value("wgl.chunks", engine="jax-wgl")
        if r["valid"] is not True or chunks < 1:
            raise AssertionError(f"obs competition: {r['valid']!r}, "
                                 f"{chunks} device chunks in the run")
        if reg_b.snapshot() != {"counters": {}, "gauges": {},
                                "histograms": {}} \
                or test_b["obs"]["tracer"].events():
            raise AssertionError("obs competition: the race wrote into the "
                                 "next step's sinks")
        out["competition"] = {
            "winner": r["engine"], "wall_s": cwall,
            "device_chunks": chunks,
            "device_racer_wall_s": races[-1]["racers"]["jax-wgl"]["wall_s"],
            "wins": {k: v for k, v in reg_a.snapshot()["counters"].items()
                     if k.startswith("checker.competition_wins")}}

        # (d) the failure render and the store
        i = next(j for j, row in enumerate(trial_rows)
                 if row["valid"] is False)
        caught = []

        class Catch(logging.Handler):
            def emit(self, record):
                caught.append(record)

        log = logging.getLogger("jepsen_tpu_torch.checker.checkers")
        handler = Catch(logging.WARNING)
        log.addHandler(handler)
        test = {"name": "obs-render", "start-time": store.local_time(),
                "certify?": False}
        hist = keyed_history([trials[i]])
        rollout.launches = 0
        try:
            with obs.run_scope(test):
                r = core.check_safe(independent.checker(
                    checkers.linearizable({"model": "cas-register",
                                           "algorithm": "wgl"})),
                    test, hist)
        finally:
            log.removeHandler(handler)
        launches["obs"] += rollout.launches
        if r["valid"] is not False or r["results"][0]["valid"] is not False:
            raise AssertionError(f"obs render: trial {i} decided "
                                 f"{r['valid']!r}, phase 4 False: "
                                 f"{r.get('error')}")
        png = store.path(test, independent.DIR, 0, "linear.png")
        import importlib.util
        have_mpl = importlib.util.find_spec("matplotlib") is not None
        if have_mpl:
            if caught or not os.path.exists(png):
                raise AssertionError(f"obs render: {caught}, {png}")
        else:
            if os.path.exists(png) or len(caught) != 1 \
                    or caught[0].exc_info is None \
                    or not isinstance(caught[0].exc_info[1],
                                      ModuleNotFoundError) \
                    or caught[0].exc_info[1].name != "matplotlib":
                raise AssertionError(f"obs render: contained "
                                     f"{[c.exc_info for c in caught]}")
        test["results"], test["history"] = r, hist
        store.write_test(test)
        store.write_results(test)
        store.write_history(test)
        store.write_obs(test, final=True)
        back = store.load(test["name"], test["start-time"])

        def as_json(x):
            return json.loads(json.dumps(x, cls=store._Encoder))
        if back["results"] != as_json(r) or back["history"] != as_json(hist):
            raise AssertionError("obs store: results or history read back "
                                 "differ")
        out["render"] = {
            "trial": i, "valid": False, "matplotlib": have_mpl,
            "linear_png": os.path.exists(png),
            "contained": [type(c.exc_info[1]).__name__ for c in caught
                          if c.exc_info],
            "store_files": sorted(os.listdir(store.path(test)))}
    finally:
        shutil.rmtree(store.base_dir, ignore_errors=True)
        store.base_dir = base
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t_start
    return out


def mesh_phase(dev, main_rows, trials, trial_rows, keys, gate_verdicts,
               gate_planned, n_ops=10_000, gate_keys=GATE_KEYS):
    """The multi-device search over ``torch.distributed`` at world size 1
    (the one card: NCCL on CUDA, gloo for a rehearsal on the CPU), on a
    1-D ``DeviceMesh``. (a) The two main-path histories through
    the checker with ``linearizable(jax-wgl, {"mesh": mesh})``, timed as
    phase 3 timed the flat one, then through ``core.check``: valid, the
    certificate clean, iterations, explored configs and rollout launches
    equal to phase 3's flat runs (``main_rows``), and collective calls
    per iteration. (b) The six ``invalid`` trials through the same
    gate: phase 4's verdicts (the CPU oracle's), every witness certified
    clean (the gate phase ran their differentials).
    (c) The first ``gate_keys`` batch keys through
    ``independent.checker`` with the mesh at ``chunk_iters=1``, planned
    and unplanned: per-key verdicts equal to the gate's
    (``gate_verdicts``), the walls beside the gate's unmeshed ones
    (``gate_planned``); the batch paths launch no rollout kernel. (d) A
    2-D (1, 1) mesh is refused with ValueError. The process group is
    torn down at the end."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from jepsen_tpu_torch import independent, simulate
    from jepsen_tpu_torch.checker import checkers, core, rollout, torch_wgl
    from jepsen_tpu_torch.parallel import check_encoded_sharded
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    kw = {"device_id": torch.device("cuda", torch.cuda.current_device())} \
        if cuda else {}
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **kw)
    out = {"phase": "mesh", "backend": dist.get_backend(), "world_size": 1}
    try:
        mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("search",))
        flat = {r["model"]: r for r in main_rows if r["rollout"] == "kernel"}
        launches = 0

        def gate(**opts):
            return checkers.linearizable(
                {"model": "cas-register", "algorithm": "jax-wgl",
                 "engine_opts": {"mesh": mesh, **opts}})

        # (a) the main-path histories, sharded at world size 1
        rows = []
        with Certified(dev) as cert:
            for model, crash_p in MAIN_HISTORIES:
                hist = simulate.random_history(random.Random(45100), model,
                                               64, n_ops, crash_p)
                test = {"certify": dict(GATE_CERTIFY)}
                chk = checkers.linearizable(
                    {"model": model, "algorithm": "jax-wgl",
                     "engine_opts": {"mesh": mesh}})
                # the checker alone, as phase 3 timed the flat one
                rollout.launches = 0
                torch_wgl.collective_calls = 0
                t0 = time.monotonic()
                r = chk.check({}, hist)
                sync(dev)
                check_s = time.monotonic() - t0
                calls = torch_wgl.collective_calls
                got = {"valid": r["valid"], "engine": r.get("engine"),
                       "iterations": r.get("iterations"),
                       "configs_explored": r.get("configs_explored"),
                       "rollout_launches": rollout.launches}
                # then through core.check: lint, plan report, certificate
                rollout.launches = 0
                t0 = time.monotonic()
                rc = core.check(chk, test, hist)
                wall = time.monotonic() - t0
                run = cert.runs[-1]
                if (rc["valid"], rc.get("iterations"),
                        run["launches_before"]) != (
                        got["valid"], got["iterations"],
                        got["rollout_launches"]):
                    raise AssertionError(f"mesh {model}: core.check "
                                         f"{rc['valid']!r} differs from "
                                         f"the checker's run")
                want = {"valid": True, "engine": "jax-wgl-sharded",
                        "iterations": flat[model]["iterations"],
                        "configs_explored":
                            flat[model]["configs_explored"],
                        "rollout_launches":
                            flat[model]["rollout_launches"]}
                if got != want or (cuda and got["rollout_launches"] <= 0):
                    raise AssertionError(f"mesh {model}: {got} != flat "
                                         f"{want}")
                launches += got["rollout_launches"]
                rows.append({
                    "model": model, **got, "shards": r["shards"],
                    "shard_explored": r["shard_explored"],
                    "check_s": check_s, "flat_wall_s": flat[model]["wall_s"],
                    "core_check_s": wall,
                    "collective_calls": calls,
                    "collectives_per_iteration": calls / got["iterations"],
                    "certify_s": run["certify_s"],
                    "certificate": certificate_clean(f"mesh {model}", test,
                                                     rc)})
            out["main"] = rows

            # (b) the six invalid trials through the mesh gate, their
            # witnesses certified (the gate phase ran their differentials)
            trows = []
            for i, hist in enumerate(trials):
                test = {"certify": dict(GATE_CERTIFY)}
                rollout.launches = 0
                t0 = time.monotonic()
                r = core.check(gate(), test, hist)
                wall = time.monotonic() - t0
                run = cert.runs[-1]
                if r["valid"] is not trial_rows[i]["valid"]:
                    raise AssertionError(f"mesh trial {i}: {r['valid']!r} "
                                         f"!= the CPU oracle's")
                launches += run["launches_before"]
                trows.append({"trial": i, "valid": r["valid"],
                              "engine": r.get("engine"),
                              "iterations": r.get("iterations"),
                              "rollout_launches": run["launches_before"],
                              "wall_s": wall,
                              "certify_s": run["certify_s"],
                              **certificate_clean(f"mesh trial {i}", test,
                                                  r)})
            out["invalid"] = trows

        # (c) the gate's keys through the mesh key batch
        hist = keyed_history(keys[:gate_keys])
        chk = independent.checker(gate(chunk_iters=1))
        batch = {}
        rollout.launches = 0
        for name, test in (("planned", {"certify?": False}),
                           ("unplanned", {"searchplan?": False,
                                          "certify?": False})):
            torch_wgl.collective_calls = 0
            t0 = time.monotonic()
            r = core.check(chk, test, hist)
            sync(dev)
            wall = time.monotonic() - t0
            verdicts = [r["results"][k]["valid"]
                        for k in range(len(gate_verdicts))]
            if verdicts != list(gate_verdicts):
                bad = [k for k, (g, w) in enumerate(zip(verdicts,
                                                        gate_verdicts))
                       if g != w]
                raise AssertionError(f"mesh batch ({name}): keys {bad} "
                                     f"differ from the gate's verdicts")
            batch[name] = {"wall_s": wall,
                           "unmeshed_wall_s": gate_planned[f"{name}_wall_s"],
                           "collective_calls": torch_wgl.collective_calls,
                           "failures": r["failures"]}
        out["batch"] = {"keys": gate_keys, **batch,
                        "rollout_launches": scan_only("mesh batch")}

        # (d) a mesh of any other shape is refused
        flat_mesh = init_device_mesh(dev.type, (1, 1),
                                     mesh_dim_names=("a", "b"))
        from jepsen_tpu_torch import models
        spec = models.cas_register_spec
        try:
            check_encoded_sharded(spec, *spec.encode(trials[0]), flat_mesh)
        except ValueError as err:
            out["two_d_refused"] = str(err)
        else:
            raise AssertionError("mesh: a 2-D mesh was not refused")
        out["launches"] = launches
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.monotonic() - t_start
    return out


#: the run phase (core.run on the card): (a) RUN_OPS client ops over
#: RUN_NODES nodes at RUN_CONCURRENCY workers, RUN_INFO_P of them left
#: indeterminate, the partitioner switching every RUN_NEMESIS_S seconds
#: RUN_NEMESIS_CYCLES times; (b) the register workload at per-key-limit
#: RUN_PER_KEY and RUN_KEYED_OPS ops (about 64 keys); (c) RUN_LOST_OPS
#: ops at concurrency RUN_LOST_CONCURRENCY, the second write of every
#: RUN_LOST_EVERY dropped, the ops staggered RUN_LOST_STAGGER_S apart on
#: average: with all 16 workers busy, the proof that the history is
#: invalid must exhaust the orders of the ~15 reads in flight at each
#: point before the violation (264,419 configs in one CPU rehearsal, and
#: the CPU oracle did not finish), against 30-1,844 configs in five
#: rehearsals at this stagger; (d) a hard limit of RUN_SALVAGE_S on an
#: endless generator
RUN_NODES = ["n1", "n2", "n3", "n4", "n5"]
RUN_OPS, RUN_CONCURRENCY, RUN_INFO_P = 10_000, 64, 0.05
#: each op of (a) and (d) sleeps this long before it applies: long
#: enough that every worker is busy at the interpreter's rate
RUN_OP_S = 0.04
RUN_NEMESIS_S, RUN_NEMESIS_CYCLES = 0.5, 3
RUN_PER_KEY, RUN_KEYED_OPS, RUN_KEYED_CONCURRENCY = 200, 12_800, 40
RUN_LOST_OPS, RUN_LOST_CONCURRENCY, RUN_LOST_EVERY = 2_000, 16, 50
RUN_LOST_STAGGER_S = 0.002
RUN_SALVAGE_S = 1.0


def errors_in(x, path="results"):
    """Paths of every ``error`` key in a results tree: a run must not hide
    a device fault behind ``check_safe``'s "unknown". A certificate's
    ``counts`` (findings by severity) are not errors."""
    if isinstance(x, dict):
        return [f"{path}.error" for k in x if k == "error"] + [
            p for k, v in x.items() if k != "counts"
            for p in errors_in(v, f"{path}.{k}")]
    if isinstance(x, (list, tuple)):
        return [p for i, v in enumerate(x)
                for p in errors_in(v, f"{path}[{i}]")]
    return []


def run_clients():
    """The run phase's clients, over the port's ``tests.Atom``. Imported
    lazily: ``jepsen_tpu_torch`` is found beside this script only once
    ``main`` has put the checkout on ``sys.path``."""
    import threading
    from jepsen_tpu_torch import client, independent
    from jepsen_tpu_torch import tests as tst

    class IndeterminateClient(tst.AtomClient):
        """The cas-register atom client, except that a seeded ``info_p``
        of its ops apply and then complete as ``info``, and that its ops
        take effect in the order the history records their completions,
        as the main-path histories' ops do. An op sleeps ``RUN_OP_S``,
        then applies once the previous op's completion is recorded:
        ``recorded``, the run's op sink, hands the turn on. Without the
        turn, two threads can apply in one order and reach the history
        in the other; with 1 ms ops, the interpreter's ~1,500 ops/s keep
        only ~2 of 64 workers busy. Either way the 5% of ops left open
        for ever make the search's greedy chains take a later write for
        an open one's effect: such 10,000-op runs took 916-5,498
        iterations on the card, or stayed unknown after 60 s (PERF.md
        §6), against 7 for the main-path history."""

        def __init__(self, state, rng, info_p, turn=None, meta_log=None):
            super().__init__(state, meta_log)
            self.rng, self.info_p = rng, info_p
            self.turn = turn if turn is not None else threading.Lock()

        def open(self, test, node):
            return IndeterminateClient(self.state, self.rng, self.info_p,
                                       self.turn, self.meta_log)

        def recorded(self, op):
            # an info the interpreter writes off at an abort never took
            # the turn: release only a turn that is held
            if isinstance(op.get("process"), int) \
                    and op["type"] != "invoke" and self.turn.locked():
                self.turn.release()

        def invoke(self, test, op):
            time.sleep(RUN_OP_S)
            self.turn.acquire()
            out = dict(op, type="ok")
            if op["f"] == "write":
                self.state.reset(op["value"])
            elif op["f"] == "cas":
                if not self.state.compare_and_set(*op["value"]):
                    out["type"] = "fail"
            else:
                out["value"] = self.state.deref()
            if self.rng.random() < self.info_p:
                out = dict(op, type="info", error="indeterminate")
            return out

    class KeyedAtomClient(client.Client):
        """One atom register per key (``[k v]`` values)."""

        def __init__(self, registers=None):
            self.registers = registers if registers is not None else {}

        def open(self, test, node):
            return KeyedAtomClient(self.registers)

        def invoke(self, test, op):
            k, v = op["value"]
            reg = self.registers.setdefault(k, tst.Atom(None))
            if op["f"] == "read":
                return dict(op, type="ok",
                            value=independent.tuple_(k, reg.deref()))
            if op["f"] == "write":
                reg.reset(v)
                return dict(op, type="ok")
            return dict(op, type="ok" if reg.compare_and_set(*v)
                        else "fail")

    class LostWriteClient(client.Client):
        """A register that drops the second write of every ``every`` yet
        answers ok (not the first: a read of the initial None is a
        wildcard to the model). Every op takes effect as it starts and
        then sleeps 1 ms, so ops take effect in the order they return.
        The run gives the writes to one thread, which pauses between
        them: a dropped write is then never concurrent with the write
        that set the value the reads after it return, and no
        linearization can order it before that write."""

        def __init__(self, state, every, counter=None):
            self.state, self.every = state, every
            self.counter = counter if counter is not None \
                else tst.Atom(0)

        def open(self, test, node):
            return LostWriteClient(self.state, self.every, self.counter)

        def invoke(self, test, op):
            out = dict(op, type="ok")
            if op["f"] == "read":
                out["value"] = self.state.deref()
            elif self.counter.swap(lambda x: x + 1) % self.every != 2:
                self.state.reset(op["value"])
            time.sleep(0.001)
            return out

    return IndeterminateClient, KeyedAtomClient, LostWriteClient


def run_spans(test):
    """Seconds of the run's ``run-case``, ``analyze`` and preflight
    (``analysis.planlint``) spans and of its checker's (the Linearizable
    gate's where the test composes it, else the test's checker's), from
    its ``trace.jsonl``."""
    from jepsen_tpu_torch import obs, store
    evs = obs.load_trace(os.path.join(store.path(test), "trace.jsonl"))
    spans = {}
    for e in evs:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
    top = f"checker.{type(test['checker']).__name__}"
    checker = "checker.Linearizable" if "checker.Linearizable" in spans \
        else top
    for name in ("run-case", "analyze", "analysis.planlint", checker):
        if name not in spans:
            raise AssertionError(f"run: no {name} span in the trace")
    return {"run_case_s": spans["run-case"], "analyze_s": spans["analyze"],
            "checker_s": spans[checker], "checker_span": checker,
            "preflight_s": spans["analysis.planlint"]}


def run_phase(dev, n_ops=RUN_OPS, keyed_ops=RUN_KEYED_OPS,
              lost_ops=RUN_LOST_OPS, salvage_s=RUN_SALVAGE_S):
    """``core.run`` end to end on the card, with ``ssh={"dummy?": True}``
    and each test's store in a temporary directory. (a) A cas-register
    run: ``n_ops`` client ops (read, write, cas) over five nodes at 64
    workers, 5% of them left indeterminate by the client, the
    ``partition_random_halves`` nemesis switching every 0.5 s, checked
    by ``compose({linearizable(jax-wgl), timeline.html()})``: valid, no
    ``error`` in the results, the rollout kernel launched, 2 x
    ``n_ops`` client entries beside the nemesis's, the history, results
    and timeline in the store, partition commands in the dummy log.
    (b) The register workload (``tests/linearizable_register.py``) at
    its defaults ("competition") with a keyed atom client, per-key-limit
    200 and ``keyed_ops`` ops: every key valid. (c) ``lost_ops`` ops
    against a register that drops 1 write in 50 yet answers ok: the
    verdict False and equal to the CPU oracle's, the failure render
    (with matplotlib) or its containment (without). (d) A hard
    ``time-limit-s`` of ``salvage_s`` on an endless generator: the
    history salvaged, checked on the card to a definite verdict with no
    error, and no journal left behind. Each case's rollout launches are
    counted from 0. Certification is the gate phase's: the run's tests
    opt out of it (at 10k ops its CPU replays take minutes, ROADMAP.md
    C.2)."""
    import importlib.util
    import itertools
    import logging
    import shutil
    import tempfile
    from jepsen_tpu_torch import core, independent, nemesis, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import tests as tst
    from jepsen_tpu_torch.checker import checkers, rollout, timeline
    from jepsen_tpu_torch.checker import core as ccore
    from jepsen_tpu_torch.tests import linearizable_register
    IndeterminateClient, KeyedAtomClient, LostWriteClient = run_clients()
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    engine_opts = {} if cuda else {"device": "cpu"}
    base = store.base_dir
    store.base_dir = tempfile.mkdtemp(prefix="jepsen-run-")
    out = {"phase": "run"}
    launches = {}

    def lin():
        return checkers.linearizable({"model": "cas-register",
                                      "algorithm": "jax-wgl",
                                      "engine_opts": engine_opts})

    def register_mix(rng):
        return gen.mix([
            lambda: {"f": "read"},
            lambda: {"f": "write", "value": rng.randint(0, 4)},
            lambda: {"f": "cas",
                     "value": [rng.randint(0, 4), rng.randint(0, 4)]}])

    def run(path, t):
        t = {**tst.noop_test(), "ssh": {"dummy?": True},
             "certify?": False, **t}
        rollout.launches = 0
        t0 = time.monotonic()
        test = core.run(t)
        sync(dev)
        wall = time.monotonic() - t0
        # a keyed run's per-key races may leave losers running: wait for
        # them, so none launches into a later path's count
        checkers.join_racers()
        launches[path] = rollout.launches
        errs = errors_in(test["results"])
        if errs:
            raise AssertionError(f"run {t['name']}: {errs}: "
                                 f"{test['results']}")
        return test, {"wall_s": wall, "rollout_launches": rollout.launches,
                      **run_spans(test)}

    def segments(lr):
        """The searches a Linearizable verdict ran: one flat search, or
        the planner's segments, which ride the key batch and so roll on
        the scan, not the rollout kernel."""
        return (lr.get("searchplan") or {}).get("segments", 1)

    def need_launches(what, path, lr):
        """A flat device search that iterated must have launched the
        rollout kernel (on the card)."""
        if cuda and segments(lr) == 1 and (lr.get("iterations") or 0) > 0 \
                and launches[path] <= 0:
            raise AssertionError(f"run {what}: the rollout kernel was "
                                 f"never launched")

    try:
        # (a) the main-path shape, recorded live
        rng = random.Random(45100)
        nem_gen = [g for _ in range(RUN_NEMESIS_CYCLES) for g in (
            gen.sleep(RUN_NEMESIS_S), {"type": "info", "f": "start"},
            gen.sleep(RUN_NEMESIS_S), {"type": "info", "f": "stop"})]
        register = IndeterminateClient(tst.Atom(None), random.Random(45101),
                                       RUN_INFO_P)
        test, row = run("run", {
            "name": "run-register", "nodes": RUN_NODES,
            "concurrency": RUN_CONCURRENCY, "client": register,
            "op-sinks": [register.recorded],
            "nemesis": nemesis.partition_random_halves(),
            "generator": gen.nemesis(
                nem_gen, gen.clients(gen.limit(n_ops, register_mix(rng)))),
            "checker": ccore.compose({"linearizable": lin(),
                                      "timeline": timeline.html()})})
        r, hist = test["results"], test["history"]
        client_ops = [o for o in hist if isinstance(o["process"], int)]
        nem_ops = [o for o in hist if o["process"] == "nemesis"]
        lr = r["linearizable"]
        if r["valid"] is not True or lr["valid"] is not True:
            raise AssertionError(f"run register: decided {r['valid']!r}")
        if cuda and launches["run"] <= 0:
            raise AssertionError(f"run register: the rollout kernel was "
                                 f"never launched ({segments(lr)} "
                                 f"segments, {lr.get('iterations')} "
                                 f"iterations)")
        if len(client_ops) != 2 * n_ops or \
                len(nem_ops) != 4 * RUN_NEMESIS_CYCLES:
            raise AssertionError(f"run register: {len(client_ops)} client "
                                 f"and {len(nem_ops)} nemesis entries")
        files = set(os.listdir(store.path(test)))
        if not {"history.jsonl", "history.txt", "results.json",
                "timeline.html"} <= files:
            raise AssertionError(f"run register: store holds {files}")
        cmds = [cmd for _, cmd in test.get("dummy-log", [])]
        drops = sum("iptables -A INPUT" in cmd for cmd in cmds)
        if not drops or not any("iptables -F" in cmd for cmd in cmds):
            raise AssertionError("run register: no partition commands in "
                                 "the dummy log")
        span_s = (max(o["time"] for o in client_ops)
                  - min(o["time"] for o in client_ops)) / 1e9
        out["register"] = {
            **row, "valid": True, "client_entries": len(client_ops),
            "client_span_s": span_s,
            "interpreter_ops_per_s": n_ops / span_s,
            "nemesis_entries": len(nem_ops),
            "info_ops": sum(o["type"] == "info" for o in client_ops),
            "iterations": lr.get("iterations"), "segments": segments(lr),
            "partition_drop_commands": drops, "store_files": sorted(files)}

        # (b) the register workload at its defaults, keyed
        workload = linearizable_register.test({
            "nodes": RUN_NODES, "per-key-limit": RUN_PER_KEY,
            "engine_opts": engine_opts})
        test, row = run("run_keyed", {
            "name": "run-keyed", "nodes": RUN_NODES,
            "concurrency": RUN_KEYED_CONCURRENCY,
            "client": KeyedAtomClient(),
            "generator": gen.limit(keyed_ops, workload["generator"]),
            "checker": workload["checker"]})
        r = test["results"]
        bad = [k for k, kr in r["results"].items()
               if kr["valid"] is not True]
        if r["valid"] is not True or bad:
            raise AssertionError(f"run keyed: decided {r['valid']!r}, "
                                 f"keys {bad}")
        per_key = sorted(os.listdir(store.path(test, independent.DIR)))
        if len(per_key) != len(r["results"]):
            raise AssertionError(f"run keyed: {len(per_key)} key "
                                 f"directories, {len(r['results'])} keys")
        out["keyed"] = {**row, "valid": True, "keys": len(r["results"]),
                        "history_entries": len(test["history"])}

        # (c) lost writes: invalid, as the CPU oracle decides
        values = itertools.count(1)
        caught = []

        class Catch(logging.Handler):
            def emit(self, record):
                caught.append(record)

        log = logging.getLogger("jepsen_tpu_torch.checker.checkers")
        handler = Catch(logging.WARNING)
        log.addHandler(handler)
        try:
            test, row = run("run_invalid", {
                "name": "run-lost-write", "nodes": RUN_NODES,
                "concurrency": RUN_LOST_CONCURRENCY,
                "client": LostWriteClient(tst.Atom(None), RUN_LOST_EVERY),
                "generator": gen.clients(gen.limit(lost_ops, gen.stagger(
                    RUN_LOST_STAGGER_S, gen.reserve(
                        1, gen.cycle(gen.once(
                            lambda: {"f": "write", "value": next(values)}),
                            gen.sleep(0.001)),
                        gen.repeat({"f": "read"}))))),
                "checker": lin()})
        finally:
            log.removeHandler(handler)
        r, hist = test["results"], test["history"]
        client_ops = [o for o in hist if isinstance(o["process"], int)]
        t0 = time.monotonic()
        want = oracle_verdict(client_ops)
        oracle_s = time.monotonic() - t0
        if r["valid"] is not False or want is not False:
            raise AssertionError(f"run lost-write: decided {r['valid']!r}, "
                                 f"the CPU oracle {want!r}")
        need_launches("lost-write", "run_invalid", r)
        png = store.path(test, "linear.png")
        have_mpl = importlib.util.find_spec("matplotlib") is not None
        if have_mpl != os.path.exists(png) or (not have_mpl and (
                len(caught) != 1 or caught[0].exc_info is None
                or getattr(caught[0].exc_info[1], "name", None)
                != "matplotlib")):
            raise AssertionError(f"run lost-write: linear.png "
                                 f"{os.path.exists(png)} with matplotlib "
                                 f"{have_mpl}; contained "
                                 f"{[c.exc_info for c in caught]}")
        writes = sum(o["f"] == "write" and o["type"] == "ok"
                     for o in client_ops)
        out["lost_write"] = {
            **row, "valid": False, "oracle_valid": want,
            "oracle_s": oracle_s, "ok_writes": writes,
            "segments": segments(r), "iterations": r.get("iterations"),
            "dropped_writes": (writes + RUN_LOST_EVERY - 2) // RUN_LOST_EVERY,
            "witness_op": r.get("op", {}).get("index"),
            "matplotlib": have_mpl, "linear_png": os.path.exists(png),
            "contained": [type(c.exc_info[1]).__name__ for c in caught
                          if c.exc_info]}

        # (d) a hard time limit: the partial history is salvaged and checked
        rng = random.Random(45102)
        salvaged = IndeterminateClient(tst.Atom(None), rng, 0.0)
        test, row = run("run_salvage", {
            "name": "run-salvage", "nodes": RUN_NODES,
            "concurrency": RUN_LOST_CONCURRENCY, "client": salvaged,
            "op-sinks": [salvaged.recorded],
            "time-limit-s": salvage_s, "abort-grace-s": 1.0,
            "generator": gen.clients(register_mix(rng)),
            "checker": lin()})
        r = test["results"]
        if r.get("salvaged") is not True or r["valid"] not in (True, False):
            raise AssertionError(f"run salvage: salvaged "
                                 f"{r.get('salvaged')!r}, valid "
                                 f"{r['valid']!r}")
        need_launches("salvage", "run_salvage", r)
        if os.path.exists(store.path(test, store.JOURNAL_FILE)):
            raise AssertionError("run salvage: the journal was left behind")
        out["salvage"] = {**row, "valid": r["valid"], "salvaged": True,
                          "segments": segments(r),
                          "iterations": r.get("iterations"),
                          "abort_reason": r.get("abort-reason"),
                          "history_entries": len(test["history"])}
    finally:
        shutil.rmtree(store.base_dir, ignore_errors=True)
        store.base_dir = base
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t_start
    return out


#: the monitor phase: (a) at run (a)'s shape, the default engine at the
#: monitor's default chunk; (b) run (c)'s lost writes; (c) the streamlin
#: engine, whose StreamCheck costs ~0.02 s per event on the card
#: (PERF.md), on MONITOR_STREAM_OPS client ops at MONITOR_STREAM_WORKERS
#: workers (few ops in flight keep the frontier small), no op left open;
#: (d) half bench.py rung 15's txn count through the list-append workload at
#: 8 processes, checked every MONITOR_TXN_CHUNK completions; (e) its
#: stale-read copy, cut to MONITOR_BAD_TXNS txns and checked every
#: MONITOR_BAD_CHUNK completions, its txns taking MONITOR_BAD_TXN_S each,
#: so that the first check, which finds the first stale read, ends while
#: the run goes on (at the interpreter's rate the 2,048 txns take about
#: as long as that check, and the monitor saw the whole run)
MONITOR_BAD_TXN_S = 0.01
MONITOR_CHUNK, MONITOR_STREAM_CHUNK = 64, 8
MONITOR_STREAM_OPS, MONITOR_STREAM_WORKERS = 300, 8
#: the monitored list-append run, cut from 16,384 txns to 8,192 for the
#: fleet phase's room (its checks took 45.3 s of the phase)
MONITOR_TXNS, MONITOR_TXN_PROCS, MONITOR_TXN_CHUNK = 8_192, 8, 1024
MONITOR_BAD_TXNS, MONITOR_BAD_CHUNK, MONITOR_STALE_EVERY = 2048, 256, 50


def txn_clients():
    """The monitor phase's list-append client over an in-memory store:
    serializable (each txn applies under one lock). With ``stale_every``
    set, every ``stale_every``-th txn's reads omit the appends of the last
    txn that appended to each key they read (unless it is the reading
    txn): acknowledged appends which a later read omits while the reads
    after it see them again, a G-single cycle (the read's
    anti-dependency on the append the read missed, closed by the
    append's later observers). Each txn takes ``delay_s`` before it
    applies."""
    import threading
    from jepsen_tpu_torch import client

    class ListAppendClient(client.Client):
        def __init__(self, stale_every=0, delay_s=0.0, shared=None):
            self.stale_every, self.delay_s = stale_every, delay_s
            self.shared = shared if shared is not None else {
                "lists": {}, "last": {}, "txns": 0,
                "lock": threading.Lock()}

        def open(self, test, node):
            return ListAppendClient(self.stale_every, self.delay_s,
                                    self.shared)

        def invoke(self, test, op):
            time.sleep(self.delay_s)
            sh, out = self.shared, []
            with sh["lock"]:
                sh["txns"] += 1
                txn = sh["txns"]
                stale = self.stale_every and txn % self.stale_every == 0
                for f, k, v in op["value"]:
                    seen = sh["lists"].setdefault(k, [])
                    if f == "r":
                        writer, before = sh["last"].get(k, (txn, 0))
                        out.append([f, k, list(
                            seen[:before] if stale and writer != txn
                            else seen)])
                    else:
                        if sh["last"].get(k, (None,))[0] != txn:
                            sh["last"][k] = (txn, len(seen))
                        seen.append(v)
                        out.append([f, k, v])
            return dict(op, type="ok", value=out)

    return ListAppendClient


def monitor_check_stats(test):
    """Seconds of a run's monitor checks: from each ``monitor.check``
    span of its ``trace.jsonl`` (the WGL monitor), else from the
    ``monitor.check_s`` histogram of its ``metrics.json`` (the txn
    monitor traces no span; the median is then the bound of the bucket
    that holds it)."""
    from jepsen_tpu_torch import obs, store
    from jepsen_tpu_torch.obs import metrics
    evs = obs.load_trace(os.path.join(store.path(test), "trace.jsonl"))
    spans = sorted(e["dur"] / 1e6 for e in evs
                   if e.get("ph") == "X" and e["name"] == "monitor.check")
    if spans:
        return {"check_s_median": spans[len(spans) // 2],
                "check_s_max": spans[-1], "check_s_sum": sum(spans),
                "check_s_from": "trace"}
    with open(os.path.join(store.path(test), "metrics.json")) as f:
        hists = json.load(f)["histograms"]
    (h,) = [v for k, v in hists.items()
            if metrics.parse_flat_key(k)[0] == "monitor.check_s"]
    seen = 0
    for bound, c in zip(h["buckets_le"] + [h["max"]], h["counts"]):
        seen += c
        if c and seen >= h["count"] / 2:
            break
    return {"check_s_median": min(bound, h["max"]), "check_s_max": h["max"],
            "check_s_sum": h["sum"], "check_s_from": "metrics"}


def monitor_phase(dev, unmonitored_ops_per_s, n_ops=RUN_OPS,
                  lost_ops=RUN_LOST_OPS, stream_ops=MONITOR_STREAM_OPS,
                  txns=MONITOR_TXNS, bad_txns=MONITOR_BAD_TXNS):
    """Monitored runs (``test["monitor"]``) through ``core.run`` on the
    card, with run_phase's harness: ``ssh={"dummy?": True}``, each test's
    store in a temporary directory, run_phase's clients and checker
    (``linearizable(jax-wgl)``). (a) Run (a)'s register run with
    ``{"chunk": 64}`` (the monitor's default engine, "jax-wgl": the flat
    search with the rollout kernel): the monitor's verdict True and equal to the offline one,
    ``monitor.json`` in the store, rollout launches by the monitor's
    checks (counted until ``analyze`` starts) > 0; the interpreter's
    client ops/s beside ``unmonitored_ops_per_s``, run (a)'s in this
    process. (b) Run (c)'s lost writes: aborted with "monitor-violation",
    the offline verdict on the salvaged history False and equal to the
    CPU oracle's, the monitor's evidence certified (the cross-check
    confirms, no VC error); again with ``skip-offline?``: ``monitor-only``
    False, certified. (c) The "streamlin" engine at chunk 8, unkeyed, on
    a clean run and a lost-write run of ``stream_ops`` ops: each verdict
    equal to the CPU oracle's on the recorded history, no fall-back.
    (d) ``tests/cycle/append`` with its ``txn_generator`` against a
    serializable list-append client, ``txns`` txns at 8 processes,
    ``{"family": "txn", "chunk": 1024}``: the monitor's verdict True and
    equal to the offline ``cycle.append`` verdict. (e) The stale-read
    client, ``bad_txns`` txns of 10 ms, checked every 256 completions:
    aborted
    with "monitor-violation", the
    offline verdict on the salvaged history False with the monitor's
    anomaly classes among its own (a class's -realtime variant counts as
    the class), the cycle witness certified (no VC013).
    Each case's rollout launches are counted from 0; the txn cases' must
    stay 0."""
    import itertools
    import shutil
    import tempfile
    from jepsen_tpu_torch import core, cycle, nemesis, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import tests as tst
    from jepsen_tpu_torch.checker import checkers, rollout
    from jepsen_tpu_torch.tests.cycle import append as append_workload
    IndeterminateClient, _, LostWriteClient = run_clients()
    ListAppendClient = txn_clients()
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    engine_opts = {} if cuda else {"device": "cpu"}
    base = store.base_dir
    store.base_dir = tempfile.mkdtemp(prefix="jepsen-monitor-")
    out = {"phase": "monitor"}
    launches = {}
    at_analyze = {}
    real_analyze = core.analyze

    def analyze(test):
        # what the monitor launched: the count when the run hands over
        # to the offline check
        sync(dev)
        at_analyze.update(launches=rollout.launches,
                          closure_s=cycle.closure_busy_s())
        return real_analyze(test)

    def lin():
        return checkers.linearizable({"model": "cas-register",
                                      "algorithm": "jax-wgl",
                                      "engine_opts": engine_opts})

    def run(path, t):
        t = {**tst.noop_test(), "ssh": {"dummy?": True}, "certify?": False,
             **t}
        t["monitor"] = dict(t["monitor"], **({"engine-opts": engine_opts}
                                             if not cuda else {}))
        rollout.launches = 0
        at_analyze.clear()
        t0 = time.monotonic()
        test = core.run(t)
        sync(dev)
        wall = time.monotonic() - t0
        checkers.join_racers()
        launches[path] = rollout.launches
        errs = errors_in(test["results"])
        if errs:
            raise AssertionError(f"monitor {t['name']}: {errs}: "
                                 f"{test['results']}")
        mon = test["results"].get("monitor")
        if not isinstance(mon, dict):
            raise AssertionError(f"monitor {t['name']}: no monitor block")
        if not os.path.exists(store.path(test, "monitor.json")):
            raise AssertionError(f"monitor {t['name']}: no monitor.json")
        return test, mon, {
            "wall_s": wall, "rollout_launches": rollout.launches,
            "monitor_rollout_launches": at_analyze.get("launches"),
            "checks": mon["checks"], "chunks": mon["chunks"],
            "ops_consumed": mon["ops_consumed"],
            "time_to_first_verdict_s": mon["time_to_first_verdict_s"],
            **monitor_check_stats(test)}

    def client_rate(hist):
        """Completed client ops over the client ops' span of history
        time (run (a)'s interpreter rate, for a run that may stop early)."""
        ops = [o for o in hist if isinstance(o["process"], int)]
        span = (max(o["time"] for o in ops)
                - min(o["time"] for o in ops)) / 1e9
        return sum(o["type"] != "invoke" for o in ops) / span

    def violation(what, test, mon, aborted=True):
        """The violation's record; the run aborted by the monitor unless
        ``aborted`` is False (its last check may come at the final
        flush), the evidence certified either way."""
        r = test["results"]
        if mon["verdict"] is not False or (aborted and (
                r.get("abort-reason") != "monitor-violation"
                or not r.get("salvaged"))):
            raise AssertionError(f"monitor {what}: abort "
                                 f"{r.get('abort-reason')!r}, monitor "
                                 f"{mon['verdict']!r}")
        cert = r.get("monitor-certification") or {}
        summary = (test.get("analysis") or {}).get("certify-monitor") or {}
        if cert.get("confirmed") is not True \
                or (cert.get("counts") or {}).get("error"):
            raise AssertionError(f"monitor {what}: certification {cert}")
        return {"aborted": r.get("abort-reason") == "monitor-violation",
                "detected_at_index": mon["detected_at_index"],
                "detection_latency_s": mon["detection_latency_s"],
                "checked_ops": mon["checked_ops"],
                "certification": cert,
                "cross_checks": [c for c in summary.get("checks", [])
                                 if c["name"] in ("cross-check",
                                                  "cycle-witness")]}

    core.analyze = analyze
    try:
        # (a) run (a)'s shape, monitored by the default engine
        rng = random.Random(45100)
        nem_gen = [g for _ in range(RUN_NEMESIS_CYCLES) for g in (
            gen.sleep(RUN_NEMESIS_S), {"type": "info", "f": "start"},
            gen.sleep(RUN_NEMESIS_S), {"type": "info", "f": "stop"})]
        register = IndeterminateClient(tst.Atom(None), random.Random(45101),
                                       RUN_INFO_P)
        mix = [lambda: {"f": "read"},
               lambda: {"f": "write", "value": rng.randint(0, 4)},
               lambda: {"f": "cas",
                        "value": [rng.randint(0, 4), rng.randint(0, 4)]}]
        test, mon, row = run("monitor", {
            "name": "monitor-register", "nodes": RUN_NODES,
            "concurrency": RUN_CONCURRENCY, "client": register,
            "op-sinks": [register.recorded],
            "monitor": {"chunk": MONITOR_CHUNK},
            "nemesis": nemesis.partition_random_halves(),
            "generator": gen.nemesis(
                nem_gen, gen.clients(gen.limit(n_ops, gen.mix(mix)))),
            "checker": lin()})
        r = test["results"]
        if r["valid"] is not True or mon["verdict"] is not True \
                or mon["engine"] != "jax-wgl":
            raise AssertionError(f"monitor register: offline "
                                 f"{r['valid']!r}, monitor "
                                 f"{mon['verdict']!r} ({mon['engine']})")
        if cuda and not row["monitor_rollout_launches"]:
            raise AssertionError("monitor register: the monitor's checks "
                                 "never launched the rollout kernel")
        rate = client_rate(test["history"])
        out["register"] = {
            **row, "valid": True, "monitor_verdict": True,
            "quiescent_truncated_ops": mon["quiescent_truncated_ops"],
            "interpreter_ops_per_s": rate,
            "unmonitored_ops_per_s": unmonitored_ops_per_s,
            "monitored_to_unmonitored": rate / unmonitored_ops_per_s}

        # (b) lost writes: the monitor aborts the run
        def lost_write_run(name, monitor, ops=lost_ops):
            values = itertools.count(1)
            return run(name, {
                "name": f"monitor-{name}", "nodes": RUN_NODES,
                "concurrency": RUN_LOST_CONCURRENCY,
                "certify?": True, "certify": GATE_CERTIFY,
                "client": LostWriteClient(tst.Atom(None), RUN_LOST_EVERY),
                "monitor": monitor,
                "generator": gen.clients(gen.limit(ops, gen.stagger(
                    RUN_LOST_STAGGER_S, gen.reserve(
                        1, gen.cycle(gen.once(
                            lambda: {"f": "write", "value": next(values)}),
                            gen.sleep(0.001)),
                        gen.repeat({"f": "read"}))))),
                "checker": lin()})

        test, mon, row = lost_write_run("monitor_violation",
                                        {"chunk": MONITOR_CHUNK})
        client_ops = [o for o in test["history"]
                      if isinstance(o["process"], int)]
        want = oracle_verdict(client_ops)
        if test["results"]["valid"] is not False or want is not False:
            raise AssertionError(f"monitor lost-write: offline "
                                 f"{test['results']['valid']!r}, the CPU "
                                 f"oracle {want!r}")
        out["lost_write"] = {**row, **violation("lost-write", test, mon),
                             "valid": False, "oracle_valid": want,
                             "history_entries": len(test["history"])}
        test, mon, row = lost_write_run(
            "monitor_skip_offline",
            {"chunk": MONITOR_CHUNK, "skip-offline?": True})
        r = test["results"]
        client_ops = [o for o in test["history"]
                      if isinstance(o["process"], int)]
        if r.get("monitor-only") is not True or r["valid"] is not False:
            writes = sum(o["f"] == "write" and o["type"] == "ok"
                         for o in client_ops)
            raise AssertionError(f"monitor skip-offline: {r}; the CPU "
                                 f"oracle {oracle_verdict(client_ops)!r} "
                                 f"on {len(client_ops)} entries with "
                                 f"{writes} ok writes")
        out["skip_offline"] = {**row, **violation("skip-offline", test,
                                                  mon),
                               "valid": False, "monitor_only": True}

        # (c) the streamlin engine, unkeyed
        rng = random.Random(45102)
        clean = IndeterminateClient(tst.Atom(None), random.Random(45103),
                                    0.0)
        stream = {"engine": "streamlin", "chunk": MONITOR_STREAM_CHUNK}
        mix = [lambda: {"f": "read"},
               lambda: {"f": "write", "value": rng.randint(0, 4)},
               lambda: {"f": "cas",
                        "value": [rng.randint(0, 4), rng.randint(0, 4)]}]
        test, mon, row = run("monitor_streamlin", {
            "name": "monitor-streamlin", "nodes": RUN_NODES,
            "concurrency": MONITOR_STREAM_WORKERS, "client": clean,
            "op-sinks": [clean.recorded], "monitor": stream,
            "generator": gen.clients(gen.limit(stream_ops, gen.mix(mix))),
            "checker": lin()})
        rows = {}
        for what, (test, mon, row) in (
                ("clean", (test, mon, row)),
                ("lost_write", lost_write_run(
                    "monitor_streamlin_violation", stream,
                    ops=stream_ops))):
            client_ops = [o for o in test["history"]
                          if isinstance(o["process"], int)]
            want = oracle_verdict(client_ops)
            st = mon.get("stream") or {}
            if mon["verdict"] is not want \
                    or test["results"]["valid"] is not want \
                    or "fallback" in st or st.get("flat_checks"):
                raise AssertionError(f"monitor streamlin {what}: monitor "
                                     f"{mon['verdict']!r}, offline "
                                     f"{test['results']['valid']!r}, the "
                                     f"CPU oracle {want!r}; stream {st}")
            events = mon["ops_consumed"]
            rows[what] = {**row, "valid": want, "oracle_valid": want,
                          "stream": st,
                          "check_s_per_event": row["check_s_sum"] / events}
            if want is False:
                rows[what].update(violation(f"streamlin {what}", test,
                                            mon, aborted=False))
        out["streamlin"] = rows

        # (d) the list-append workload, monitored by the txn family
        def append_run(name, n, chunk, stale_every=0, delay_s=0.0):
            random.seed(45104)
            w = append_workload.test({"device": engine_opts.get("device")})
            c0 = cycle.closure_busy_s()
            test, mon, row = run(name, {
                "name": f"monitor-{name}", "nodes": RUN_NODES,
                "concurrency": MONITOR_TXN_PROCS,
                "certify?": True,
                "client": ListAppendClient(stale_every, delay_s),
                "monitor": {"family": "txn", "chunk": chunk},
                "generator": gen.clients(gen.limit(n, w["generator"])),
                "checker": w["checker"]})
            row["monitor_closure_s"] = at_analyze["closure_s"] - c0
            row["closure_s"] = cycle.closure_busy_s() - c0
            row["txns_per_s"] = client_rate(test["history"])
            row["closure_rebuilds"] = mon["closure_rebuilds"]
            return test, mon, row

        test, mon, row = append_run("monitor_txn", txns, MONITOR_TXN_CHUNK)
        scan_only("monitor txn")
        r = test["results"]
        if r["valid"] is not True or mon["verdict"] is not True \
                or mon["txns"] != txns:
            raise AssertionError(f"monitor txn: offline {r['valid']!r}, "
                                 f"monitor {mon['verdict']!r} over "
                                 f"{mon['txns']} txns")
        out["txn"] = {**row, "valid": True, "txns": txns}

        # (e) the stale-read copy: a G-single cycle aborts the run
        test, mon, row = append_run("monitor_txn_violation", bad_txns,
                                    MONITOR_BAD_CHUNK, MONITOR_STALE_EVERY,
                                    MONITOR_BAD_TXN_S)
        scan_only("monitor txn violation")
        r = test["results"]

        def classes(types):
            # the Adya class, whatever edge closed its cycle: the
            # monitor's prefix may need an rt edge the whole history
            # does not
            return {t.replace("-realtime", "").replace("-process", "")
                    for t in types}

        if r["valid"] is not False or not mon["anomaly_types"] \
                or not classes(mon["anomaly_types"]) \
                <= classes(r["anomaly_types"]):
            raise AssertionError(f"monitor txn stale read: offline "
                                 f"{r['valid']!r} {r['anomaly_types']}, "
                                 f"monitor {mon['anomaly_types']}")
        out["txn_violation"] = {
            **row, **violation("txn stale read", test, mon),
            "valid": False, "anomaly_types": mon["anomaly_types"],
            "offline_anomaly_types": r["anomaly_types"]}
    finally:
        core.analyze = real_analyze
        shutil.rmtree(store.base_dir, ignore_errors=True)
        store.base_dir = base
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t_start
    return out


#: the cli phase: the port's entry points as a user runs them. (a) The
#: demo's register workload at the default 5 nodes and 10n workers (5
#: keys in flight), CLI_PER_KEY ops per key (the batch phase's key size)
#: for CLI_TIME_LIMIT s; (b) its dirty-read copy checked every
#: CLI_BUG_CHUNK completions, given CLI_BUG_TIME_LIMIT s to abort in (one
#: H100 run's monitor reported the first dirty read 7.75 s after it
#: landed, 9.8 s into a 10 s run; PERF.md); (d) the etcd stub past its
#: hard limit of CLI_HARD_LIMIT s; (e) the txn suite for
#: CLI_TXN_TIME_LIMIT s; (f) a profiled register run of
#: CLI_PROFILE_PER_KEY ops per key for CLI_PROFILE_TIME_LIMIT s
CLI_TIME_LIMIT, CLI_PER_KEY, CLI_BUG_CHUNK, CLI_BUG_TIME_LIMIT = \
    10, 200, 8, 30
CLI_HARD_LIMIT, CLI_TXN_TIME_LIMIT = 4, 8
CLI_PROFILE_PER_KEY, CLI_PROFILE_TIME_LIMIT = 50, 3


def cli_phase(dev, time_limit=CLI_TIME_LIMIT,
              txn_time_limit=CLI_TXN_TIME_LIMIT,
              profile_time_limit=CLI_PROFILE_TIME_LIMIT):
    """The port's command line on the card: ``jepsen_tpu_torch.__main__``
    and the suites' ``main(argv)`` called in process (``SystemExit``
    caught for the exit code, so the rollout kernel's launches can be
    counted from 0 around each run), each store in a temporary directory;
    run (d) is a real subprocess. (a) ``test --workload register --no-ssh
    --monitor --concurrency 10n --per-key-limit 200``: exit 0, valid, the
    monitor's verdict True, the store's files, rollout launches > 0 (the
    monitor's per-key checks run the single-key search). (b) The same
    with ``--bug dirty-read --monitor-chunk 8`` and a ``--time-limit`` of
    at least ``CLI_BUG_TIME_LIMIT``: exit 1, aborted by the monitor
    mid-run and salvaged, invalid, the monitor's verdict False
    at a numeric index, the offline failures equal to the CPU oracle's
    (``wgl``) on the stored history, the monitor's evidence certified.
    (c) ``analyze`` with (b)'s options: exit 1, the same failures. (d)
    ``python3 -m jepsen_tpu_torch.suites.etcd test --stub ...
    --hard-time-limit 4``: salvaged at the limit ("time-limit"), no
    journal left, the exit code ``hard_main`` maps from the verdict. (e)
    ``suites.txn test --workload append --nemesis faketime --monitor``:
    exit 0, the clock nemesis's ops contained as info completions under
    the dummy remote, the txn monitor's verdict True; then with ``--bug
    future-read --monitor-chunk 8``: exit 1, aborted mid-run, a G1c
    anomaly whose cycle witness certifies. (f) ``--profile``: the
    marker's status "done" naming a non-empty Chrome trace that holds
    CUDA kernel events (``profile_main.kernel_stats``). Each run's exit
    code, wall, rollout launches and client ops/s are in the phase's
    line. On the CPU (a rehearsal) every command gets ``--device cpu``
    and the kernel and profiler checks that need a card are skipped."""
    import contextlib
    import logging
    import shutil
    import tempfile
    import threading
    from jepsen_tpu_torch import __main__ as demo_main
    from jepsen_tpu_torch import independent, obs, store
    from jepsen_tpu_torch.checker import checkers, rollout
    from jepsen_tpu_torch.obs import profile as obs_profile
    from jepsen_tpu_torch.profile_main import kernel_stats
    from jepsen_tpu_torch.suites import txn as txn_suite
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    device = [] if cuda else ["--device", "cpu"]
    root = logging.getLogger()
    saved_log = (root.level, list(root.handlers))
    base = store.base_dir
    tmp = tempfile.mkdtemp(prefix="jepsen-cli-")
    store.base_dir = os.path.join(tmp, "store")
    # the process's threads when the phase starts: each competes with the
    # interpreter and the monitor for the GIL
    out = {"phase": "cli", "threads_at_start": threading.active_count()}
    launches = {}

    def client_rate(hist):
        ops = [o for o in hist if isinstance(o["process"], int)]
        span = (max(o["time"] for o in ops)
                - min(o["time"] for o in ops)) / 1e9
        return sum(o["type"] != "invoke" for o in ops) / span

    def run(name, main, argv, want):
        rollout.launches = 0
        t0 = time.monotonic()
        # a run prints its results map: keep this script's output to
        # its phase lines
        with contextlib.redirect_stdout(sys.stderr):
            try:
                main(argv + device)
                code = 0
            except SystemExit as exc:
                code = exc.code
        sync(dev)
        wall = time.monotonic() - t0
        checkers.join_racers()
        launches[f"cli_{name}"] = rollout.launches
        if code != want:
            raise AssertionError(f"cli {name}: exit {code}, want {want}")
        test = store.latest()
        hist = test["history"]
        row = {"exit": code, "wall_s": wall,
               "rollout_launches": rollout.launches,
               "client_ops_per_s": client_rate(hist),
               "history_ops": len(hist)}
        mon = test["results"].get("monitor")
        if isinstance(mon, dict):
            row.update(monitor_checks=mon["checks"],
                       monitor_chunks=mon["chunks"],
                       monitor_verdict=mon["verdict"],
                       time_to_first_verdict_s=mon[
                           "time_to_first_verdict_s"],
                       detection_latency_s=mon.get("detection_latency_s"))
        return test, row

    def files(test, *names):
        missing = [n for n in names
                   if not os.path.exists(store.path(test, n))]
        if missing:
            raise AssertionError(f"cli {test['name']}: no {missing} in "
                                 f"the store")

    def certified(what, test):
        cert = test["results"].get("monitor-certification") or {}
        if cert.get("confirmed") is not True \
                or (cert.get("counts") or {}).get("error"):
            raise AssertionError(f"cli {what}: certification {cert}")
        return cert

    def oracle_failures(test):
        chk = independent.checker(checkers.linearizable(
            {"model": "cas-register", "algorithm": "wgl"}))
        return sorted(chk.check({}, test["history"], {})["failures"])

    try:
        def register(limit):
            return ["--workload", "register", "--no-ssh", "--monitor",
                    "--concurrency", "10n", "--per-key-limit",
                    str(CLI_PER_KEY), "--time-limit", str(limit)]
        # (a) the normal entry point at a realistic size
        test, row = run("a", demo_main.main, ["test"] + register(time_limit),
                        0)
        r = test["results"]
        if r["valid"] is not True or r["monitor"]["verdict"] is not True:
            raise AssertionError(f"cli a: valid {r['valid']!r}, monitor "
                                 f"{r['monitor']['verdict']!r}")
        errs = errors_in(r)
        if errs:
            raise AssertionError(f"cli a: {errs}")
        files(test, "history.jsonl", "results.json", "test.json",
              "jepsen.log", "monitor.json")
        if cuda and not row["rollout_launches"]:
            raise AssertionError("cli a: the run never launched the "
                                 "rollout kernel")
        keys = {o["value"][0] for o in test["history"]
                if isinstance(o["process"], int)}
        spans = {}
        for e in obs.load_trace(store.path(test, "trace.jsonl")):
            if e.get("ph") == "X" and e["name"] in ("run-case", "analyze"):
                spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
        row.update(monitor_check_stats(test))
        out["a"] = {**row, "keys": len(keys),
                    "run_case_s": spans["run-case"],
                    "analyze_s": spans["analyze"]}

        # (b) the dirty-read bug caught mid-run
        bug = register(max(time_limit, CLI_BUG_TIME_LIMIT)) + [
            "--bug", "dirty-read", "--monitor-chunk", str(CLI_BUG_CHUNK)]
        test, row = run("b", demo_main.main, ["test"] + bug, 1)
        row.update(monitor_check_stats(test))
        r = test["results"]
        mon = r["monitor"]
        if r.get("abort-reason") != "monitor-violation" \
                or r.get("salvaged") is not True or r["valid"] is not False \
                or mon["verdict"] is not False \
                or not isinstance(mon.get("detected_at_index"), int):
            raise AssertionError(f"cli b: abort {r.get('abort-reason')!r}, "
                                 f"valid {r['valid']!r}, monitor {mon}")
        failures = sorted(r["workload"]["failures"])
        oracle = oracle_failures(test)
        if failures != oracle:
            raise AssertionError(f"cli b: failures {failures} != the CPU "
                                 f"oracle's {oracle}")
        out["b"] = {**row, "detected_at_index": mon["detected_at_index"],
                    "failures": len(failures),
                    "certification": certified("b", test)}

        # (c) analyze re-checks the stored history
        test, row = run("c", demo_main.main, ["analyze"] + bug, 1)
        if sorted(test["results"]["workload"]["failures"]) != failures:
            raise AssertionError("cli c: analyze's failures differ from "
                                 "the run's")
        out["c"] = row

        # (d) the process boundary: the etcd stub past its hard limit
        cwd = os.path.join(tmp, "etcd")
        os.makedirs(cwd)
        here = os.path.dirname(os.path.abspath(__file__))
        rollout.launches = 0
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch.suites.etcd", "test",
             "--stub", "--no-ssh", "--node", "n1", "--node", "n2", "--node",
             "n3", "--workload", "register", "--time-limit", "60",
             "--hard-time-limit", str(CLI_HARD_LIMIT)] + device,
            cwd=cwd, env={**os.environ, "PYTHONPATH": here},
            capture_output=True, text=True, timeout=300)
        wall = time.monotonic() - t0
        latest = os.path.join(cwd, "store", "latest")
        with open(os.path.join(latest, "results.json")) as f:
            r = json.load(f)
        want = {True: 0, False: 1}.get(r["valid"], 2)
        if r.get("salvaged") is not True \
                or r.get("abort-reason") != "time-limit" \
                or os.path.exists(os.path.join(latest,
                                               "history.jsonl.journal")) \
                or proc.returncode != want:
            raise AssertionError(f"cli d: exit {proc.returncode} (want "
                                 f"{want}), {r.get('abort-reason')!r}, "
                                 f"salvaged {r.get('salvaged')!r}: "
                                 f"{proc.stderr[-2000:]}")
        out["d"] = {"exit": proc.returncode, "wall_s": wall,
                    "valid": r["valid"], "hard_limit_s": CLI_HARD_LIMIT}

        # (e) the txn suite under the contained clock nemesis
        txn = ["--node", "n1", "--no-ssh", "--workload", "append",
               "--nemesis", "faketime", "--monitor", "--time-limit",
               str(txn_time_limit)]
        test, row = run("e", txn_suite.main, ["test"] + txn, 0)
        nem = [o for o in test["history"] if o["process"] == "nemesis"]
        if test["results"]["monitor"]["verdict"] is not True or not nem \
                or any(o["type"] != "info" for o in nem):
            raise AssertionError(f"cli e: monitor "
                                 f"{test['results']['monitor']}, nemesis "
                                 f"{nem[:4]}")
        row["nemesis_ops"] = len(nem)
        row["nemesis_contained"] = sum(
            isinstance(o.get("value"), list)
            and o["value"][:1] == ["nemesis-unavailable"] for o in nem)
        out["e"] = row
        test, row = run("e_bug", txn_suite.main,
                        ["test"] + txn + ["--bug", "future-read",
                                          "--monitor-chunk",
                                          str(CLI_BUG_CHUNK)], 1)
        r = test["results"]
        anomalies = r["workload"].get("anomaly_types") or []
        if r.get("abort-reason") != "monitor-violation" \
                or not any(a.startswith(("G0", "G1c")) for a in anomalies):
            raise AssertionError(f"cli e_bug: abort "
                                 f"{r.get('abort-reason')!r}, anomalies "
                                 f"{anomalies}")
        out["e_bug"] = {**row, "anomaly_types": anomalies,
                        "certification": certified("e_bug", test)}

        # (f) --profile: the capture around the run's device searches
        test, row = run("f", demo_main.main, [
            "test", "--workload", "register", "--no-ssh", "--profile",
            "--per-key-limit", str(CLI_PROFILE_PER_KEY), "--time-limit",
            str(profile_time_limit)], 0)
        with open(store.path(test, obs_profile.MARKER_FILE)) as f:
            marker = json.load(f)
        trace = os.path.join(marker.get("dir") or "",
                             marker.get("trace") or "")
        if marker.get("status") != "done" or not os.path.isfile(trace) \
                or not os.path.getsize(trace):
            raise AssertionError(f"cli f: profile marker {marker}")
        with open(trace) as f:
            evs = [(e["ts"], e["ts"] + e["dur"], e["name"],
                    e.get("cat") == "kernel")
                   for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X"]
        stats = kernel_stats(evs, marker["wall_s"], top=5)
        if cuda and not stats["kernel_launches"]:
            raise AssertionError("cli f: the profile holds no CUDA kernel")
        out["f"] = {**row, "profile_status": marker["status"],
                    "activities": marker.get("activities"),
                    "capture_wall_s": marker["wall_s"],
                    "trace_bytes": os.path.getsize(trace), **stats}
    finally:
        store.base_dir = base
        shutil.rmtree(tmp, ignore_errors=True)
        root.setLevel(saved_log[0])
        for h in list(root.handlers):
            if h not in saved_log[1]:
                root.removeHandler(h)
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t_start
    return out


#: the campaign phase: the sweep ``--axis workload=register,append
#: --seeds 2`` (four cells) at ``--parallel 2 --device-slots 1``, each cell
#: a monitored demo run of CAMPAIGN_TIME_LIMIT s at 10n workers and
#: CAMPAIGN_PER_KEY ops per key (the register cells' monitors run the
#: single-key search, as ``cli`` (a)'s does); the trend rung's key batch
#: TREND_REPEATS times per record. One repeat is ~0.2 s of host-bound
#: launches whose samples spread 25-50% (NVIDIA H100 80GB HBM3,
#: 700.00 W, and its host): a best of 3 failed the A/A gate in 1 of 12
#: back-to-back pairs, a best of 10 in none, its largest drop 15.6%
#: (``tools/trend_aa.py``; PERF.md §6)
CAMPAIGN_TIME_LIMIT, CAMPAIGN_PER_KEY, TREND_REPEATS = 3, 200, 10


def campaign_phase(dev, time_limit=CAMPAIGN_TIME_LIMIT,
                   per_key=CAMPAIGN_PER_KEY, trend_repeats=TREND_REPEATS):
    """The campaign runner on one host (``jepsen_tpu_torch/campaign``),
    its store in a temporary directory. (a) ``python -m jepsen_tpu_torch
    campaign --no-ssh --axis workload=register,append --seeds 2
    --parallel 2 --device-slots 1 --monitor`` in process through
    ``__main__.main``: exit 0, the four cells decided True, the report's
    ``fleet_analysis`` with no error and its ``certification`` of all
    four runs with no error, no two checks overlapping in time, the
    rollout kernel launched (the register cells' monitors); each cell's
    outcome and wall and ``campaign.device_wait_s``. The overlap check
    is a probe of its own, independent of the slot: it times each
    cell's checker inside the slot's wrapper and each monitor's chunk
    check (``monitor.engine.check_prefix``, ``StreamCheck.check``,
    ``TxnCheck.check``), outermost call per thread, and fails if any
    two of those intervals intersect. (b) The same matrix through
    ``campaign.run_cells`` with a
    latch set when the first cell finishes, then ``campaign --resume``:
    the resume runs exactly the cells the first run left unjournaled or
    aborted, and the final outcomes equal (a)'s cell for cell. (c)
    ``campaign --lint --campaign-id`` (a)'s id: exit 0 (the fleetlint
    audit). (d) ``obs.trend.mini_bench`` on ``dev`` twice, each recorded,
    and ``trend gate`` passing A/A: ops/s and the fingerprint; the key
    batch launches no rollout kernel. On the CPU (a rehearsal) every
    command gets ``--device cpu`` and the launch checks are skipped."""
    import argparse
    import contextlib
    import logging
    import random as _random
    import shutil
    import tempfile
    import threading
    from jepsen_tpu_torch import __main__ as demo_main
    from jepsen_tpu_torch import campaign, cli, core, demo, store
    from jepsen_tpu_torch.campaign import scheduler
    from jepsen_tpu_torch.checker import checkers, rollout
    from jepsen_tpu_torch.monitor import engine as mengine
    from jepsen_tpu_torch.monitor import txn as mtxn
    from jepsen_tpu_torch.monitor import wgl_stream
    from jepsen_tpu_torch.obs import trend
    from jepsen_tpu_torch.robust import AbortLatch
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    device = [] if cuda else ["--device", "cpu"]
    root = logging.getLogger()
    saved_log = (root.level, list(root.handlers))
    base = store.base_dir
    tmp = tempfile.mkdtemp(prefix="jepsen-campaign-")
    store.base_dir = os.path.join(tmp, "store")
    out = {"phase": "campaign"}
    launches = {}
    argv = ["campaign", "--no-ssh", "--axis", "workload=register,append",
            "--seeds", "2", "--parallel", "2", "--device-slots", "1",
            "--monitor", "--concurrency", "10n", "--per-key-limit",
            str(per_key), "--time-limit", str(time_limit)] + device

    def main(args):
        with contextlib.redirect_stdout(sys.stderr):
            try:
                demo_main.main(args)
                return 0
            except SystemExit as exc:
                return exc.code

    def report(cid):
        with open(store.campaign_path(cid, "report.json")) as f:
            return json.load(f)

    def outcomes(rep):
        return {r["cell"]: r["outcome"] for r in rep["cells"]}

    # the overlap probe: (start, end, label) of every outermost check
    intervals, probe_lock, depth = [], threading.Lock(), threading.local()

    def probed(fn, label):
        def run(*args, **kwargs):
            outer = not getattr(depth, "n", 0)
            depth.n = getattr(depth, "n", 0) + 1
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth.n -= 1
                if outer:
                    with probe_lock:
                        intervals.append((t, time.perf_counter(), label))
        return run

    slot_init = scheduler._DeviceSlotChecker.__init__

    def probed_init(self, inner, sem, reg):
        slot_init(self, inner, sem, reg)
        # on the instance, so the monitor still finds its checker tree
        self.inner.check = probed(self.inner.check, "checker")

    patches = [(scheduler._DeviceSlotChecker, "__init__", probed_init),
               (mengine, "check_prefix",
                probed(mengine.check_prefix, "monitor")),
               (wgl_stream.StreamCheck, "check",
                probed(wgl_stream.StreamCheck.check, "monitor")),
               (mtxn.TxnCheck, "check",
                probed(mtxn.TxnCheck.check, "txn-monitor"))]

    try:
        # (a) the sweep through the command line, every check probed
        rollout.launches = 0
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        try:
            t0 = time.monotonic()
            code = main(argv + ["--campaign-id", "smoke"])
            sync(dev)
            wall = time.monotonic() - t0
            checkers.join_racers()
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)
        launches["campaign"] = rollout.launches
        rep = report("smoke")
        with open(store.campaign_path("smoke", "metrics.json")) as f:
            metrics = json.load(f)
        fa, cert = rep.get("fleet_analysis"), rep.get("certification")
        if code != 0 or rep["status"] != "complete" \
                or set(outcomes(rep).values()) != {True} \
                or len(rep["cells"]) != 4:
            raise AssertionError(f"campaign a: exit {code}, "
                                 f"{rep['summary']}, {rep['triage']}")
        if fa is None or fa["counts"]["error"] or cert is None \
                or cert["counts"]["error"] \
                or not cert["sampled"] == cert["of"] == 4:
            raise AssertionError(f"campaign a: audit {fa}, "
                                 f"certification {cert}")
        intervals.sort()
        overlaps = [(a, b) for a, b in zip(intervals, intervals[1:])
                    if b[0] < a[1]]
        probed_n = {k: sum(1 for i in intervals if i[2] == k)
                    for k in ("checker", "monitor", "txn-monitor")}
        if overlaps or probed_n["checker"] != 4 \
                or not probed_n["monitor"] or not probed_n["txn-monitor"]:
            raise AssertionError(f"campaign a: checks probed {probed_n}, "
                                 f"overlapping {overlaps[:4]}")
        if cuda and not launches["campaign"]:
            raise AssertionError("campaign a: no cell launched the "
                                 "rollout kernel")
        wait = metrics["histograms"]["campaign.device_wait_s"]
        out["a"] = {
            "exit": code, "wall_s": wall,
            "cells": {r["cell"]: {"outcome": r["outcome"],
                                  "wall_s": r["wall_s"]}
                      for r in rep["cells"]},
            "checks_probed": probed_n, "checks_overlapping": 0,
            "device_wait_s": {"count": wait["count"], "sum": wait["sum"],
                              "max": wait["max"]},
            "fleet_analysis": fa["counts"],
            "fleet_checks": fa["checks"],
            "certification": {"sampled": cert["sampled"],
                              "of": cert["of"],
                              "counts": cert["counts"]},
            "rollout_launches": launches["campaign"]}

        # (b) interrupted after the first cell, then resumed
        parser = argparse.ArgumentParser()
        cli.add_test_opts(parser)
        cmd = cli.campaign_cmd({"test-fn": demo.demo_test,
                                "opt-spec": demo_main._add_demo_opts})
        cmd["campaign"]["opt-spec"](parser)
        options = cli.test_opt_fn(cli._ns_to_opts(parser.parse_args(
            argv[1:])))
        latch = AbortLatch()
        build_lock = threading.Lock()

        def build(params):
            # seed and build as one step, as the command line's build does
            with build_lock:
                _random.seed(params["seed"])
                return demo.demo_test({**options, **params})

        def run_first(test):
            done = core.run(test)
            latch.set("first-cell-done")
            return done

        cells = [dict(c, build=build) for c in campaign.plan.expand(
            {"axes": cli.parse_axes(options["axis"], options["seeds"])})]
        t0 = time.monotonic()
        # a run prints its results map: keep this script's output to its
        # phase lines
        with contextlib.redirect_stdout(sys.stderr):
            first = campaign.run_cells(cells, campaign_id="resume",
                                       parallel=2, device_slots=1,
                                       latch=latch, run_fn=run_first)
        checkers.join_racers()
        journaled = set(campaign.journal.CampaignJournal(
            "resume").completed())
        n_before = len(store.load_campaign_records("resume"))
        code = main(argv + ["--campaign-id", "resume", "--resume"])
        checkers.join_racers()
        wall_b = time.monotonic() - t0
        records = store.load_campaign_records("resume")
        reran = sorted(r["cell"] for r in records[n_before:])
        rep_b = report("resume")
        want = sorted(set(outcomes(rep)) - journaled)
        if first["status"] != "aborted" or not journaled \
                or code != 0 or reran != want \
                or outcomes(rep_b) != outcomes(rep) \
                or rep_b["summary"]["skipped-resumed"] != len(journaled):
            raise AssertionError(
                f"campaign b: first run {first['summary']}, journaled "
                f"{sorted(journaled)}, resume exit {code} reran {reran} "
                f"(want {want}), outcomes {outcomes(rep_b)}")
        out["b"] = {"wall_s": wall_b, "journaled_first": sorted(journaled),
                    "first_outcomes": outcomes(first), "resume_exit": code,
                    "reran": reran, "outcomes": outcomes(rep_b)}

        # (c) the control-plane audit of (a)'s campaign
        code = main(["campaign", "--no-ssh", "--lint", "--campaign-id",
                     "smoke"])
        if code != 0:
            raise AssertionError(f"campaign c: audit exit {code}")
        out["c"] = {"exit": code}

        # (d) the trend rung on the card, A/A
        rollout.launches = 0
        path = os.path.join(tmp, "trend.jsonl")
        t0 = time.monotonic()
        recs = [trend.record(trend.mini_bench(repeats=trend_repeats,
                                              device=str(dev)),
                             path=path, label=f"aa-{i}")
                for i in range(2)]
        launches["trend"] = rollout.launches
        if launches["trend"]:
            raise AssertionError(f"campaign d: the key batch launched the "
                                 f"rollout kernel {launches['trend']} "
                                 f"times")
        with contextlib.redirect_stdout(sys.stderr):
            gate = trend.main(["gate", "--path", path])
        verdict = trend.compare(recs[:1], recs[1])
        if gate != 0 or verdict["regressions"] \
                or not verdict["compared"]:
            raise AssertionError(f"campaign d: A/A gate {gate}, {verdict}")
        out["d"] = {"wall_s": time.monotonic() - t0,
                    "ops_per_s": [r["rungs"]["mini-cas-batch"]["samples"][
                        "ops_per_s"] for r in recs],
                    "duty_cycle": [r["rungs"]["mini-cas-batch"]["metrics"][
                        "duty_cycle"] for r in recs],
                    "gate": verdict, "fingerprint": recs[0]["fingerprint"]}
    finally:
        # the scheduler attached the disk ledger under the temporary
        # store: detach it before the store goes
        from jepsen_tpu_torch.fleet import ledger
        ledger.detach()
        store.base_dir = base
        shutil.rmtree(tmp, ignore_errors=True)
        root.setLevel(saved_log[0])
        for h in list(root.handlers):
            if h not in saved_log[1]:
                root.removeHandler(h)
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t_start
    return out



FLEET_KILL_SEED = 3


def fleet_phase(dev, time_limit=CAMPAIGN_TIME_LIMIT, per_key=CAMPAIGN_PER_KEY,
                kill_seed=FLEET_KILL_SEED):
    """The fleet (``jepsen_tpu_torch/fleet``): campaign (a)'s matrix with
    every cell in a worker process of its own, its store in a temporary
    directory. (a) ``campaign --no-ssh --axis workload=register,append
    --seeds 2 --monitor --concurrency 10n --per-key-limit 200
    --time-limit 3 --workers local,local --backends gpu,cpu
    --worker-store <tmp>`` through ``__main__.main``: exit 0, every
    cell's record on the ``gpu`` tier (``cpu`` in a CPU rehearsal) and
    True, every run mirrored home by the artifact sync, the finalize
    audit without error, ``certify_campaign`` of all four mirrored runs
    without error, two worker lanes in ``campaign_trace.jsonl``, and at
    least one register cell's mirrored ``metrics.json`` holding the phase
    plane's ``compile`` lap: the mark, armed only on the card, that the
    worker process loaded the rollout kernel's library and searched with
    it. (b) The same cells through ``fleet.run_fleet`` under a chaos
    profile with one seeded worker kill (``kills=1``), unmonitored and
    with no backend ladder (no probe; the workers' device is the
    options', CUDA on the card), so no record names a tier: the killed
    cell's journal shows
    its lease, the lease's failure and a second lease, and it is
    decided with (a)'s outcome; every cell terminal once. Each
    cell's wall, each worker's start-up (the coordinator's send to the
    worker's receipt, the handshake's first leg) and the seconds of
    each part. The workers' rollout launches are in their processes,
    which this script's counter does not see: it must stay at 0."""
    import argparse
    import contextlib
    import logging
    import shutil
    import tempfile
    from jepsen_tpu_torch import __main__ as demo_main
    from jepsen_tpu_torch import campaign, cli, demo, fleet, store
    from jepsen_tpu_torch.analysis import certify
    from jepsen_tpu_torch.checker import rollout
    from jepsen_tpu_torch.fleet import chaos
    from jepsen_tpu_torch.obs.metrics import parse_flat_key
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    tier = "gpu" if cuda else "cpu"
    root = logging.getLogger()
    saved_log = (root.level, list(root.handlers))
    base = store.base_dir
    tmp = tempfile.mkdtemp(prefix="jepsen-fleet-")
    store.base_dir = os.path.join(tmp, "store")
    wstore = os.path.join(tmp, "workers")
    out = {"phase": "fleet"}
    argv = ["campaign", "--no-ssh", "--axis", "workload=register,append",
            "--seeds", "2", "--monitor", "--concurrency", "10n",
            "--per-key-limit", str(per_key), "--time-limit",
            str(time_limit), "--workers", "local,local", "--backends",
            "gpu,cpu", "--worker-store", wstore] + \
        ([] if cuda else ["--device", "cpu"])

    def main(args):
        with contextlib.redirect_stdout(sys.stderr):
            try:
                demo_main.main(args)
                return 0
            except SystemExit as exc:
                return exc.code

    def cells_of(records):
        return {r["cell"]: {
            "outcome": r.get("outcome"), "backend": r.get("backend"),
            "worker": r.get("worker"), "attempt": r.get("attempt"),
            "wall_s": r.get("wall_s"),
            "startup_s": r["clock"]["worker-received-epoch"]
            - r["clock"]["coord-sent-epoch"],
            "lease_s": r["clock"]["coord-received-epoch"]
            - r["clock"]["coord-sent-epoch"]} for r in records}

    def compile_laps(records):
        laps = {}
        for r in records:
            m = store.load_run_metrics(str(r["path"])) or {}
            laps[r["cell"]] = sum(
                v for k, v in (m.get("counters") or {}).items()
                if parse_flat_key(k)[0] == "wgl.phase_s"
                and parse_flat_key(k)[1].get("phase") == "compile")
        return laps

    try:
        # (a) the sweep through the dispatcher, on the card's tier
        rollout.launches = 0
        t0 = time.monotonic()
        code = main(argv + ["--campaign-id", "fleet"])
        wall_a = time.monotonic() - t0
        with open(store.campaign_path("fleet", "report.json")) as f:
            rep = json.load(f)
        recs = store.latest_campaign_records("fleet")
        fa, trace = rep.get("fleet_analysis"), rep.get("trace") or {}
        cert = certify.certify_campaign(recs, device=str(dev))
        laps = compile_laps(recs)
        register_laps = {c: v for c, v in laps.items()
                         if "register" in c}
        if code != 0 or rep["status"] != "complete" or len(recs) != 4 \
                or {r["outcome"] for r in recs} != {True} \
                or {r.get("backend") for r in recs} != {tier}:
            raise AssertionError(f"fleet a: exit {code}, "
                                 f"{rep['summary']}, "
                                 f"{cells_of(recs)}")
        if any(r.get("synced") is not True
               or not os.path.isdir(str(r["path"])) for r in recs):
            raise AssertionError(
                "fleet a: runs not mirrored: "
                f"{[(r['cell'], r.get('synced')) for r in recs]}")
        if fa is None or fa["counts"]["error"] \
                or cert["counts"]["error"] \
                or not cert["sampled"] == cert["of"] == 4:
            raise AssertionError(f"fleet a: audit {fa}, "
                                 f"certification {cert}")
        if sorted(trace.get("workers") or {}) != ["local", "local#2"]:
            raise AssertionError(f"fleet a: merged trace lanes "
                                 f"{trace.get('workers')}")
        if cuda and not any(v > 0 for v in register_laps.values()):
            raise AssertionError(f"fleet a: no register cell's worker "
                                 f"laps the rollout library's compile: "
                                 f"{laps}")
        if rollout.launches:
            raise AssertionError(f"fleet a: the coordinator launched the "
                                 f"rollout kernel {rollout.launches} "
                                 f"times; every search belongs to a "
                                 f"worker")
        out["a"] = {"exit": code, "wall_s": wall_a,
                    "cells": cells_of(recs),
                    "compile_lap_s": laps,
                    "fleet_analysis": fa["counts"],
                    "fleet_checks": fa["checks"],
                    "certification": {"sampled": cert["sampled"],
                                      "of": cert["of"],
                                      "counts": cert["counts"]},
                    "trace": trace}

        # (b) one seeded worker kill: the cell is stolen and re-run
        parser = argparse.ArgumentParser()
        cli.add_test_opts(parser)
        cmd = cli.campaign_cmd({"test-fn": demo.demo_test,
                                "opt-spec": demo_main._add_demo_opts})
        cmd["campaign"]["opt-spec"](parser)
        # (b) runs without the monitor: the steal is the point, and the
        # register cells' final monitor checks would double their walls
        options = cli.test_opt_fn(cli._ns_to_opts(parser.parse_args(
            [a for a in argv[1:] if a != "--monitor"])))
        cells = campaign.plan.expand(
            {"axes": cli.parse_axes(options["axis"], options["seeds"])})
        prof = chaos.ChaosProfile(name="worker-kill", seed=kill_seed,
                                  kills=1)
        killed = sorted(prof.plan_kills([c["id"] for c in cells]))
        t0 = time.monotonic()
        with contextlib.redirect_stdout(sys.stderr):
            rep_b = fleet.run_fleet(
                cells, fleet.parse_workers("local,local"),
                campaign_id="steal",
                builder="jepsen_tpu_torch.demo:demo_test",
                base_options=cli._jsonable_options(options),
                worker_store_dir=wstore, chaos=prof)
        wall_b = time.monotonic() - t0
        recs_b = store.latest_campaign_records("steal")
        events = [e for e in store.campaign_events("steal")
                  if e.get("cell") in killed]
        story = [(e["event"], e.get("attempt")) for e in events
                 if e["event"] in ("lease", "lease-failed")]
        terminal = {}
        for r in store.load_campaign_records("steal"):
            if not r.get("event"):
                terminal[r["cell"]] = terminal.get(r["cell"], 0) + 1
        by_cell = {r["cell"]: r for r in recs_b}
        if len(killed) != 1 or rep_b["status"] != "complete" \
                or story[:3] != [("lease", 1), ("lease-failed", None),
                                 ("lease", 2)] \
                or by_cell[killed[0]]["attempt"] != 2 \
                or by_cell[killed[0]]["outcome"] \
                != {r["cell"]: r["outcome"] for r in recs}[killed[0]] \
                or terminal != {c["id"]: 1 for c in cells} \
                or any("backend" in r for r in recs_b):
            raise AssertionError(f"fleet b: killed {killed}, story "
                                 f"{story}, terminal {terminal}, "
                                 f"{cells_of(recs_b)}")
        out["b"] = {"wall_s": wall_b, "killed": killed[0], "story": story,
                    "cells": cells_of(recs_b),
                    "fleet_analysis": rep_b["fleet_analysis"]["counts"]}
    finally:
        # the campaign attached the disk ledger under the temporary
        # store: detach it before the store goes
        fleet.ledger.detach()
        store.base_dir = base
        shutil.rmtree(tmp, ignore_errors=True)
        root.setLevel(saved_log[0])
        for h in list(root.handlers):
            if h not in saved_log[1]:
                root.removeHandler(h)
    out["launches"] = {"fleet_coordinator": 0}
    out["seconds"] = time.monotonic() - t_start
    return out


def batch_phase(keys, oracle):
    """The 256-key headline batch: a profiled call (the warm-up), then a
    timed call; the first 32 verdicts against the CPU oracle's
    (``oracle``, the gate phase's verdicts of the first keys)."""
    import torch
    from jepsen_tpu_torch import models, parallel
    from jepsen_tpu_torch.checker import rollout
    from jepsen_tpu_torch.profile_main import profile_batch
    spec = models.cas_register_spec
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
    for k, want in enumerate(oracle[:32]):
        if res[k]["valid"] != want:
            raise AssertionError(f"batch key {k}: device {res[k]['valid']}"
                                 f" != oracle {want}")
    searched = [r for r in res if r.get("engine") == "jax-wgl"]
    row = {"phase": "batch", "model": "cas-register", "keys": len(pairs),
           "history_ops": n_ops, "wall_s": wall, "ops_per_s": n_ops / wall,
           "iterations": max(r.get("iterations") or 0 for r in res),
           "compactions": max(r.get("compactions") or 0 for r in res),
           "keys_searched": len(searched),
           "keys_decided_on_host": len(res) - len(searched),
           "invalid_keys": len(invalid), "rollout_launches": launches,
           "oracle_keys": 32,
           "profiled": {k: v for k, v in prof.items()
                        if k != "top_kernels"},
           "top_kernels": prof["top_kernels"][:5]}
    return row


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
    """64 keys through ``independent.checker`` with the default gate
    ("competition") and planning on: one batched call carrying every
    key's segments (``GATE_SEGMENTS``)."""
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
    if calls != [sum(GATE_SEGMENTS[:len(keys)])]:
        raise AssertionError(f"independent: batched calls {calls}, "
                             f"expected one of "
                             f"{sum(GATE_SEGMENTS[:len(keys)])} pairs")
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
    where that declines), and the sequential WGL oracle within
    ``QUEUE_WGL_ORACLE_CONFIGS`` configurations (None where it does not
    decide in them)."""
    from jepsen_tpu_torch.checker import torch_wgl, wgl
    inv32, ret32, _ = torch_wgl._encode_arrays(e)
    fast = spec.fast_check(e, inv32, ret32)
    exact = (fast if fast is True else fast[0]) if fast is not None \
        else wgl.check_encoded(spec, e, st, max_configs=2_000_000)["valid"]
    bounded = wgl.check_encoded(spec, e, st,
                                max_configs=QUEUE_WGL_ORACLE_CONFIGS)["valid"]
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


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def streamlin_phase(keys, dev, offline_keys=OFFLINE_KEYS,
                    stream_keys=STREAM_KEYS, batch_keys=FOLD_BATCH_KEYS,
                    batch_f=FOLD_BATCH_F):
    """The streaming frontier fold on the batch keys: (a) the offline
    face on ``offline_keys`` against the CPU sweep (``linear``): equal
    verdicts, and on the corrupted keys the violating op is the return
    at which the sweep fails; (b) one lane-batched fold over the first
    ``batch_keys`` keys' whole histories at ``batch_f`` rows, one timed
    call (not profiled: gathering its events took 23 s), each lane
    equal to its solo fold; (c)
    ``StreamCheck`` fed ``stream_keys`` op by op, checked every
    STREAM_CHUNK completions, each verdict equal to the CPU WGL oracle's
    on the same prefix, the corrupted keys caught by the frontier and
    confirmed by the port's WGL engine (``torch_wgl``). The stream's
    seconds are those of its own offers and checks, without the
    oracle's."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checker import linear, streamlin
    from jepsen_tpu_torch.monitor import StreamCheck
    from jepsen_tpu_torch.monitor import engine as mengine
    spec = models.cas_register_spec
    def corrupted(ks):
        return [k for k in ks if k % CORRUPT_EVERY == CORRUPT_EVERY - 1]
    pairs = [spec.encode(h) for h in
             keys[:max(batch_keys, *offline_keys, *stream_keys) + 1]]

    # (a) the offline face
    t_start = time.monotonic()
    offline, offline_s, oracle_s = [], 0.0, 0.0
    for k in offline_keys:
        e, st = pairs[k]
        t0 = time.monotonic()
        got = streamlin.check_encoded(
            spec, e, st, max_configs=streamlin.FRONTIER_CAP_MAX, device=dev)
        sync(dev)
        offline_s += time.monotonic() - t0
        t0 = time.monotonic()
        if got["valid"] is False:
            # the violating op is the one whose return empties the CPU
            # sweep's config set: the sweep accepts the history cut just
            # before that return and rejects it cut just after. A
            # history is linearizable only if its prefixes are, so the
            # second also gives the whole history's CPU verdict: False
            cut = got["op"]["index"]
            for upto, ok in ((cut, True), (cut + 1, False)):
                pre = [o for o in keys[k] if o["index"] < upto]
                if linear.check_encoded(spec, *spec.encode(pre))["valid"] \
                        is not ok:
                    raise AssertionError(f"streamlin offline key {k}: op "
                                         f"{cut} is not where the CPU sweep "
                                         f"fails")
        else:
            want = linear.check_encoded(spec, e, st)
            if got["valid"] != want["valid"]:
                raise AssertionError(f"streamlin offline key {k}: "
                                     f"{got['valid']!r} != linear "
                                     f"{want['valid']!r}")
        oracle_s += time.monotonic() - t0
        offline.append({"key": k, "valid": got["valid"],
                        "configs_explored": got["configs_explored"],
                        "op_index": got.get("op", {}).get("index")})
    if sorted(r["key"] for r in offline if r["valid"] is False) \
            != corrupted(offline_keys):
        raise AssertionError(f"streamlin offline: invalid keys "
                             f"{offline}, expected "
                             f"{corrupted(offline_keys)}")

    # (b) one lane-batched fold over the first batch_keys whole histories
    jobs = [streamlin.history_job(spec, e, st, batch_f, dev)
            for e, st in pairs[:batch_keys]]
    C = max(j.C for j in jobs)
    for j in jobs:
        j.C = C                      # one shape: one fold of K lanes
    streamlin.syncs = 0
    t0 = time.monotonic()
    res = streamlin.batch_fold(jobs)
    sync(dev)
    wall = time.monotonic() - t0
    syncs = streamlin.syncs
    fields = ("status", "viol_slot", "passes", "steps", "n_live")
    t0 = time.monotonic()
    for k, job in enumerate(jobs):
        solo = streamlin.solo_fold(job)
        if [solo[f] for f in fields] != [res[k][f] for f in fields]:
            raise AssertionError(f"batch fold lane {k}: "
                                 f"{[res[k][f] for f in fields]} != solo "
                                 f"{[solo[f] for f in fields]}")
    solo_s = time.monotonic() - t0
    E = max(j.E for j in jobs)
    lane_events = sum(len(j) for j in jobs)
    invalid = [k for k, r in enumerate(res) if r["status"] == 1]
    if not invalid or any(k % CORRUPT_EVERY != CORRUPT_EVERY - 1
                          for k in invalid):
        raise AssertionError(f"batch fold: invalid lanes {invalid}; only "
                             f"corrupted keys may be")
    overflowed = [k for k, r in enumerate(res) if r["status"] == 2]
    held = [r for r in res if r["status"] != 2]
    batch = {"keys": len(jobs), "K": len(jobs), "F": jobs[0].F,
             "B": jobs[0].B, "C": C, "E": E, "lane_events": lane_events,
             "groups": len({j.shape_key() for j in jobs}),
             "wall_s": wall, "s_per_event": wall / E,
             "syncs": syncs, "syncs_per_event": syncs / E,
             # over the lanes whose frontier held (an overflowed lane
             # stops at its overflow)
             "passes_max": max(r["passes"] for r in held),
             "passes_total": sum(r["passes"] for r in held),
             "final_frontier_max": max(r["n_live"] for r in held),
             "invalid_lanes": invalid, "overflowed_lanes": overflowed,
             "solo_s": solo_s}

    # (c) StreamCheck op by op
    streamlin.syncs = 0
    rows = []

    def stream():
        for k in stream_keys:
            sc = StreamCheck(spec, device=dev, opts={
                "frontier-cap": streamlin.FRONTIER_CAP_MAX})
            checks, caught, confirm, n, own = 0, None, None, 0, 0.0
            for i, op in enumerate(keys[k]):
                t0 = time.monotonic()
                done = sc.offer(op, i)
                r = sc.check() if done and (n + 1) % STREAM_CHUNK == 0 \
                    else None
                own += time.monotonic() - t0
                n += done
                if r is None:
                    continue
                e, st = sc.materialize()
                want = mengine.check_prefix(spec, e, st, engine="wgl")
                checks += 1
                if r["valid"] != want["valid"]:
                    raise AssertionError(f"StreamCheck key {k}, check "
                                         f"{checks}: {r['valid']!r} != "
                                         f"offline {want['valid']!r}")
                if r["valid"] is False:
                    caught, confirm = i, r.get("engine")
                    if r.get("detected_by") != "streamlin":
                        raise AssertionError(f"StreamCheck key {k}: not "
                                             f"detected by the frontier")
                    break
            s = sc.stream_summary()
            if sc.fallback is not None or sc.flat_checks:
                raise AssertionError(f"StreamCheck key {k}: fell back "
                                     f"({sc.fallback}, {sc.flat_checks} "
                                     f"flat checks)")
            if (caught is not None) != (k in corrupted(stream_keys)):
                raise AssertionError(f"StreamCheck key {k}: caught at "
                                     f"{caught}")
            rows.append({"key": k, "events": i + 1, "checks": checks,
                         "caught_at": caught, "confirmed_by": confirm,
                         "stream_s": own, **s})

    t0 = time.monotonic()
    stream()
    stream_wall = time.monotonic() - t0
    events = sum(r["events"] for r in rows)
    own = sum(r["stream_s"] for r in rows)
    streaming = {"keys": len(rows), "events": events,
                 "wall_s": stream_wall, "stream_s": own,
                 "s_per_event": own / events,
                 "syncs": streamlin.syncs,
                 "syncs_per_event": streamlin.syncs / events,
                 "passes_per_event": sum(r["fold_passes"] for r in rows)
                 / events,
                 "frontier_peak": max(r["frontier_peak"] for r in rows),
                 "streams": rows}
    return {"phase": "streamlin", "seconds": time.monotonic() - t_start,
            "offline": offline, "offline_s": offline_s,
            "offline_oracle_s": oracle_s, "batch": batch,
            "streaming": streaming}


def squaring_ms(n, dev):
    """One closure squaring of an n-node 0/1 matrix (a random DAG plus
    cycles) timed with CUDA events in float32, in TF32 and in bf16;
    each boolean result must equal float32's."""
    import torch
    from jepsen_tpu_torch.checker.rollout_ab import cuda_ms
    g = torch.Generator(device=dev).manual_seed(n)
    r = (torch.rand((n, n), generator=g, device=dev) < 4.0 / n).float()
    want = torch.addmm(r, r, r) > 0
    out = {}
    for name, dtype, tf32 in (("float32", torch.float32, False),
                              ("tf32", torch.float32, True),
                              ("bf16", torch.bfloat16, False)):
        x = r.to(dtype)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            if not torch.equal(torch.addmm(x, x, x) > 0, want):
                raise AssertionError(f"{name} squaring differs")
            out[name] = cuda_ms(lambda: torch.addmm(x, x, x), 3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def txn_phase(dev, n_txns=TXN_TXNS, chunk=TXN_CHUNK, closure_n=CLOSURE_N,
              wr_txns=WR_TXNS, g1c=TXN_G1C, g1c_txns=TXN_G1C_TXNS,
              offline_at=TXN_OFFLINE_AT):
    """The txn cycle checkers at bench.py rung 15's shape on the card:
    the offline list-append check of the serial history (one profiled
    call), the G1c copy, TxnCheck chunk by chunk against the offline
    verdict of the prefix at the chunks of ``offline_at`` txns (and at
    the last), one closure and one wr check against the CPU, and one
    squaring's time by matmul dtype."""
    import numpy as np
    import torch
    from jepsen_tpu_torch import cycle, simulate
    from jepsen_tpu_torch.cycle import append, wr
    from jepsen_tpu_torch.monitor import TxnCheck
    from jepsen_tpu_torch.monitor import engine as mengine
    from jepsen_tpu_torch.profile_main import kernel_stats, profile_call
    t_start = time.monotonic()
    hist = simulate.txn_append_history(n_txns, TXN_APPENDS, TXN_PROCS)
    micro_ops = n_txns * (TXN_APPENDS + 1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p0, b0 = cycle.closure_passes(), cycle.closure_busy_s()
    res, wall, ev = profile_call(lambda: append.check(hist, device=dev),
                                 host_ops=False)
    passes = cycle.closure_passes() - p0
    if res["valid"] is not True:
        raise AssertionError(f"txn: the serial history decided "
                             f"{res['valid']!r} {res['anomaly_types']}")
    stats = kernel_stats(ev, wall, top=5)
    offline = {"txns": n_txns, "micro_ops": micro_ops, "valid": True,
               "profiled_wall_s": wall, "txns_per_s": n_txns / wall,
               "micro_ops_per_s": micro_ops / wall,
               "squarings": passes,
               "closure_device_s": cycle.closure_busy_s() - b0,
               "launches_per_squaring": stats["kernel_launches"] / passes,
               **stats}
    bad = simulate.txn_append_history(g1c_txns, TXN_APPENDS, TXN_PROCS,
                                      g1c=g1c)
    t0 = time.monotonic()
    rb = append.check(bad, device=dev)
    if rb["valid"] is not False or "G1c" not in rb["anomaly_types"]:
        raise AssertionError(f"txn: the G1c copy decided {rb['valid']!r} "
                             f"{rb['anomaly_types']}")
    invalid = {"txns": g1c_txns, "wall_s": time.monotonic() - t0,
               "anomaly_types": rb["anomaly_types"],
               "g1c_nodes": rb["anomalies"]["G1c"][0]["nodes"]}
    core = TxnCheck(device=dev)
    p0, b0 = cycle.closure_passes(), cycle.closure_busy_s()
    chunks, off_s = [], 0.0
    t0 = time.monotonic()
    for start in range(0, len(hist), 2 * chunk):
        for op in hist[start:start + 2 * chunk]:
            core.offer(op)
        c0, q0 = time.monotonic(), cycle.closure_passes()
        r = core.check()
        dt, dq = time.monotonic() - c0, cycle.closure_passes() - q0
        o0 = time.monotonic()
        if start + 2 * chunk >= len(hist):
            want = res                  # the whole history, checked above
        elif core.n_txns in offline_at:
            want = mengine.check_txn_prefix(hist[:start + 2 * chunk],
                                            "append", {"device": dev})
        else:
            want = None
        off_s += time.monotonic() - o0
        if r["valid"] is not True or (want is not None
                                      and want["valid"] != r["valid"]):
            raise AssertionError(f"TxnCheck chunk {len(chunks)}: "
                                 f"{r['valid']!r} != offline "
                                 f"{want['valid']!r}")
        chunks.append({"txns": core.n_txns, "s": dt, "passes": dq,
                       "offline": None if want is None else want["valid"]})
    streaming = {"chunk_txns": chunk, "chunks": len(chunks),
                 "offline_compared": sum(c["offline"] is not None
                                         for c in chunks),
                 "wall_s": time.monotonic() - t0 - off_s,
                 "offline_checks_s": off_s,
                 "closure_passes": sum(c["passes"] for c in chunks),
                 "closure_device_s": cycle.closure_busy_s() - b0,
                 "closure_rebuilds": core.frontier.rebuilds,
                 "per_chunk": chunks}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    rng = np.random.default_rng(closure_n)
    adj = rng.random((closure_n, closure_n)) < 2.0 / closure_n
    np.fill_diagonal(adj, False)
    if not np.array_equal(cycle.transitive_closure(adj, device=dev),
                          cycle.transitive_closure(adj, device="cpu")):
        raise AssertionError("txn: the card's closure != the CPU's")
    wh = simulate.txn_wr_history(random.Random(45100), wr_txns)
    t0 = time.monotonic()
    w_card = wr.check(wh, device=dev)
    w_s = time.monotonic() - t0
    w_cpu = wr.check(wh, device="cpu")
    if w_card != w_cpu or w_card["valid"] is not True:
        raise AssertionError(f"txn: wr check {w_card['valid']!r} != CPU "
                             f"{w_cpu['valid']!r}")
    squaring = squaring_ms(SQUARING_N, dev) if dev.type == "cuda" \
        else None
    return {"phase": "txn", "seconds": time.monotonic() - t_start,
            "offline": offline, "invalid": invalid,
            "streaming": streaming, "peak_device_bytes": peak,
            "closure_vs_cpu": {"n": closure_n, "equal": True},
            "wr": {"txns": wr_txns, "valid": True, "wall_s": w_s},
            "squaring_ms": squaring}


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
    trial_rows, trials = invalid_trials(dev)
    emit({"phase": "invalid", "trials": trial_rows})

    # -- 5. the gate at the JAX package's defaults -------------------------
    from jepsen_tpu_torch import simulate
    keys, fifo = simulate.bench_histories(BATCH_KEYS)
    flat = {r["model"]: r["wall_s"] for r in main_rows
            if r["rollout"] == "kernel"}
    gate, oracle = gate_phase(dev, keys, flat, trials, trial_rows)
    emit(gate)

    # -- 6. obs: the phase plane, heartbeats, the render and the store -----
    obs_row = obs_phase(dev, keys, main_rows, oracle,
                        gate["planned"]["unplanned_batch_s"], trials,
                        trial_rows)
    emit(obs_row)

    # -- 7. mesh: the multi-device search at world size 1 ------------------
    mesh_row = mesh_phase(dev, main_rows, trials, trial_rows, keys, oracle,
                          gate["planned"])
    emit(mesh_row)

    # -- 8. run: core.run end to end, from the first op to the verdict -----
    run_row = run_phase(dev)
    emit(run_row)

    # -- 9. monitor: monitored runs, the monitors on the card --------------
    mon_row = monitor_phase(dev, run_row["register"]["interpreter_ops_per_s"])
    emit(mon_row)

    # -- 10. cli: the command line, python -m jepsen_tpu_torch and suites --
    cli_row = cli_phase(dev)
    emit(cli_row)

    # -- 11. campaign: a sweep of runs behind one device slot --------------
    camp_row = campaign_phase(dev)
    emit(camp_row)

    # -- 12. fleet: the sweep's cells in worker processes ------------------
    fleet_row = fleet_phase(dev)
    emit(fleet_row)

    # -- 13-15. the key batch, independent, the queue models ---------------
    row = batch_phase(keys, oracle)
    emit(row)
    ind = independent_phase(keys[:INDEPENDENT_KEYS])
    emit(ind)
    queues = queue_phase(fifo)
    emit(queues)

    # -- 16-17. the streaming fold and the txn closure ---------------------
    rollout.launches = 0
    emit(streamlin_phase(keys, dev))
    stream_launches = scan_only("streamlin")
    rollout.launches = 0
    emit(txn_phase(dev))
    txn_launches = scan_only("txn")
    by_path = {"main": main_launches, **gate["launches"],
               **obs_row["launches"], "mesh": mesh_row["launches"],
               **run_row["launches"], **mon_row["launches"],
               "cli": sum(cli_row["launches"].values()),
               **cli_row["launches"], **camp_row["launches"],
               "batch": row["rollout_launches"],
               "independent": ind["rollout_launches"],
               **{c["model"]: c["rollout_launches"]
                  for c in queues["checks"] if "rollout_launches" in c},
               "streamlin": stream_launches, "txn": txn_launches}

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
        "fleet_worker_compile_laps": sum(
            1 for v in fleet_row["a"]["compile_lap_s"].values() if v > 0),
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
