#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``jepsen_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and exits non-zero without one, printing no result. It
imports neither JAX nor the JAX package. Phases, one JSON line each:

1. ``env``: the card (``nvidia-smi`` name and power limit, also printed
   raw on a line of its own), torch and CUDA versions, and the time to
   build every kernel from ``jepsen_tpu_torch/checker/csrc``.
2. ``kernels``: the rollout kernel against its plain PyTorch version on the
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
   run with ``rollout_kernel="scan"`` and must agree. Every search on
   the card runs its chunks as replays of a captured CUDA graph of one
   iteration (``checker/chunk_graph.py``).
3b. ``graph``: each case once in the eager loop
   (``torch_wgl.eager_chunks()``) and once as graph replays, the carries
   equal array for array at every chunk boundary, the results (verdicts,
   witnesses, iterations, explored counts, table statistics) and the
   rollout launches equal: the two main histories (cache hits of phase
   3's graphs), rung 0's history (``profile_main --rung 0``; a capture),
   the first 64 batch keys and 8 fifo and 8 unordered keys with the
   fast check off (16 iterations' budget) through the key batch at one
   iteration a chunk, through its compactions; then two threads
   checking the cas-register history at once, each holding a graph of
   its own, both results equal; the 64-key batch in two threads, the
   second taking the graph the first let go at its compaction while the
   first waits at its new width, both results equal; then one
   graph-path check profiled: at most ``GRAPH_MAX_HOST_LAUNCHES`` host
   launch calls per replayed iteration (a graph launch counts as 1),
   beside the graph's nodes and the card's idle share; last the 64-key
   batch in two threads at once with the graph cache bounded to 0
   bytes (every graph freed beside the other thread's captures), both
   results equal, then a device-wide sync and the cas-register search
   again. Captures, cache hits, replays and evictions per case.
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
   run unbound and once bound with ``phases?`` off, each warm, with
   every racer joined: the profiled kernels per iteration in the eager
   loop equal, and the torch ops per iteration equal on the graph path
   and in the eager loop, with the graph path's kernels and host launch
   calls (a graph launch counting as 1) beside them. (b) The first 64 batch keys through
   ``parallel.check_batch_encoded`` bound, at the gate's unplanned run's
   ``chunk_iters=1`` (its wall beside the gate's): verdicts equal to the
   gate's oracle, heartbeats with keys_alive, keys_running and compactions,
   explored never decreasing; one iteration bound with ``phases?`` off
   against one unbound, eager-loop kernels and torch ops equal. (c) The
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
   to the CPU oracle's, no fall-back, the fold kernel launched;
   seconds per event. (d) The
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
   --monitor-chunk 512 --concurrency 10n --per-key-limit 200
   --time-limit 10``: exit 0,
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
   local,local,local,local --backends gpu,cpu --worker-store <tmp>``
   (every cell a ``python -m jepsen_tpu_torch.fleet.worker`` process of
   its own, the four in one round) through ``__main__.main``: exit 0,
   every cell True and on the ``gpu`` tier, every run mirrored home, the
   audit and ``certify_campaign`` of all four runs without error, four
   worker lanes in the merged trace,
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
   one launch of the fold kernel ``csrc/fold.cu`` a fold) on keys of the
   batch above, through its entry points with the kernel's launches
   counted from 0: (a) the offline face at the hard frontier cap on
   ``OFFLINE_KEYS`` (one of them corrupted), each verdict equal to the
   CPU sweep's (``linear``) and each violating op the return at which
   the sweep fails; (b) one lane-batched fold of ``FOLD_BATCH_KEYS``
   keys' whole histories at ``FOLD_BATCH_F`` rows, every lane equal to
   its solo fold, only corrupted keys invalid, the lanes that
   overflowed listed, one launch and one host read: seconds and host
   syncs per event step; (c) ``StreamCheck`` on ``STREAM_KEYS`` (key 7)
   fed op by op, checked every ``STREAM_CHUNK`` completions, each
   verdict equal to the CPU WGL oracle's on the same prefix, no
   fall-back, the corrupted keys caught by the frontier and confirmed
   by the port's WGL engine: seconds, host syncs, launches, passes and
   frontier peak per event. Then (d), not counted, the kernel against
   its plain version (``fold_kernel.plain``), every output array
   bit-identical: each fold (a) makes at each frontier size the
   offline face grows through, (b)'s batch (kernel and plain ms, the
   bound, the latency floor: the longest lane's passes times two block
   barriers, ``jf_barrier_probe``), and each case of
   ``checker/fold_cases.py``, each also with the kernel's statistics on
   (outputs equal again): the split of the batch's longest lane's cycles
   by phase, and the kernel's branches the folds reached (a first pass
   that sorts its seen rows, passes whose pool sat in shared memory and
   in the global scratch, runs of equal h1 put in order), each case of
   ``fold_cases.BRANCHES`` raising its own. (b) and (c) are not
   profiled: gathering the profiler's events cost more than the run
   itself (PERF.md).
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

18. ``service``: checking as a service (``fleet/service.py``,
   ``web.py``) as its users drive it; see ``service_phase``. (a)
   ``SERVICE_TENANTS`` tenants, each with a token of its own, POST a
   keyed history of ``SERVICE_KEYS_PER`` batch keys to ``/api/check`` of
   an in-process ``web.serve`` (coalescing at its defaults), solo and
   then coalesced: every key equal to the gate's CPU oracle, the modes
   equal, a batch of at least two owners; checks per second, latency,
   batches, occupancy and queue wait per mode. (b) Txn tenants' closure
   probes coalesce on the card: verdicts and anomaly classes equal to
   ``cycle.append.check``. (c) ``SERVICE_STREAMS`` StreamChecks fed from
   a thread each ride the coalescer's fold lane, the corrupted key 7
   and two valid keys whole and the others a prefix: final
   verdicts equal to the CPU oracle's, each prefix's verdict and summary
   equal to the same stream folded solo, a fold batch of at least two
   streams, the fold kernel launched. (d) ``python
   -m jepsen_tpu_torch serve --token`` in a subprocess answers 401,
   200, 413 and ``/api/metrics``, and exits 0 on SIGINT. (e) A burst
   against a one-check budget sheds 429s with Retry-After; every 200 is
   right.
19. ``capacity``: the capacity planner's predictions
   (``analysis/sizemodel``) against the card's peak allocation above
   each step's baseline (``torch.cuda`` peak statistics, reset before
   each step), measured/predicted at most 1: (a) a solo search of the
   main cas-register history; (b) the batch phase's timed 256-key call,
   against the prediction at its runtime key axis and the per-lane
   prediction times that axis; (c) an 8,192-txn closure; (d) one fold at
   F=8192, one fold kernel launch. (e) ``campaign`` over two register
   cells with ``--capacity enforce --device-mem-budget 64G
   --device-slots auto``: exit 0, the
   slots resolved from the plan, the prediction oracle's error 0.0, the
   sweep's peak against the size model at the shapes its searches ran
   (their runtime key axes), beside the plan's per-lane cell figure; (f)
   the same with a budget below the peak cell: refused (254) before any
   cell runs. A prediction more than 2x above its measurement is listed
   in ``loose``. See ``capacity_phase``.
20. ``suites``: ``toystore test`` on 3 local nodes (8 s, kill nemesis,
   default algorithm): valid; with ``--stale``: exit 1, invalid;
   ``zookeeper test --stub`` for 130 s (a child process started before
   phase 16, so its run overlaps phases 16-20): linearizable through the
   rollout kernel (its perf graphs need matplotlib on the host); each
   path's rollout launches. The toystore runs need ``start-stop-daemon``
   and ``gcc`` on the host and are left out, with the reason, without
   them. See ``suites_phase``.
21. ``summary``: the store reader, ``python -m
   jepsen_tpu_torch.trace_summary``, in subprocesses over the stores
   phases 9, 12 and 19 wrote on the card (handed over by them in place
   of being removed): the monitored lost-write run (its sections, its op
   count equal to the history's client completions, the violation), the
   fleet sweep's merged trace (a lane per worker, a clean audit) and the
   planned sweep (its prediction error equal to ``report.json``'s); and,
   meanwhile, two threads through one ``concurrency_limit(1, ...)`` of
   the default gate on the main cas-register history: checks that do
   not overlap, the main phase's verdict. See ``summary_phase``.

The competition, checkpoint, certify, obs, mesh, run, monitor, cli,
campaign, service solo, capacity search, toystore, zookeeper stub and
concurrency_limit paths run the rollout kernel (each counted, the
stub's in its child; the fleet's in its worker processes, shown by
their compile laps, not counted here; ``run_keyed`` may not, as the
key batch rolls on the scan;
the monitor's txn paths do not; the capacity sweep's and the suites'
other paths are counted as they come). The planned, batch, independent,
queue,
streamlin, trend, txn, service coalesced and service txn paths do not
run it: each of them is run with the rollout kernel's launch count set
to 0 and must leave it at 0. The batch pins the scan rollout, as the JAX
package's does; the txn path has no linearizability search; the
streamlin path's only search is the confirm of a frontier violation, and
on the corrupted keys here ``torch_wgl``'s host pre-check
(``_state_abstraction_check``: a read of a value no reachable state
holds) decides it before any search starts, so its ``confirmed_by`` is
``aspect``. The fold kernel's paths (the streamlin phase's entry points,
the monitor's streamlin runs, the service's fold lane, the capacity
step's fold) are each run with its launch count set to 0 and must
launch it. Then a ``{"kernels": [...]}`` line (each kernel's launches in
its main path and on every path, rollout then fold) and, last,
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
#: the reference's fold is an XLA program, not a Pallas kernel
FOLD_REPLACES = "jepsen_tpu/checker/streamlin.py:124"
#: the graph phase: the single-key A/B's quantum (fixed, so that the eager
#: and the graph runs stop at the same chunk boundaries), the key batch's
#: keys, the queue batches' keys and their budget in iterations (cut from
#: the queues phase's 32 keys and 96 iterations: the A/B's eager side is
#: the launch-bound loop the graphs replace, ~0.3-0.7 s an iteration on
#: the scan path), and the most host launch calls a replayed iteration
#: may take
GRAPH_CHUNK, GRAPH_BATCH_KEYS = 4, 64
GRAPH_QUEUE_KEYS, GRAPH_QUEUE_ITERS = 8, 16
GRAPH_MAX_HOST_LAUNCHES = 10
#: the streamlin phase. The offline face runs key 0 and the corrupted
#: key 7 of the batch (key 15 was cut for the gate phase's room: its CPU
#: sweeps), the stream the corrupted key 7 (key 15 was cut for the
#: fleet phase's room; each is
#: checked about 20 times before its violation), both at the hard
#: frontier cap (with crashed ops left open, a 200-op key's closure can
#: outgrow the default cap of 4,096 configs); the lane batch runs the
#: first FOLD_BATCH_KEYS keys at FOLD_BATCH_F rows each, every lane held
#: against its solo fold; the stream is checked every STREAM_CHUNK
#: completions. Fewer keys than the batch's 256: the fold kernel takes
#: tens of ms for the batch, but the phase holds it against the plain
#: fold, a host loop of about 800 launches and 4 host reads per event
#: (PERF.md) that takes about 12 s for the batch alone. FOLD_BATCH_F
#: holds every one of the first 8 keys' closures but key 4's: the CPU
#: sweep's largest config set per return is 8,168 configs for key 0 and
#: 49,280 for key 4, so lane 4 overflows (status 2) and the batch says
#: which
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


def stream_sync():
    """Wait for this thread's work on the card: its current stream, where
    the port's searches run. Not the whole device: a device-wide
    synchronize fails beside another thread's capture of a search graph
    (a competition's straggling device racer, a concurrent search)."""
    import torch
    torch.cuda.current_stream().synchronize()


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
    stream_sync()
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
    stream_sync()
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


def carry_view(carry):
    """A search carry's arrays as ``torch_wgl.carry_to_numpy`` reads them
    (the sentinel rows dropped), left on the card."""
    from jepsen_tpu_torch.checker import torch_wgl as tw
    out = []
    for i, x in enumerate(carry):
        if i in (tw.IDX_BUF_LIN, tw.IDX_BUF_STATE, tw.IDX_BUF_FP):
            x = x[:-1]
        elif i == tw.IDX_TAB:
            x = x[:, :-1]
        out.append(x)
    return out


class ChunkTap:
    """A tap on every ``run_chunk`` of the port's searches (``torch_wgl``'s
    and the key batch's builds), for the graph phase's A/B: in
    ``"record"`` mode it keeps a copy, on the card, of the carry each
    chunk returns; in ``"compare"`` mode it holds each returned carry
    against the kept one of the same boundary, array for array
    (``torch.equal``); in ``"meet"`` mode each thread's first chunk waits
    at a two-party barrier, so two searches hold their graphs at once; in
    ``"stagger"`` mode the thread named ``graph-a`` sets ``moved`` after
    its first chunk at a new key count (a compaction) and waits for
    ``resume``. It notes which graph each chunk's lease held."""

    def __init__(self):
        self.mode, self.case = None, None
        self.kept, self.compared = [], 0
        self.owners = []
        self.barrier = None
        self._met = set()

    def start(self, mode, case):
        import threading
        self.mode, self.case = mode, case
        if mode == "record":
            self.kept = []
        self.compared = 0
        self.owners = []
        self.barrier = threading.Barrier(2, timeout=120)
        self._met = set()
        self.moved, self.resume = threading.Event(), threading.Event()
        self._first_k = None

    def hook(self, carry, lease):
        import threading
        import torch
        if self.mode == "record":
            self.kept.append([x.clone() for x in carry_view(carry)])
        elif self.mode == "compare":
            if self.compared >= len(self.kept):
                raise AssertionError(f"graph {self.case}: more chunk "
                                     f"boundaries than the eager run's "
                                     f"{len(self.kept)}")
            want = self.kept[self.compared]
            for i, (a, b) in enumerate(zip(carry_view(carry), want)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"graph {self.case}: carry array {i} differs from "
                        f"the eager loop's at chunk boundary "
                        f"{self.compared}")
            self.kept[self.compared] = None
            self.compared += 1
        name = threading.current_thread().name
        if lease is not None and lease.entry is not None:
            self.owners.append((name, id(lease.entry)))
        if self.mode == "meet" and name not in self._met:
            self._met.add(name)
            self.barrier.wait()
        if self.mode == "stagger" and name == "graph-a" \
                and not self.moved.is_set():
            from jepsen_tpu_torch.checker import torch_wgl as tw
            k = carry[tw.IDX_TOP].shape[0]
            if self._first_k is None:
                self._first_k = k
            elif k != self._first_k:
                self.moved.set()
                if not self.resume.wait(300):
                    raise AssertionError(f"graph {self.case}: never "
                                         f"resumed")

    def __enter__(self):
        from jepsen_tpu_torch.checker import torch_wgl
        from jepsen_tpu_torch.parallel import keyshard
        real = self._real = torch_wgl._build_search
        tap = self

        def build(*args, **kwargs):
            init, body, run = real(*args, **kwargs)

            def run_tapped(carry, consts, bound, lease=None):
                out = run(carry, consts, bound, lease)
                tap.hook(out, lease)
                return out

            run_tapped.uses_kernel = run.uses_kernel
            run_tapped.graph_key = run.graph_key
            return init, body, run_tapped

        torch_wgl._build_search = keyshard._build_search = build
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.checker import torch_wgl
        from jepsen_tpu_torch.parallel import keyshard
        torch_wgl._build_search = keyshard._build_search = self._real
        self.kept = []
        return False


def graph_ab(tap, case, run):
    """One search ``run()`` in the eager loop, then on the graph path:
    the carries equal at every chunk boundary, the results (verdicts,
    witnesses, iterations, explored counts, table statistics) equal, and
    the rollout kernel's launches equal. Returns the case's row and the
    result."""
    from jepsen_tpu_torch.checker import rollout, torch_wgl
    with torch_wgl.eager_chunks():
        tap.start("record", case)
        rollout.launches = 0
        t0 = time.monotonic()
        want = run()
        stream_sync()
        eager_s = time.monotonic() - t0
        eager_launches = rollout.launches
    boundaries = len(tap.kept)
    tap.start("compare", case)
    before = torch_wgl.chunk_graph.stats()
    rollout.launches = 0
    t0 = time.monotonic()
    got = run()
    stream_sync()
    graph_s = time.monotonic() - t0
    from jepsen_tpu_torch.profile_main import graphs_since
    graphs = graphs_since(before)
    if tap.compared != boundaries:
        raise AssertionError(f"graph {case}: {tap.compared} chunk "
                             f"boundaries against the eager run's "
                             f"{boundaries}")
    if got != want:
        raise AssertionError(f"graph {case}: the result differs from the "
                             f"eager loop's")
    if rollout.launches != eager_launches:
        raise AssertionError(f"graph {case}: {rollout.launches} rollout "
                             f"launches against the eager loop's "
                             f"{eager_launches}")
    if graphs["replays"] == 0 and boundaries > 1:
        raise AssertionError(f"graph {case}: no chunk ran as a replay")
    results = want if isinstance(want, list) else [want]
    return {"case": case, "boundaries": boundaries,
            "eager_s": eager_s, "graph_s": graph_s,
            "rollout_launches": eager_launches,
            "iterations": max(r.get("iterations") or 0 for r in results),
            "verdicts": sorted({str(r["valid"]) for r in results}),
            "graphs": graphs}, want


def graph_phase(dev, keys, batch_keys=GRAPH_BATCH_KEYS,
                queue_keys=GRAPH_QUEUE_KEYS, queue_iters=GRAPH_QUEUE_ITERS,
                n_ops=10_000, rung0_ops=None):
    """The search chunk as graph replays against the eager loop it
    replaces (``checker/chunk_graph.py``): each case runs once with
    ``torch_wgl.eager_chunks()`` and once on the graph path, with the
    carries equal at every chunk boundary, the results and the rollout
    launches equal (``graph_ab``). (a) The two main histories at
    ``GRAPH_CHUNK`` iterations a chunk (the shapes phase 3 already
    captured: cache hits); (b) rung 0's history (``profile_main --rung
    0``; a new shape: an eager first iteration, then a capture); (c) the
    first ``batch_keys`` batch keys and (d) ``queue_keys`` fifo and
    unordered keys (fast check off, ``queue_iters`` iterations' budget)
    through ``parallel.check_batch_encoded`` at one iteration a chunk
    (compaction widths each get a graph); (e) two threads checking the
    cas-register main history at once, each holding a graph of its own
    (their first chunks meet at a barrier), both results equal (a)'s;
    (f) (c)'s batch in two threads, the second started once the first
    has compacted and run to its end while the first waits: it takes
    the graph the first let go (a compacted carry keeps the table and
    the counters of the width it leaves), both results equal (c)'s
    (``two_batches``); (g) one graph-path check of the cas-register
    main history under ``torch.profiler``: the host's launch calls per
    iteration beside the graph's nodes and kernel launches, and the
    card's idle share; (h) (c)'s batch in two threads at once with the
    cache bounded to 0 bytes, so each graph is freed as its search lets
    it go beside the other thread's captures: both results equal (c)'s,
    then a device-wide sync and (a)'s cas-register search again."""
    import threading

    import torch
    from jepsen_tpu_torch import models, parallel, simulate
    from jepsen_tpu_torch.checker import rollout, torch_wgl
    from jepsen_tpu_torch.profile_main import (graphs_since, profile_call,
                                               rung0_history, split)
    t_start = time.monotonic()
    before = torch_wgl.chunk_graph.stats()
    out = {"phase": "graph", "cases": []}
    main = {}
    with ChunkTap() as tap:
        # (a) the main histories
        for model, crash_p in MAIN_HISTORIES:
            spec = models.model_spec(model)
            e, st = spec.encode(simulate.random_history(
                random.Random(45100), model, 64, n_ops, crash_p))
            row, want = graph_ab(tap, model, lambda: torch_wgl.check_encoded(
                spec, e, st, chunk_iters=GRAPH_CHUNK, device=dev))
            if want["valid"] is not True:
                raise AssertionError(f"graph {model}: {want['valid']!r}")
            main[model] = (spec, e, st, want)
            out["cases"].append(row)
        # (b) rung 0
        spec = models.cas_register_spec
        e, st = spec.encode(rung0_history(*(
            (rung0_ops,) if rung0_ops else ())))
        row, want = graph_ab(tap, "rung0", lambda: torch_wgl.check_encoded(
            spec, e, st, timeout_s=120, chunk_iters=GRAPH_CHUNK,
            device=dev))
        if want["valid"] is not True:
            raise AssertionError(f"graph rung 0: {want['valid']!r}")
        out["cases"].append(row)
        # (c) the key batch
        pairs = [spec.encode(h) for h in keys[:batch_keys]]

        def batch():
            return parallel.check_batch_encoded(spec, pairs, chunk_iters=1,
                                                device=dev)
        row, batch_want = graph_ab(tap, f"batch{batch_keys}", batch)
        out["cases"].append(row)
        # (d) the queue batches
        for name in QUEUES:
            search = dataclasses.replace(models.model_spec(name),
                                         fast_check=None)
            rng = random.Random(45100)
            hists = []
            for k in range(queue_keys):
                hist = simulate.random_history(rng, name, 6, QUEUE_OPS, 0.02)
                hists.append(simulate.corrupt(rng, hist)
                             if k % CORRUPT_EVERY == CORRUPT_EVERY - 1
                             else hist)
            qpairs = [search.encode(h) for h in hists]
            row, _ = graph_ab(tap, name, lambda: parallel.check_batch_encoded(
                search, qpairs, max_configs=queue_iters * 128 * queue_keys,
                chunk_iters=1, device=dev))
            out["cases"].append(row)
        # (e) two threads, one shape
        spec, e, st, want = main["cas-register"]
        tap.start("meet", "two-threads")
        got, errors = {}, []
        rollout.launches = 0

        def search(i):
            try:
                got[i] = torch_wgl.check_encoded(spec, e, st, device=dev)
            except Exception as exc:  # noqa: BLE001 - raised below
                errors.append(exc)

        before2 = torch_wgl.chunk_graph.stats()
        t0 = time.monotonic()
        threads = [threading.Thread(target=search, args=(i,),
                                    name=f"graph-search-{i}")
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        two_s = time.monotonic() - t0
        launched = rollout.launches
        if errors:
            raise errors[0]
        if got[0] != want or got[1] != want:
            raise AssertionError("graph two-threads: a result differs from "
                                 "the single search's")
        held = {}
        for name, eid in tap.owners:
            held.setdefault(name, set()).add(eid)
        if len(held) != 2 or set.intersection(*held.values()):
            raise AssertionError(f"graph two-threads: the searches did not "
                                 f"each hold a graph of their own: {held}")
        single = next(c for c in out["cases"]
                      if c["case"] == "cas-register")["rollout_launches"]
        if launched != 2 * single:
            raise AssertionError(f"graph two-threads: {launched} rollout "
                                 f"launches, not twice {single}")
        out["two_threads"] = {"wall_s": two_s, "rollout_launches": launched,
                              "graphs": graphs_since(before2)}
        # (f) a batch that takes the graph another one let go at its
        # compaction, while that one goes on at its new width
        tap.start("stagger", "stagger")
        out["stagger"] = two_batches(tap, batch, batch_want, stagger=True)
    # (g) the host's launch calls on the graph path
    before3 = torch_wgl.chunk_graph.stats()
    r, wall, ev = profile_call(lambda: torch_wgl.check_encoded(
        spec, e, st, device=dev), host_ops=False)
    st_ = split(ev, r.get("iterations"))
    out["profiled"] = {"model": "cas-register", "wall_s": wall,
                       "iterations": r.get("iterations"),
                       "graphs": graphs_since(before3),
                       **{k: st_[k] for k in (
                           "host_launches", "host_launches_per_iteration",
                           "graph_launches",
                           "host_launches_per_replayed_iteration",
                           "kernel_launches",
                           "kernel_launches_per_iteration",
                           "search_loop_s", "device_busy_s",
                           "device_idle_share_in_search_loop")}}
    if dev.type == "cuda":
        per = out["profiled"]["host_launches_per_replayed_iteration"]
        if per is None or per > GRAPH_MAX_HOST_LAUNCHES:
            raise AssertionError(f"graph: the host issued {per} launch "
                                 f"calls per replayed iteration")
    # (h) two batches at once with no room for idle graphs: each graph is
    # freed as its search lets it go, beside the other thread's captures
    with ChunkTap() as tap, torch_wgl.chunk_graph.bounded(0):
        tap.start("meet", "evicting")
        out["evicting"] = two_batches(tap, batch, batch_want, stagger=False)
    if out["evicting"]["graphs"]["evictions"] \
            < out["evicting"]["graphs"]["captures"]:
        raise AssertionError(f"graph evicting: {out['evicting']}")
    if dev.type == "cuda":
        # the card is sound after it: a device-wide sync (no capture is
        # open now), then (a)'s cas-register search again
        torch.cuda.synchronize()
        if torch_wgl.check_encoded(spec, e, st, device=dev) != want:
            raise AssertionError("graph evicting: the cas-register search "
                                 "differs afterwards")
        torch.cuda.empty_cache()
    out["graphs"] = graphs_since(before)
    out["seconds"] = time.monotonic() - t_start
    return out


def two_batches(tap, batch, want, stagger):
    """``batch()`` in two threads, ``graph-a`` and ``graph-b``, each
    result equal to ``want``. With ``stagger``, ``graph-b`` starts once
    ``graph-a`` has moved to a compacted width (``ChunkTap``'s
    ``"stagger"`` mode), runs to its end while ``graph-a`` waits, and
    must have taken a cached graph (the one ``graph-a`` let go); else
    both start together and meet at their first chunks."""
    import threading

    from jepsen_tpu_torch.checker import torch_wgl
    from jepsen_tpu_torch.profile_main import graphs_since
    got, errors = {}, []

    def run(name):
        try:
            got[name] = batch()
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)
            tap.moved.set()

    before = torch_wgl.chunk_graph.stats()
    t0 = time.monotonic()
    a = threading.Thread(target=run, args=("a",), name="graph-a")
    b = threading.Thread(target=run, args=("b",), name="graph-b")
    a.start()
    b_graphs = None
    if stagger:
        if not tap.moved.wait(300):
            raise AssertionError("graph stagger: graph-a never compacted")
        b.start()
        b.join()
        b_graphs = graphs_since(before)
        tap.resume.set()
    else:
        b.start()
        b.join()
    a.join()
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if got.get("a") != want or got.get("b") != want:
        raise AssertionError(f"graph {tap.case}: a batch's results differ "
                             f"from the eager loop's")
    if stagger and not b_graphs["hits"]:
        raise AssertionError("graph stagger: graph-b took no cached graph")
    return {"wall_s": wall, "graphs": graphs_since(before),
            **({"b_graphs": b_graphs} if stagger else {})}


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


class TorchOps:
    """Counts the torch ops a thread issues while the block runs (views
    excluded: they launch nothing on the card), through a
    ``TorchDispatchMode``; ``n`` is the count."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not func.is_view:
                    counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def kernels_per_iteration(run, iterations):
    """Launches per iteration of ``run``, each measured after a warm-up
    call of the same form, with every competition racer joined first:
    ``(kernels in the eager loop, wall, kernels on the graph path, host
    launch calls on the graph path, torch ops on the graph path, torch
    ops in the eager loop, the eager loop's kernels by name)``. Kernels
    and host calls come from one profiled call each; on the graph path a
    search's iteration is a graph replay, whose kernels are its graph's
    nodes and which the host launches with one call
    (``profile_main.host_launches``). The eager loop
    (``torch_wgl.eager_chunks``) launches each of its kernels from the
    host, as the parent's main path did; ``TorchOps`` counts the torch
    ops dispatched. ``run`` must stop at the same chunk boundaries each
    time (each boundary's status read launches kernels of its own), and
    no other thread may launch work while it is profiled: the profiler
    records the whole card, so a competition's straggling device racer
    would add the kernels of its last chunk."""
    import collections

    from jepsen_tpu_torch.checker import checkers, torch_wgl
    from jepsen_tpu_torch.profile_main import host_launches, profile_call
    n = max(1, iterations)

    def profiled():
        checkers.join_racers()
        stream_sync()
        return profile_call(run, host_ops=False)

    run()
    _, _, ev = profiled()
    calls = host_launches(ev, n)["host_launches_per_iteration"]
    with TorchOps() as ops:
        run()
    with torch_wgl.eager_chunks():
        run()
        _, wall, eager_ev = profiled()
        with TorchOps() as eager:
            run()
    names = collections.Counter(e[2][:60] for e in eager_ev if e[3])
    return (sum(e[3] for e in eager_ev) / n, wall,
            sum(e[3] for e in ev) / n, calls, ops.n / n, eager.n / n,
            names)


def kernel_gate(what, prof):
    """Fail unless the bound and the unbound run of ``prof``
    (``kernels_per_iteration``'s tuples) launched as many kernels in the
    eager loop and dispatched as many torch ops on both paths; names the
    kernels that differ."""
    a, b = prof["unbound"], prof["phases_off"]
    if a[0] != b[0] or a[4:6] != b[4:6]:
        diff = {k: b[6][k] - a[6][k] for k in set(a[6]) | set(b[6])
                if a[6][k] != b[6][k]}
        raise AssertionError(
            f"{what}: eager kernels {a[0]} unbound, {b[0]} phases off; "
            f"torch ops {a[4:6]} against {b[4:6]}; eager kernels by name, "
            f"phases off less unbound: {diff}")


def kernel_row(v):
    return {"kernels_per_iteration": v[0], "wall_s": v[1],
            "graph_kernels_per_iteration": v[2],
            "host_launches_per_iteration": v[3],
            "torch_ops_per_iteration": v[4],
            "eager_torch_ops_per_iteration": v[5]}


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
    off the eager loop's kernels per iteration equal and the torch ops
    per iteration equal on both paths (``kernels_per_iteration``). (b) The first ``gate_keys``
    batch keys through ``parallel.check_batch_encoded`` bound at
    ``chunk_iters=1``, as the gate's unplanned run (``gate_batch_s``):
    verdicts equal to the gate's (``gate_verdicts``), heartbeats with
    keys_alive, keys_running and compactions, explored never decreasing;
    one iteration bound with ``phases?`` off against one unbound, the
    same comparison. (c) The
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
    from jepsen_tpu_torch import profile_main, simulate, store
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
            # one chunk: the first quantum (32 iterations) outlasts the
            # search, so the host's clock decides no boundary
            prof["unbound"] = kernels_per_iteration(
                lambda: chk.check({}, hist), its)
            with obs.run_scope({"phases?": False}):
                prof["phases_off"] = kernels_per_iteration(
                    lambda: chk.check({}, hist), its)
            kernel_gate("obs", prof)
        out["single_key"] = {"checks": rows, "profiled": {
            k: kernel_row(v) for k, v in prof.items()}}

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
            kernel_gate("obs batch", bprof)
        out["batch"] = {
            "keys": len(pairs), "wall_s": bwall, "chunk_iters": 1,
            "gate_unplanned_batch_s": gate_batch_s, "heartbeats": len(hb),
            "compactions": hb[-1]["compactions"],
            "iterations": max(r.get("iterations") or 0 for r in res),
            "first_iteration": {k: kernel_row(v)
                                for k, v in bprof.items()}}
        # the profiler's lost records, over every profiled call so far:
        # its primers take them (``profile_main.PRIMERS``)
        out["profiler"] = {
            "primers_launched": profile_main.primers_launched,
            "primer_records_lost": profile_main.primer_records_lost}

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
                  txns=MONITOR_TXNS, bad_txns=MONITOR_BAD_TXNS, kept=None):
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
    equal to the CPU oracle's on the recorded history, no fall-back, the
    fold kernel launched (on the card).
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
    stay 0. With ``kept`` (``KeptStores``) the temporary store is handed
    over with (b)'s run directory for the summary phase, not removed."""
    import itertools
    import shutil
    import tempfile
    from jepsen_tpu_torch import core, cycle, nemesis, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import tests as tst
    from jepsen_tpu_torch.checker import checkers, fold_kernel, rollout
    from jepsen_tpu_torch.tests.cycle import append as append_workload
    IndeterminateClient, _, LostWriteClient = run_clients()
    ListAppendClient = txn_clients()
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    engine_opts = {} if cuda else {"device": "cpu"}
    base = store.base_dir
    store.base_dir = tempfile.mkdtemp(prefix="jepsen-monitor-")
    out = {"phase": "monitor"}
    launches, fold_launches = {}, {}
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
        fold_kernel.launches = 0
        at_analyze.clear()
        t0 = time.monotonic()
        test = core.run(t)
        sync(dev)
        wall = time.monotonic() - t0
        checkers.join_racers()
        launches[path] = rollout.launches
        fold_launches[path] = fold_kernel.launches
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
            "fold_launches": fold_kernel.launches,
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
        read = {"run_dir": store.path(test), "client_ops": sum(
            o["type"] != "invoke" for o in client_ops)}
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
            if cuda and row["fold_launches"] <= 0:
                raise AssertionError(f"monitor streamlin {what}: the fold "
                                     f"kernel was not launched")
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
        if kept is not None and "lost_write" in out:
            kept.keep(store.base_dir, monitor=read)
        else:
            shutil.rmtree(store.base_dir, ignore_errors=True)
        store.base_dir = base
    out["launches"] = launches
    out["fold_launches"] = fold_launches
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
#: the monitor's check cadence in the cli phase's (a) and the campaign
#: phase's (a), in completions: with 5 keys in flight a check then takes
#: ~100 new completions of a key, so its window passes the 64 ops past
#: which a search rolls chains and launches the rollout kernel (at the
#: default 64, a monitor whose checks keep up checks windows that roll
#: none)
MONITORED_CHUNK = 512
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
    --monitor --monitor-chunk 512 --concurrency 10n --per-key-limit
    200``: exit 0, valid, the
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
    from jepsen_tpu_torch.checker import checkers, rollout, torch_wgl
    from jepsen_tpu_torch.obs import profile as obs_profile
    from jepsen_tpu_torch.profile_main import graphs_since, kernel_stats
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
        before = torch_wgl.chunk_graph.stats()
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
               "graphs": graphs_since(before),
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
        test, row = run("a", demo_main.main,
                        ["test"] + register(time_limit)
                        + ["--monitor-chunk", str(MONITORED_CHUNK)], 0)
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
    --parallel 2 --device-slots 1 --monitor --monitor-chunk 512`` in
    process through
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
    from jepsen_tpu_torch.checker import checkers, rollout, torch_wgl
    from jepsen_tpu_torch.monitor import engine as mengine
    from jepsen_tpu_torch.profile_main import graphs_since
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
            "--monitor", "--monitor-chunk", str(MONITORED_CHUNK),
            "--concurrency", "10n", "--per-key-limit",
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
        before = torch_wgl.chunk_graph.stats()
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
        graphs = graphs_since(before)
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
            "exit": code, "wall_s": wall, "graphs": graphs,
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
#: one worker per cell of the matrix: the four cells start in one round
#: (two workers took two rounds, each mostly a process's start-up, cut
#: for the service phase's room; PERF.md)
FLEET_WORKERS = "local,local,local,local"


def fleet_phase(dev, time_limit=CAMPAIGN_TIME_LIMIT, per_key=CAMPAIGN_PER_KEY,
                kill_seed=FLEET_KILL_SEED, kept=None):
    """The fleet (``jepsen_tpu_torch/fleet``): campaign (a)'s matrix with
    every cell in a worker process of its own, its store in a temporary
    directory. (a) ``campaign --no-ssh --axis workload=register,append
    --seeds 2 --monitor --concurrency 10n --per-key-limit 200
    --time-limit 3 --workers local,local,local,local --backends gpu,cpu
    --worker-store <tmp>`` through ``__main__.main``: exit 0, every
    cell's record on the ``gpu`` tier (``cpu`` in a CPU rehearsal) and
    True, every run mirrored home by the artifact sync, the finalize
    audit without error, ``certify_campaign`` of all four mirrored runs
    without error, four worker lanes in ``campaign_trace.jsonl``, and at
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
    which this script's counter does not see: it must stay at 0. With
    ``kept`` (``KeptStores``) the temporary store is handed over with
    (a)'s campaign directory for the summary phase, not removed."""
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
            str(time_limit), "--workers", FLEET_WORKERS, "--backends",
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
        if sorted(trace.get("workers") or {}) \
                != ["local", "local#2", "local#3", "local#4"]:
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
                cells, fleet.parse_workers(FLEET_WORKERS),
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
        if kept is not None and "a" in out:
            kept.keep(tmp, fleet={
                "campaign_dir": store.campaign_path("fleet"),
                "workers": sorted(out["a"]["trace"]["workers"])})
        else:
            shutil.rmtree(tmp, ignore_errors=True)
        store.base_dir = base
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
    from jepsen_tpu_torch.campaign import compile_cache
    from jepsen_tpu_torch.checker import rollout
    from jepsen_tpu_torch.profile_main import profile_batch
    spec = models.cas_register_spec
    pairs = [spec.encode(h) for h in keys]
    n_ops = sum(len(e) for e, _ in pairs)
    prof = profile_batch(spec, pairs)                   # warms up too
    stream_sync()
    rollout.launches = 0
    dev = torch.device("cuda")
    t0 = time.monotonic()
    # the capacity phase's (b): the timed call's peak above its baseline
    # and the plan key the batch noted (its runtime key axis)
    noted = compile_cache.noted_counts()
    res, peak = mem_step(dev, lambda: parallel.check_batch_encoded(
        spec, pairs))
    wall = time.monotonic() - t0
    plan_key = batch_plan_key(compile_cache.noted_since(noted))
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
           "top_kernels": prof["top_kernels"][:5],
           "peak_bytes": peak, "plan_key": plan_key}
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
        stream_sync()
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
    if dev.type == "cuda":
        stream_sync()


def fold_bound(args, out):
    """The least time the card could take for one fold on these inputs:
    the bytes the function must move (each input read once, the upload
    of fingerprint multipliers and events included, each output written
    once) over HBM_BYTES_PER_S, or the operations this run's data needs
    (OPS_PER_OP for each candidate the closures evaluate: the ``steps``
    the fold reports) over INT_OPS_PER_S, whichever is larger. Returns
    (bound_ms, bound_by)."""
    _step, arrays, kinds, _slots, _C = args
    K, F, B = arrays["lin"].shape
    S = arrays["st"].shape[2]
    nbytes = sum(x.numel() * x.element_size() for x in arrays.values()) \
        + 4 * (4 * (B + S) + 2 * kinds.size) \
        + sum(x.numel() * x.element_size() for x in out[:4]) + 4 * 5 * K
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_OP * int(out[7].sum()) / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def fold_parity(args, dev, what, reps=0):
    """The fold kernel against its plain version on one fold's inputs on
    the card: every output array equal (dtype and values), else raise,
    with the kernel's statistics off and on (``fold_kernel.run``'s
    ``clocks``). The launches made here are not counted: the kernel's
    count is put back. ``kernel_ms`` is the mean of ``reps`` calls (1
    when 0) after the first, timed with CUDA events (the host clock off
    the card), the upload of events included, statistics off;
    ``plain_ms`` one call of ``fold_kernel.plain`` on the host clock,
    ending in a synchronize. On the card the row also carries the
    statistics: ``split``, the longest lane's phases as shares of its
    cycles and its counts (``fold_ab.split``), and ``stats``, each count
    summed over the lanes."""
    import torch
    from jepsen_tpu_torch.checker import fold_ab, fold_kernel
    saved = fold_kernel.launches
    cuda = dev.type == "cuda"
    clocks = None
    try:
        got = fold_kernel.run(*args)
        sync(dev)
        n = max(1, reps)
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.monotonic()
        for _ in range(n):
            fold_kernel.run(*args)
        if cuda:
            b.record()
            b.synchronize()
            kernel_ms = a.elapsed_time(b) / n
            clocked, clocks = fold_ab.stats(args, dev)
        else:
            kernel_ms = (time.monotonic() - t0) * 1e3 / n
            clocked = got
    finally:
        fold_kernel.launches = saved
    t0 = time.monotonic()
    want = fold_kernel.plain(*args)
    sync(dev)
    plain_ms = (time.monotonic() - t0) * 1e3
    names = ("lin", "st", "live", "open_w", "status", "viol", "passes",
             "steps", "n_live")
    bad = [n for out in (got, clocked)
           for n, g, w in zip(names, out, want)
           if g.dtype != w.dtype or not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"fold kernel {what}: {bad} differ from the "
                             f"plain fold")
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    bound_ms, bound_by = fold_bound(args, got)
    K, F, B = args[1]["lin"].shape
    row = {"what": what, "K": K, "F": F, "B": B,
           "S": args[1]["st"].shape[2], "C": int(args[4]),
           "E": int(args[2].shape[1]), "status": got[4].tolist(),
           "passes": got[6].tolist(), "max_abs_err": err,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "passes_max": int(got[6].max())}
    if clocks is not None:
        row["split"] = fold_ab.split(clocks)
        row["stats"] = dict(zip(fold_kernel.STAT_NAMES,
                                (int(x) for x in clocks.sum(0))))
    return row


def fold_branches(rows):
    """The fold kernel's branches the parity folds reached (each count
    summed over ``rows``' statistics): the first pass of a return that
    sorts its seen rows with its candidates, passes whose pool sat in
    shared memory and in the global scratch, the runs of equal h1 put in
    order. Raises if one was not reached, or if a case of
    ``fold_cases.BRANCHES`` did not raise its own."""
    from jepsen_tpu_torch.checker import fold_cases
    total = {}
    for r in rows:
        for k, v in r["stats"].items():
            total[k] = total.get(k, 0) + v
        want = fold_cases.BRANCHES.get(r["what"])
        if want is not None and r["stats"][want] <= 0:
            raise AssertionError(f"fold case {r['what']}: the kernel's "
                                 f"{want} stayed 0")
    out = {"full_sort_passes": total["full_sort_passes"],
           "shared_pool_passes": total["passes"]
           - total["global_pool_passes"],
           "global_pool_passes": total["global_pool_passes"],
           "fixup_passes": total["fixup_passes"],
           "multi_tile_passes": total["multi_tile_passes"],
           "in_place_passes": total["in_place_passes"]}
    missed = [k for k, v in out.items()
              if v <= 0 and k not in ("multi_tile_passes", "in_place_passes")]
    if missed:
        raise AssertionError(f"fold kernel: branches not reached: {missed}")
    return out


def fold_entry(stream_row, mon_row, svc_row, cap_row):
    """The fold kernel's entry of the ``kernels`` line: its launches on
    each path that folds (each counted from 0 just before the path ran:
    the streamlin phase's entry points, the monitor's streamlin runs, the
    service's fold lane, the capacity step's fold), and its numbers at
    the lane batch's shape from the streamlin phase."""
    k = stream_row["fold_kernel"]
    by_path = {"streamlin": k["launches"],
               **{p: mon_row["fold_launches"][p]
                  for p in ("monitor_streamlin",
                            "monitor_streamlin_violation")},
               **svc_row["fold_launches"], **cap_row["fold_launches"]}
    if any(v <= 0 for v in by_path.values()):
        raise AssertionError(f"fold kernel: a path launched it no time: "
                             f"{by_path}")
    return {"name": "fold", "route": "cuda",
            "source": "jepsen_tpu_torch/checker/csrc/fold.cu",
            "replaces": FOLD_REPLACES,
            "launches": k["launches"], "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
            "latency_floor_ms": k["latency_floor_ms"],
            "barrier_ns": k["barrier_ns"], "shape": k["shape"],
            "launches_per_fold": k["launches_per_fold"],
            "host_reads_per_fold": k["host_reads_per_fold"],
            "s_per_event_step": k["s_per_event_step"],
            "parity": "exact",
            "cases": len(stream_row["parity"]["cases"])}


def streamlin_phase(keys, dev, offline_keys=OFFLINE_KEYS,
                    stream_keys=STREAM_KEYS, batch_keys=FOLD_BATCH_KEYS,
                    batch_f=FOLD_BATCH_F):
    """The streaming frontier fold on the batch keys, first through its
    entry points with the fold kernel's launches counted from 0: (a) the
    offline face on ``offline_keys`` against the CPU sweep (``linear``):
    equal verdicts, and on the corrupted keys the violating op is the
    return at which the sweep fails; (b) one lane-batched fold over the
    first ``batch_keys`` keys' whole histories at ``batch_f`` rows, one
    timed call (not profiled: gathering its events took 23 s), each lane
    equal to its solo fold; (c) ``StreamCheck`` fed ``stream_keys`` op
    by op, checked every STREAM_CHUNK completions, each verdict equal to
    the CPU WGL oracle's on the same prefix, the corrupted keys caught by
    the frontier and confirmed by the port's WGL engine (``torch_wgl``).
    The stream's seconds are those of its own offers and checks, without
    the oracle's. On the card every fold of (a)-(c) launches the kernel
    once and reads its results once. Then (d), not counted, the kernel
    against its plain version (``fold_parity``): every fold (a) makes at
    each frontier size the offline face grows through, (b)'s batch
    (timed: kernel and plain ms, the bound and the latency floor), and
    each case of ``checker/fold_cases.py``; on the card the batch's
    phase split and the branches reached (``fold_branches``)."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checker import (fold_cases, fold_kernel, linear,
                                          streamlin)
    from jepsen_tpu_torch.monitor import StreamCheck
    from jepsen_tpu_torch.monitor import engine as mengine
    spec = models.cas_register_spec
    cuda = dev.type == "cuda"
    def corrupted(ks):
        return [k for k in ks if k % CORRUPT_EVERY == CORRUPT_EVERY - 1]
    pairs = [spec.encode(h) for h in
             keys[:max(batch_keys, *offline_keys, *stream_keys) + 1]]
    fold_kernel.launches = 0
    fold_kernel.plain_folds = 0

    # (a) the offline face
    t_start = time.monotonic()
    offline, offline_s, oracle_s = [], 0.0, 0.0
    streamlin.syncs = 0
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
    offline_launches, offline_syncs = fold_kernel.launches, streamlin.syncs

    # (b) one lane-batched fold over the first batch_keys whole histories
    jobs = [streamlin.history_job(spec, e, st, batch_f, dev)
            for e, st in pairs[:batch_keys]]
    C = max(j.C for j in jobs)
    for j in jobs:
        j.C = C                      # one shape: one fold of K lanes
    streamlin.syncs = 0
    l0 = fold_kernel.launches
    t0 = time.monotonic()
    res = streamlin.batch_fold(jobs)
    sync(dev)
    wall = time.monotonic() - t0
    syncs, batch_launches = streamlin.syncs, fold_kernel.launches - l0
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
             "launches": batch_launches,
             # over the lanes whose frontier held (an overflowed lane
             # stops at its overflow)
             "passes_max": max(r["passes"] for r in held),
             "passes_total": sum(r["passes"] for r in held),
             "final_frontier_max": max(r["n_live"] for r in held),
             "invalid_lanes": invalid, "overflowed_lanes": overflowed,
             "solo_s": solo_s}
    if cuda and (batch_launches, syncs) != (1, 1):
        raise AssertionError(f"batch fold: {batch_launches} launches and "
                             f"{syncs} host reads, expected 1 and 1")

    # (c) StreamCheck op by op
    streamlin.syncs = 0
    l0 = fold_kernel.launches
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
                 "launches": fold_kernel.launches - l0,
                 "passes_per_event": sum(r["fold_passes"] for r in rows)
                 / events,
                 "frontier_peak": max(r["frontier_peak"] for r in rows),
                 "streams": rows}
    launches = fold_kernel.launches
    if cuda and (launches <= 0 or fold_kernel.plain_folds):
        raise AssertionError(f"streamlin: {launches} fold kernel launches, "
                             f"{fold_kernel.plain_folds} plain folds on "
                             f"the card")
    entry_s = time.monotonic() - t_start

    # (d) the kernel against its plain version (not counted)
    parity = {"offline": [], "cases": []}
    t0 = time.monotonic()
    for k in offline_keys:
        e, st = pairs[k]
        F = streamlin.FRONTIER_FLOOR
        while True:
            job = streamlin.history_job(spec, e, st, F, dev)
            row = fold_parity(streamlin.fold_inputs([job]), dev,
                              f"offline key {k} F={F}")
            parity["offline"].append(row)
            if row["status"][0] != 2 or F >= streamlin.FRONTIER_CAP_MAX:
                break
            F *= 2
    parity["batch"] = fold_parity(streamlin.fold_inputs(jobs), dev,
                                  "batch", reps=3)
    for case in fold_cases.cases(dev):
        row = fold_parity(streamlin.fold_inputs(case.jobs), dev, case.name)
        if tuple(row["status"][:len(case.jobs)]) != case.status:
            raise AssertionError(f"fold case {case.name}: status "
                                 f"{row['status']}, expected {case.status}")
        parity["cases"].append(row)
    if cuda:
        parity["branches"] = fold_branches(
            parity["offline"] + [parity["batch"]] + parity["cases"])
    parity["seconds"] = time.monotonic() - t0
    b = parity["batch"]
    # a lane's passes are a dependent chain, and a pass needs at least two
    # block-wide barriers (every candidate before the dedup, the
    # compaction before the next pass): the longest lane's passes times
    # two barriers of this card is the least time the batch can take
    bns = fold_kernel.barrier_ns(dev) if cuda else None
    kernel = {"launches": launches,
              "launches_per_fold": batch_launches,
              "host_reads_per_fold": syncs,
              "offline_launches": offline_launches,
              "offline_host_reads": offline_syncs,
              "kernel_ms": b["kernel_ms"], "plain_ms": b["plain_ms"],
              "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
              "barrier_ns": bns,
              "latency_floor_ms": None if bns is None
              else b["passes_max"] * 2 * bns / 1e6,
              "shape": {f: b[f] for f in ("K", "F", "B", "S", "C", "E")},
              "split": b.get("split"),
              "s_per_event_step": b["kernel_ms"] / 1e3 / E,
              "plain_s_per_event_step": b["plain_ms"] / 1e3 / E,
              "max_abs_err": max(r["max_abs_err"] for r in
                                 parity["offline"] + parity["cases"]
                                 + [b])}
    return {"phase": "streamlin", "seconds": time.monotonic() - t_start,
            "entry_s": entry_s,
            "offline": offline, "offline_s": offline_s,
            "offline_oracle_s": oracle_s, "batch": batch,
            "streaming": streaming, "fold_kernel": kernel,
            "parity": parity}


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


#: the service phase (``jepsen_tpu_torch/fleet/service.py``, ``web.py``):
#: SERVICE_TENANTS client threads each POST one keyed history of
#: SERVICE_KEYS_PER keys of the batch above (32 keys, the gate's oracle
#: covers them); SERVICE_TXN_TENANTS txn tenants of SERVICE_TXNS
#: list-append txns, every other one with a G1c cycle between the first
#: txns of keys SERVICE_TXN_G1C; SERVICE_STREAMS StreamChecks over the
#: first keys, checked every STREAM_CHUNK completions, at the hard
#: frontier cap as in the streamlin phase; and the admission burst. The
#: keys of SERVICE_STREAMS_WHOLE are streamed whole: the corrupted key 7,
#: whose frontier empties at event 326 of 400, and the valid keys 3 and
#: 14 (frontiers of at most 192 and 320 rows) beside it, so that the
#: folds that catch the violation hold valid lanes too. The other keys
#: stream their first SERVICE_STREAM_EVENTS events: whole, the 16 keys'
#: frontiers reach 65,536 rows (key 4) and the fold lane took 68.2 s; the
#: corrupted key 15 whole (its frontier empties at event 387, at 5,376
#: rows) paced every batch and held the lane to 28.7 s (PERF.md). Each
#: mode's untimed first request checks the first SERVICE_WARM_EVENTS
#: events of key 0
SERVICE_TENANTS, SERVICE_KEYS_PER = 8, 4
SERVICE_TXN_TENANTS, SERVICE_TXNS, SERVICE_TXN_G1C = 4, 1024, (512, 520)
SERVICE_STREAMS, SERVICE_STREAM_EVENTS, SERVICE_BURST = 16, 32, 8
SERVICE_STREAMS_WHOLE = (3, 7, 14)
#: a stream's summary fields that say which path its folds took
LANE_FIELDS = ("coalesced_folds", "solo_folds", "batch_peak", "device_s")
SERVICE_WARM_EVENTS = 50
SERVICE_TOKEN = "smoke-token"


def http_call(base, path, body=None, token=None, headers=None,
              timeout=300.0):
    """One request: (status, headers, parsed JSON or text body)."""
    import http.client
    import urllib.parse
    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    hdrs = dict(headers or {})
    if token:
        hdrs["Authorization"] = f"Bearer {token}"
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
        hdrs.setdefault("Content-Length", str(len(data)))
    try:
        conn.putrequest("POST" if body is not None else "GET", path)
        for k, v in hdrs.items():
            conn.putheader(k, v)
        conn.endheaders()
        if data is not None and int(hdrs["Content-Length"]) == len(data):
            conn.send(data)
        elif data is not None:
            conn.send(data[:1])         # an oversized declared body
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        out = json.loads(raw) if "json" in ctype else raw.decode()
        return resp.status, dict(resp.getheaders()), out
    finally:
        conn.close()


def service_keyed(keys, ids):
    """One keyed /api/check history of the batch keys ``ids``: each op's
    value ``[key, value]``, processes disjoint across keys."""
    out = []
    for j, k in enumerate(ids):
        for o in keys[k]:
            o = {f: v for f, v in o.items() if f != "index"}
            o["process"] = o["process"] + 1000 * j
            o["value"] = [k, o.get("value")]
            out.append(o)
    return out


def concurrent(fns):
    """Run the callables on threads of their own, started together;
    returns (results in order, each call's seconds, the wall)."""
    import threading
    res, secs, errs = [None] * len(fns), [0.0] * len(fns), []
    gate = threading.Barrier(len(fns))

    def run(i):
        try:
            gate.wait()
            t0 = time.monotonic()
            res[i] = fns[i]()
            secs[i] = time.monotonic() - t0
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errs.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent calls failed: {errs}")
    return res, secs, wall


def quantile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def service_phase(dev, keys, oracle, tenants=SERVICE_TENANTS,
                  per_tenant=SERVICE_KEYS_PER, txn_tenants=SERVICE_TXN_TENANTS,
                  txns=SERVICE_TXNS, g1c=SERVICE_TXN_G1C,
                  streams=SERVICE_STREAMS,
                  stream_events=SERVICE_STREAM_EVENTS,
                  streams_whole=SERVICE_STREAMS_WHOLE,
                  stream_chunk=STREAM_CHUNK, burst=SERVICE_BURST):
    """Checking as a service (``fleet/service.py``, ``web.py``) as its
    users drive it. (a) ``web.serve`` in this process, coalescing on at
    its defaults (25 ms, 32 segments), on the card: ``tenants`` client
    threads each POST a keyed history of ``per_tenant`` batch keys to
    ``/api/check``, once with ``"coalesce": false`` and once coalesced,
    each mode after one untimed request (a prefix of key 0): every
    key's verdict equal to
    the CPU oracle's and the two modes equal; checks per second, request
    latency, the coalescer's batches, segments, occupancy, owners and
    queue wait; rollout launches per mode (the solo path's searches
    launch the kernel, a coalesced batch pins the scan). (b) Txn tenants
    POST list-append histories (``family`` txn), two with a G1c cycle:
    verdicts and anomaly classes equal to ``cycle.append.check`` on the
    card, at least two closure probes coalesced. (c) ``streams``
    StreamChecks over the first keys, those of ``streams_whole`` whole
    (a corrupted key stops where its frontier empties) and the others
    their first ``stream_events`` events, fed event by event from a
    thread each beside the live coalescer: folds coalesced, a batch of
    at least two streams, no fold's violation refuted by its confirm,
    each whole stream's final verdict equal to the
    CPU oracle's on its key and each prefix's equal to the CPU sweep's
    (``linear``), and each prefix fed again to a solo stream
    (``coalesce?`` off) giving the same verdict and summary apart from
    the lane's fields; seconds per event. (d)
    ``python -m jepsen_tpu_torch serve --token`` in a subprocess,
    started with the phase so its start-up runs beside (a)-(c): 401
    without the token, (a)'s verdict of one key with it, 413 for an
    oversized body, the coalescer's series on
    ``/api/metrics``, exit 0 within 10 s of SIGINT. (e) Admission at one
    check in flight, one waiting and no wait: a burst of ``burst``
    checks sheds at least one 429 with Retry-After, and every 200
    carries the oracle's verdict (each burst check with ``"coalesce":
    false``: a batch of one would pay the scan rollout's iterations,
    and the burst is about the gate)."""
    import signal
    import tempfile
    from jepsen_tpu_torch import models, simulate, store, web
    from jepsen_tpu_torch.checker import fold_kernel, linear, rollout, streamlin
    from jepsen_tpu_torch.cycle import append
    from jepsen_tpu_torch.fleet import service
    from jepsen_tpu_torch.monitor.wgl_stream import StreamCheck
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    spec = models.cas_register_spec
    out = {"phase": "service"}
    launches = {}
    base_dir = store.base_dir
    tmp = tempfile.mkdtemp(prefix="jepsen-service-")
    store.base_dir = os.path.join(tmp, "store")
    # (d)'s process starts first: its imports and its first check (a
    # fresh CUDA context) run beside (a)-(c), and (d) reads the answers
    serve = ServeProcess(tmp, cuda, {"history": keys[0],
                                     "model": "cas-register"})
    try:
        service.reset()
        # one token per tenant: the gate names each caller by its token,
        # and the coalescer counts a batch's owners by those names
        tokens = {f"tenant-{t}-token": f"tenant-{t}"
                  for t in range(max(tenants, txn_tenants))}
        service.configure(tokens=tokens)
        tok = sorted(tokens)
        server = web.serve({"ip": "127.0.0.1", "port": 0, "device": dev.type})
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}"
            # -- (a) tenants: solo, then coalesced --------------------------
            t_a = time.monotonic()
            ids = [list(range(t * per_tenant, (t + 1) * per_tenant))
                   for t in range(tenants)]
            # each request asks the service's longest budget: 32 keys
            # solo took 19.55-26.55 s beside an H100 (PERF.md §5),
            # close to the default 30 s, which a slower host passed,
            # turning the last keys "unknown"
            payloads = [{"history": service_keyed(keys, i), "keyed": True,
                         "model": "cas-register",
                         "timeout-s": service.CHECK_TIMEOUT_CAP_S}
                        for i in ids]
            a = {}
            verdicts = {}
            for mode, flag in (("solo", False), ("coalesced", True)):
                st, _h, warm = http_call(
                    url, "/api/check",
                    {"history": keys[0][:SERVICE_WARM_EVENTS],
                     "model": "cas-register", "coalesce": flag},
                    token=tok[0])
                if st != 200:
                    raise AssertionError(f"service a: warm-up {st} {warm}")
                sync(dev)
                before = service.coalescer().stats()
                reg = service.slo_registry()
                w0 = reg.histogram("service.coalesce.wait_s")
                w0 = (w0.sum, w0.count) if w0 else (0.0, 0)
                rollout.launches = 0
                res, secs, wall = concurrent([
                    (lambda p=p, t=t: http_call(url, "/api/check",
                                                dict(p, coalesce=flag),
                                                token=t))
                    for p, t in zip(payloads, tok)])
                sync(dev)
                launches[f"service_{mode}"] = rollout.launches
                got = {}
                for i, (st, _h, body) in zip(ids, res):
                    if st != 200:
                        raise AssertionError(f"service a {mode}: {st} {body}")
                    for k in i:
                        got[k] = body["keys"][str(k)]["valid"]
                want = {k: oracle[k] for i in ids for k in i}
                if got != want:
                    raise AssertionError(f"service a {mode}: verdicts {got} "
                                         f"!= oracle {want}")
                verdicts[mode] = got
                after = service.coalescer().stats()
                w1 = reg.histogram("service.coalesce.wait_s")
                w1 = (w1.sum, w1.count) if w1 else (0.0, 0)
                n_keys = sum(len(i) for i in ids)
                row = {"wall_s": wall, "requests": len(payloads),
                       "key_checks": n_keys, "checks_per_s": n_keys / wall,
                       "requests_per_s": len(payloads) / wall,
                       "latency_p50_s": quantile(secs, 0.5),
                       "latency_p99_s": quantile(secs, 0.99),
                       "rollout_launches": rollout.launches,
                       "batches": after["batches"] - before["batches"],
                       "segments": after["segments"] - before["segments"],
                       "lanes": after["lanes"] - before["lanes"]}
                row["occupancy"] = row["segments"] / row["lanes"] \
                    if row["lanes"] else None
                row["queue_wait_mean_s"] = (w1[0] - w0[0]) / (w1[1] - w0[1]) \
                    if w1[1] > w0[1] else None
                if flag:
                    row["owners_max"] = max(
                        (r["coalesced"]["owners"]
                         for _s, _h, b in res for r in b["keys"].values()
                         if "coalesced" in r), default=0)
                    owners = reg.histogram("service.coalesce.owners")
                    row["owners_hist_max"] = owners.max if owners else 0
                    if row["batches"] < 1 or row["owners_max"] < 2 \
                            or row["owners_hist_max"] < 2:
                        raise AssertionError(f"service a: no cross-tenant "
                                             f"batch: {row}")
                    scan_only("service a coalesced")
                elif cuda and rollout.launches <= 0:
                    raise AssertionError("service a solo: the solo searches "
                                         "never launched the rollout kernel")
                a[mode] = row
            if verdicts["solo"] != verdicts["coalesced"]:
                raise AssertionError("service a: the modes disagree")
            a["invalid_keys"] = sorted(k for k, v in verdicts["solo"].items()
                                       if v is False)
            a["seconds"] = time.monotonic() - t_a
            out["a"] = a

            # -- (b) the txn lane --------------------------------------------
            t_b = time.monotonic()
            hists = [simulate.txn_append_history(
                txns, TXN_APPENDS, TXN_PROCS, g1c=g1c if t % 2 else None)
                for t in range(txn_tenants)]
            offline = [append.check(h, device=dev) for h in hists]
            b0 = service.coalescer().stats()
            rollout.launches = 0
            res, secs, wall = concurrent([
                (lambda h=h, t=t: http_call(url, "/api/check",
                                            {"family": "txn",
                                             "workload": "append",
                                             "history": h}, token=t))
                for h, t in zip(hists, tok)])
            launches["service_txn"] = scan_only("service b")
            for t, ((st, _h, body), want) in enumerate(zip(res, offline)):
                if st != 200 or body["valid"] is not want["valid"] \
                        or sorted(body["anomaly_types"]) \
                        != sorted(want["anomaly_types"]) \
                        or want["valid"] is not (t % 2 == 0):
                    raise AssertionError(f"service b tenant {t}: {st} "
                                         f"{body.get('valid')!r} "
                                         f"{body.get('anomaly_types')} != "
                                         f"{want['valid']!r} "
                                         f"{want['anomaly_types']}")
            coalesced = sum("coalesced" in body for _s, _h, body in res)
            if coalesced < 2:
                raise AssertionError(f"service b: {coalesced} coalesced "
                                     f"probes")
            b1 = service.coalescer().stats()
            out["b"] = {"tenants": txn_tenants, "txns": txns, "wall_s": wall,
                        "latency_p50_s": quantile(secs, 0.5),
                        "latency_p99_s": quantile(secs, 0.99),
                        "coalesced": coalesced,
                        "batches": b1["batches"] - b0["batches"],
                        "segments": b1["segments"] - b0["segments"],
                        "invalid": [t for t, w in enumerate(offline)
                                    if w["valid"] is False],
                        "seconds": time.monotonic() - t_b}

            # -- (c) the fold lane --------------------------------------------
            t_c = time.monotonic()
            streams_whole = [k for k in streams_whole if k < streams]
            checks = [StreamCheck(spec, opts={
                "frontier-cap": streamlin.FRONTIER_CAP_MAX,
                "owner": f"stream-{k}"}, device=dev) for k in range(streams)]
            streamed = [keys[k] if k in streams_whole
                        else keys[k][:stream_events] for k in range(streams)]
            fed = [0] * streams

            def feed(sc, k):
                n = 0
                for i, op in enumerate(streamed[k]):
                    fed[k] = i + 1
                    if sc.offer(op, i):
                        n += 1
                        if n % stream_chunk == 0:
                            r = sc.check()
                            if r["valid"] is not True:
                                return r["valid"]
                return sc.check()["valid"]

            rollout.launches = 0
            fold_kernel.launches = 0
            got, secs, wall = concurrent([(lambda k=k: feed(checks[k], k))
                                          for k in range(streams)])
            sync(dev)
            launches["service_fold"] = rollout.launches
            out["fold_launches"] = {"service_fold": fold_kernel.launches}
            if dev.type == "cuda" and fold_kernel.launches <= 0:
                raise AssertionError("service c: the fold lane launched no "
                                     "fold kernel")
            summ = [sc.stream_summary() for sc in checks]
            # the whole streams against the gate's CPU oracle on their
            # keys, each prefix against the CPU sweep
            t0 = time.monotonic()
            want = [oracle[k] if k in streams_whole else
                    linear.check_encoded(spec, *spec.encode(streamed[k]))[
                        "valid"] for k in range(streams)]
            oracle_s = time.monotonic() - t0
            if got != want:
                raise AssertionError(f"service c: streams {got} != CPU "
                                     f"oracle {want}")
            invalid = [k for k, v in enumerate(got) if v is False]
            if invalid != [k for k in streams_whole
                           if k % CORRUPT_EVERY == CORRUPT_EVERY - 1]:
                raise AssertionError(f"service c: invalid streams "
                                     f"{invalid}")
            # each prefix again as a solo stream (coalesce? off): the
            # same verdict and the same summary but for the lane's own
            # fields, so no lane hands a stream another one's fold
            t0 = time.monotonic()
            for k in (k for k in range(streams) if k not in streams_whole):
                sc = StreamCheck(spec, opts={
                    "frontier-cap": streamlin.FRONTIER_CAP_MAX,
                    "coalesce?": False}, device=dev)
                v = feed(sc, k)
                solo, lane = (
                    {f: x for f, x in d.items() if f not in LANE_FIELDS}
                    for d in (sc.stream_summary(), summ[k]))
                if v != got[k] or solo != lane:
                    raise AssertionError(f"service c: stream {k} {got[k]} "
                                         f"{lane} != solo {v} {solo}")
            solo_s = time.monotonic() - t0
            peak = max(s["batch_peak"] for s in summ)
            co = sum(s["coalesced_folds"] for s in summ)
            if co <= 0 or peak < 2 or any(s.get("fallback") for s in summ) \
                    or any(s["confirm_mismatches"] for s in summ) \
                    or any(summ[k]["coalesced_folds"] <= 0
                           for k in streams_whole):
                raise AssertionError(
                    f"service c: coalesced folds "
                    f"{[s['coalesced_folds'] for s in summ]}, batch peak "
                    f"{peak}, fallbacks {[s.get('fallback') for s in summ]}"
                    f", confirm mismatches "
                    f"{[s['confirm_mismatches'] for s in summ]}")
            events = sum(fed)
            out["c"] = {"streams": streams, "events_per_stream": stream_events,
                        "whole": streams_whole,
                        "events_fed": fed, "events": events, "wall_s": wall,
                        "s_per_event": wall / events,
                        "whole_stream_s": {k: secs[k] for k in streams_whole},
                        "coalesced_folds": co,
                        "solo_folds": sum(s["solo_folds"] for s in summ),
                        "batch_peak": peak,
                        "frontier_cap_rows": [c.F for c in checks],
                        "frontier_peak": [s["frontier_peak"] for s in summ],
                        "invalid": invalid,
                        "cpu_oracle_s": oracle_s,
                        "solo_streams_s": solo_s,
                        "seconds": time.monotonic() - t_c}
        finally:
            server.shutdown()
            server.server_close()

        # -- (d) the entry point in a subprocess ------------------------------
        t_d = time.monotonic()
        try:
            serve.thread.join(timeout=180)
            first = serve.first
            if "error" in first or serve.thread.is_alive():
                raise AssertionError(f"service d: {first}")
            st200, _h, body = first["200"]
            st413, _h, _b = http_call(
                serve.url, "/api/check", b"x", token=SERVICE_TOKEN,
                headers={"Content-Length": str(service.MAX_BODY_BYTES + 1)})
            stm, _h, text = http_call(serve.url, "/api/metrics",
                                      token=SERVICE_TOKEN)
            got = body.get("valid") if st200 == 200 else body
            if (first["401"], st200, st413, stm) != (401, 200, 413, 200) \
                    or got != verdicts["coalesced"][0] \
                    or "jepsen_service_coalesce_batches" not in text:
                raise AssertionError(f"service d: {first['401']} {st200} "
                                     f"{st413} {stm}, verdict {got}")
            t0 = time.monotonic()
            serve.proc.send_signal(signal.SIGINT)
            code = serve.proc.wait(timeout=10)
            stop_s = time.monotonic() - t0
            if code != 0:
                raise AssertionError(f"service d: serve exited {code} "
                                     f"on SIGINT")
        except BaseException:
            print(serve.output()[-4000:], file=sys.stderr)
            raise
        out["d"] = {"listening_s": first["listening_s"],
                    "first_check_s": first["first_check_s"],
                    "statuses": [first["401"], st200, st413, stm],
                    "sigint_exit": code, "stop_s": stop_s,
                    "seconds": time.monotonic() - t_d}

        # -- (e) admission: one in flight, one waiting, no wait ---------------
        t_e = time.monotonic()
        service.reset()
        server = web.serve({"ip": "127.0.0.1", "port": 0, "device": dev.type,
                            "budgets": {"concurrent-checks": 1,
                                        "queue-depth": 1},
                            "queue-wait-s": 0})
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}"
            rollout.launches = 0
            res, _secs, wall = concurrent([
                (lambda k=k: http_call(url, "/api/check",
                                       {"history": keys[k],
                                        "model": "cas-register",
                                        "coalesce": False}))
                for k in range(burst)])
            sync(dev)
            launches["service_admission"] = rollout.launches
            shed = [k for k, (st, h, _b) in enumerate(res)
                    if st == 429 and int(h.get("Retry-After", 0)) >= 1]
            ok = {k: b["valid"] for k, (st, _h, b) in enumerate(res)
                  if st == 200}
            other = [(k, st) for k, (st, _h, _b) in enumerate(res)
                     if st not in (200, 429)]
            if not shed or other or not ok \
                    or any(v != oracle[k] for k, v in ok.items()):
                raise AssertionError(f"service e: shed {shed}, 200s {ok}, "
                                     f"other {other}")
            out["e"] = {"burst": burst, "shed": len(shed), "ok": len(ok),
                        "shed_total": service.admission().shed_count,
                        "wall_s": wall, "seconds": time.monotonic() - t_e}
        finally:
            server.shutdown()
            server.server_close()
        out["launches"] = launches
        out["seconds"] = time.monotonic() - t_start
        return out
    finally:
        serve.kill()
        service.reset()
        store.base_dir = base_dir
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


class ServeProcess:
    """``python -m jepsen_tpu_torch serve --token`` on a free loopback
    port, started now; a thread waits for it to listen, then sends one
    check without the token and one with it."""

    def __init__(self, tmp, cuda, check):
        import socket
        import threading
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        cmd = [sys.executable, "-m", "jepsen_tpu_torch", "serve",
               "--host", "127.0.0.1", "--port", str(self.port), "--token",
               SERVICE_TOKEN] + ([] if cuda else ["--device", "cpu"])
        self.url = f"http://127.0.0.1:{self.port}"
        self.check = check
        self.log = open(os.path.join(tmp, "serve.log"), "w+")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(cmd, cwd=tmp, env=env,
                                     stdout=self.log,
                                     stderr=subprocess.STDOUT)
        self.first = {}
        self.thread = threading.Thread(target=self._first, daemon=True)
        self.thread.start()

    def _first(self):
        import socket
        try:
            deadline = time.monotonic() + 180
            while True:
                if self.proc.poll() is not None:
                    raise AssertionError(f"serve exited "
                                         f"{self.proc.returncode} before "
                                         f"listening")
                try:
                    with socket.create_connection(("127.0.0.1",
                                                   self.port), 1):
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise AssertionError(
                            "serve never listened") from None
                    time.sleep(0.1)
            self.first["listening_s"] = time.monotonic() - self.t0
            self.first["401"] = http_call(self.url, "/api/check",
                                          self.check)[0]
            t0 = time.monotonic()
            self.first["200"] = http_call(self.url, "/api/check",
                                          self.check, token=SERVICE_TOKEN)
            self.first["first_check_s"] = time.monotonic() - t0
        except Exception as exc:  # noqa: BLE001 - read by (d)
            self.first["error"] = exc

    def output(self):
        self.log.seek(0)
        return self.log.read()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()



#: the capacity phase: the sweep's register cells (campaign (a)'s matrix,
#: two register cells, its per-key limit cut to the floor bucket so every
#: planned segment pads to the one predicted shape), the budget the card
#: holds, and the fold and closure sizes the size model is held at
CAPACITY_TIME_LIMIT, CAPACITY_PER_KEY, CAPACITY_BUDGET = 2, 20, "64G"
CAPACITY_FOLD_F, CAPACITY_FOLD_OPS, CAPACITY_CLOSURE_N = 8192, 60, 8192


def mem_step(dev, fn):
    """``(fn(), bytes)``: the device memory ``fn`` allocated at its peak
    above what was allocated before it (``torch.cuda`` peak statistics,
    reset first); None for the bytes off the card."""
    import torch
    if dev.type != "cuda":
        return fn(), None
    stream_sync()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    stream_sync()
    return out, torch.cuda.max_memory_allocated(dev) - base


def held(name, predicted, measured, **extra):
    """One capacity step's row: the prediction, the peak measured above
    the baseline, their ratio, and ``within_2x`` (the ratio at least
    0.5: a prediction looser than that is flagged, not failed); raises
    where the measurement exceeds the prediction (the size model is then
    wrong)."""
    ratio = None if measured is None else measured / predicted
    row = {"predicted_bytes": predicted, "measured_bytes": measured,
           "measured_over_predicted": ratio,
           "within_2x": None if ratio is None else ratio >= 0.5, **extra}
    if measured is not None and measured > predicted:
        raise AssertionError(f"capacity {name}: measured {measured} bytes "
                             f"over the predicted {predicted}")
    return row


def batch_plan_key(noted):
    """The widest key-batch plan key (``torch-wgl-batch``) among the
    canonical keys ``noted`` (``compile_cache.noted_since``), as a list:
    its second field is the batch's runtime key axis."""
    keys = [list(k) for eng, k in noted if eng == "torch-wgl-batch"]
    if not keys:
        raise AssertionError("no key-batch plan shape was noted")
    return max(keys, key=lambda k: k[1])


def search_bytes(engine, key):
    """``{"keys", "n", "C", "predicted_bytes"}`` of one noted search
    (``compile_cache`` plan key): ``sizemodel.hbm_bytes`` at the key's
    own sizes, the key batch (``torch-wgl-batch``) at its runtime key
    axis."""
    from jepsen_tpu_torch.analysis import sizemodel
    if engine == "torch-wgl":
        _name, n, B, S, C, A, W, O, T, *_rest = key
        K = 1
    elif engine == "torch-wgl-batch":
        _name, K, W, n, B, S, C, A, O, T, *_rest = key
    else:
        raise AssertionError(f"capacity (e): no size model for {engine}")
    total = sizemodel.hbm_bytes(n, S, C, keys=K, arg_width=A,
                                sizes=(B, W, O, T), engine=engine)["total"]
    return {"keys": K, "n": n, "C": C, "predicted_bytes": total}


def capacity_sweep(dev, kept=None):
    """The capacity phase's (e) and (f) (``capacity_phase``): ``({"e",
    "f"}, the sweep's rollout launches)``. With ``kept`` (``KeptStores``)
    the temporary store is handed over with (e)'s campaign directory for
    the summary phase, not removed."""
    import contextlib
    import logging
    import shutil
    import tempfile
    from jepsen_tpu_torch import __main__ as demo_main
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.campaign import compile_cache
    from jepsen_tpu_torch.checker import rollout
    cuda = dev.type == "cuda"
    out = {}
    root = logging.getLogger()
    saved_log = (root.level, list(root.handlers))
    base = store.base_dir
    tmp = tempfile.mkdtemp(prefix="jepsen-capacity-")
    store.base_dir = os.path.join(tmp, "store")
    argv = ["campaign", "--no-ssh", "--axis", "workload=register",
            "--seeds", "2", "--parallel", "2", "--concurrency", "10n",
            "--per-key-limit", str(CAPACITY_PER_KEY), "--time-limit",
            str(CAPACITY_TIME_LIMIT), "--capacity", "enforce",
            "--device-slots", "auto"] + ([] if cuda else ["--device", "cpu"])

    def main(args):
        with contextlib.redirect_stdout(sys.stderr):
            try:
                demo_main.main(args)
                return 0
            except SystemExit as exc:
                return exc.code

    try:
        rollout.launches = 0
        noted = compile_cache.noted_counts()
        t0 = time.monotonic()
        code, peak = mem_step(dev, lambda: main(
            argv + ["--device-mem-budget", CAPACITY_BUDGET]))
        wall = time.monotonic() - t0
        sweep_launches = rollout.launches
        searches = [dict(search_bytes(eng, key), engine=eng)
                    for (eng, key), times in compile_cache.noted_counts()
                    .items() for _ in range(times - noted.get((eng, key), 0))]
        cid = store.latest_campaign()
        if code != 0 or cid is None:
            raise AssertionError(f"capacity (e): exit {code}")
        with open(store.campaign_path(cid, "report.json")) as f:
            rep = json.load(f)
        with open(store.campaign_path(cid, "campaign.json")) as f:
            meta = json.load(f)
        with open(store.campaign_path(cid, "capacity_plan.json")) as f:
            plan = json.load(f)
        slots = meta.get("device-slots")
        want = plan["hbm"]["auto_slots"]
        if not isinstance(slots, int) or slots != want or slots < 1:
            raise AssertionError(f"capacity (e): device slots {slots!r}, "
                                 f"the plan's auto {want!r}")
        oracle = rep["capacity"]["oracle"]
        if oracle["error_frac"] != 0.0 or not oracle["actual"]:
            raise AssertionError(f"capacity (e): oracle {oracle}")
        # the sweep's real peak against the size model at the shapes the
        # cells ran (each search's noted plan key, the batch's runtime
        # key axis included), every search counted as if all overlapped;
        # and against the plan's per-cell figure, a per-lane number
        # (ROADMAP.md C.12): where one search's keyed figure passes it,
        # the resolved slots x that figure oversubscribes the budget
        per_cell = plan["hbm"]["per_cell_peak_bytes"]
        widest = max(s_["predicted_bytes"] for s_ in searches)
        out["e"] = held(
            "e", sum(s_["predicted_bytes"] for s_ in searches), peak,
            exit=code, wall_s=wall, device_slots=slots,
            peak_cell_bytes=per_cell,
            budget_bytes=plan["hbm"]["budget_bytes"],
            searches=searches,
            widest_search_over_peak_cell=widest / per_cell,
            slots_times_widest_search_over_budget=slots * widest
            / plan["hbm"]["budget_bytes"],
            oracle=oracle, outcomes=rep["summary"]["outcomes"],
            campaign=cid)
        low = plan["hbm"]["per_cell_peak_bytes"] // 2
        before = store.campaigns()
        t0 = time.monotonic()
        code = main(argv + ["--device-mem-budget", str(low)])
        if code != 254 or store.campaigns() != before:
            raise AssertionError(f"capacity (f): exit {code} with a "
                                 f"budget of {low} bytes, campaigns "
                                 f"{store.campaigns()}")
        out["f"] = {"exit": code, "budget_bytes": low,
                    "seconds": time.monotonic() - t0}
    finally:
        # the scheduler attached the disk ledger under the temporary
        # store: detach it before the store goes
        from jepsen_tpu_torch.fleet import ledger
        ledger.detach()
        if kept is not None and "e" in out:
            kept.keep(tmp, capacity={"campaign_dir": store.campaign_path(
                out["e"]["campaign"])})
        else:
            shutil.rmtree(tmp, ignore_errors=True)
        store.base_dir = base
        root.setLevel(saved_log[0])
        root.handlers[:] = saved_log[1]
    return out, sweep_launches


def capacity_phase(dev, batch_mem, fold_hist, kept=None):
    """The capacity planner against the card (``analysis/sizemodel``,
    ``analysis/capplan``). Each step resets the peak statistics, runs,
    and prints the prediction, the peak above its baseline and
    measured/predicted, which must not exceed 1. (a) A solo
    ``torch_wgl`` search of the main cas-register history against
    ``sizemodel.search_shape(...)["hbm"]["total"]`` at the engine's own
    bucket and concurrency. (b) The batch phase's timed 256-key call
    (``batch_mem``, measured there) against the per-lane prediction times
    the batch's runtime key axis and against the prediction at that key
    axis (``keyshard.batch_sizes`` narrows each key's frontier and stack).
    (c) ``closure_shape(8192)`` against ``cycle.transitive_closure`` of an
    8,192-txn graph. (d) ``stream_frontier_shape`` at F=8192 against one
    fold at F=8192 (``streamlin.solo_fold``, the fold ``StreamCheck``
    dispatches). (e) ``campaign`` over two register cells with
    ``--capacity enforce --device-mem-budget 64G --device-slots auto``:
    exit 0, the resolved slot count (budget // peak cell), the oracle's
    ``error_frac`` 0.0, and the sweep's peak at most the size model's
    figures for the searches it ran (``search_bytes``: each noted plan
    key at its own sizes and key axis, all counted as if they
    overlapped); the widest search's figure is printed beside the plan's
    per-lane cell figure and the resolved slots. (f) The same with a
    budget below the peak cell: refused (254) before any cell runs, no
    campaign written. Steps whose prediction is more than 2x above the
    measurement are listed in ``loose``. ``kept`` goes to
    ``capacity_sweep``."""
    import numpy as np
    from jepsen_tpu_torch import cycle, models, simulate
    from jepsen_tpu_torch.analysis import sizemodel
    from jepsen_tpu_torch.checker import (fold_kernel, rollout, streamlin,
                                          torch_wgl)
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    out = {"phase": "capacity"}
    launches = {}
    spec = models.cas_register_spec

    # (a) the main history's solo search
    hist = simulate.random_history(random.Random(45100), "cas-register",
                                   64, 10_000, 0.05)
    e, st = spec.encode(hist)
    prep = torch_wgl._prepare_search(spec, e, st)
    *_, n_pad, C, A, S = prep[1]
    shape = sizemodel.search_shape("cas-register", len(e), concurrency=C,
                                   engine="torch-wgl")
    if (shape["bucket"], shape["C"], shape["A"], shape["S"]) \
            != (n_pad, C, A, S):
        raise AssertionError(f"capacity (a): the size model's shape "
                             f"{shape} is not the engine's "
                             f"{(n_pad, C, A, S)}")
    rollout.launches = 0
    t0 = time.monotonic()
    r, peak = mem_step(dev, lambda: torch_wgl.check_encoded(
        spec, e, st, device=dev))
    if r["valid"] is not True:
        raise AssertionError(f"capacity (a): decided {r['valid']!r}")
    launches["capacity_search"] = rollout.launches
    if cuda and rollout.launches <= 0:
        raise AssertionError("capacity (a): the search launched no "
                             "rollout kernel")
    out["a"] = held("a", shape["hbm"]["total"], peak, hbm=shape["hbm"],
                    sizes=shape["sizes"], C=C, n=n_pad,
                    seconds=time.monotonic() - t0)

    # (b) the batch phase's timed call
    (_name, K, _W, bn, _B, bS, bC, bA, *_rest) = batch_mem["key"]
    lane = sizemodel.hbm_bytes(bn, bS, bC, keys=1, arg_width=bA,
                               engine="torch-wgl-batch")["total"]
    keyed = sizemodel.hbm_bytes(bn, bS, bC, keys=K, arg_width=bA,
                                engine="torch-wgl-batch")
    out["b"] = held("b", keyed["total"], batch_mem["peak_bytes"],
                    per_lane_bytes=lane, keys=K,
                    per_lane_times_keys=lane * K,
                    measured_over_per_lane_times_keys=None
                    if batch_mem["peak_bytes"] is None
                    else batch_mem["peak_bytes"] / (lane * K),
                    per_lane_times_keys_within_2x=None
                    if batch_mem["peak_bytes"] is None
                    else batch_mem["peak_bytes"] >= lane * K / 2,
                    hbm=keyed, n=bn, C=bC)
    if batch_mem["peak_bytes"] is not None \
            and batch_mem["peak_bytes"] > lane * K:
        raise AssertionError("capacity (b): over the per-lane prediction "
                             "times the key axis")

    # (c) a closure of CAPACITY_CLOSURE_N txns
    rng = np.random.default_rng(45100)
    n = CAPACITY_CLOSURE_N
    adj = np.zeros((n, n), bool)
    src = rng.integers(0, n - 1, 4 * n)
    adj[src, src + 1 + rng.integers(0, 8, 4 * n) % (n - 1 - src)] = True
    t0 = time.monotonic()
    reach, peak = mem_step(dev, lambda: cycle.transitive_closure(
        adj, device=dev))
    pred = sizemodel.closure_shape(n, device=str(dev))
    out["c"] = held("c", pred["hbm"]["total"], peak, hbm=pred["hbm"],
                    n=n, reach_pairs=int(reach.sum()),
                    seconds=time.monotonic() - t0)

    # (d) one fold at F=CAPACITY_FOLD_F
    fe, fst = spec.encode(fold_hist)
    job = streamlin.history_job(spec, fe, fst, F=CAPACITY_FOLD_F,
                                device=dev)
    t0 = time.monotonic()
    fold_kernel.launches = 0
    fr, peak = mem_step(dev, lambda: streamlin.solo_fold(job))
    out["fold_launches"] = {"capacity": fold_kernel.launches}
    if cuda and fold_kernel.launches != 1:
        raise AssertionError(f"capacity (d): {fold_kernel.launches} fold "
                             f"kernel launches, expected 1")
    pred = sizemodel.stream_frontier_shape(
        job.F, job.B * 32, state_size=job.S, arg_width=job.A,
        open_cap=job.C, events=job.E, device=str(dev))
    out["d"] = held("d", pred["hbm"]["total"], peak, hbm=pred["hbm"],
                    F=job.F, window=job.B * 32, C=job.C, events=job.E,
                    status=fr.get("status"),
                    seconds=time.monotonic() - t0)

    # (e)-(f) the sweep with the plan enforced, then refused
    sweep, launches["capacity_sweep"] = capacity_sweep(dev, kept)
    out.update(sweep)
    out["launches"] = launches
    out["loose"] = [k for k in "abcde" if out[k].get("within_2x") is False] \
        + (["b per lane x keys"] if out["b"][
            "per_lane_times_keys_within_2x"] is False else [])
    out["seconds"] = time.monotonic() - t_start
    return out


#: the suites phase: the toystore runs' time limits, and the zookeeper
#: stub's: its generator issues one op a second on average
#: (zookeeper.clj's ``stagger 1``), failed cas ops drop out of the
#: checked history (about 0.73 kept a second), and the engine rolls
#: chains only past 64 ops (``torch_wgl._rollout_shape``), so 130 s keep
#: about 95 ops, 64 lies about four standard deviations below. The kill
#: run takes the suite's own default of 8 s: at 5 s (20 ops a second,
#: some failed by the kills, which drop out) it kept so few ops in one
#: whole smoke that its search rolled no chain (PERF.md)
SUITES_TOYSTORE_S, SUITES_ZK_S = 8, 130
SUITES_STALE_S, SUITES_STALE_CONCURRENCY = 6, 6

#: the zookeeper stub's child process: the suite's ``main`` (what
#: ``python -m jepsen_tpu_torch.suites.zookeeper`` runs) with its
#: printing on stderr, then one JSON line: its exit code and the rollout
#: kernel's launches in that process
ZK_CHILD = """
import contextlib, json, sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import checkers, rollout
from jepsen_tpu_torch.suites import zookeeper
store.base_dir = sys.argv[1]
with contextlib.redirect_stdout(sys.stderr):
    try:
        zookeeper.main(sys.argv[2:])
        code = 0
    except SystemExit as exc:
        code = exc.code
    checkers.join_racers()
print(json.dumps({"exit": code, "launches": rollout.launches}))
"""


def missing_module(result):
    """The module a checker result's errors (its own, or its
    sub-checkers') say could not be imported, or None."""
    import re
    text = json.dumps(result, default=str)
    m = re.search(r"No module named '([\w.]+)'", text.replace("\\'", "'"))
    return m.group(1) if m else None


class ZkStubRun:
    """``zookeeper test --stub`` for ``SUITES_ZK_S`` in a child process
    (``ZK_CHILD``) with a store of its own, started before the phases
    whose time its one-op-a-second run overlaps; the suites phase reads
    its result."""

    def __init__(self, dev):
        import tempfile
        here = os.path.dirname(os.path.abspath(__file__))
        self.tmp = tempfile.mkdtemp(prefix="jepsen-zk-")
        self.store = os.path.join(self.tmp, "store")
        args = ["test", "--stub", "--node", "n1", "--node", "n2",
                "--time-limit", str(SUITES_ZK_S), "--concurrency", "4"]
        if dev.type != "cuda":
            args += ["--device", "cpu"]
        self.out = open(os.path.join(self.tmp, "child.out"), "w+")
        self.err = open(os.path.join(self.tmp, "child.err"), "w+")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", ZK_CHILD, self.store, *args],
            cwd=self.tmp, env=dict(os.environ, PYTHONPATH=here),
            stdin=subprocess.DEVNULL, stdout=self.out, stderr=self.err)

    def result(self, timeout):
        """``(exit, launches, test, wall seconds, waited seconds)`` once
        the child has ended; raises if it failed."""
        from jepsen_tpu_torch import store
        t0 = time.monotonic()
        self.proc.wait(timeout=timeout)
        waited = time.monotonic() - t0
        self.out.seek(0)
        lines = self.out.read().splitlines()
        self.err.seek(0)
        log = self.err.read()
        sys.stderr.write(log[-20000:])
        if self.proc.returncode != 0 or not lines:
            raise AssertionError(f"suites (c): the zookeeper child exited "
                                 f"{self.proc.returncode}: {log[-2000:]}")
        row = json.loads(lines[-1])
        base = store.base_dir
        store.base_dir = self.store
        try:
            test = store.latest()
        finally:
            store.base_dir = base
        return (row["exit"], row["launches"], test,
                time.monotonic() - self.t0, waited)

    def close(self):
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.err.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def suites_phase(dev, zk):
    """The d6 suites as their users run them, in process through each
    suite's ``main`` (``python -m jepsen_tpu_torch.suites.<name> test``),
    the store in a temporary directory. First the host tools the
    toystore rig needs (``start-stop-daemon``, ``gcc``); without either,
    the toystore runs are left out and the row says why. (a) ``toystore
    test`` on 3 local nodes for 5 s with the kill nemesis and the
    default algorithm: exit 0, valid, the rollout kernel launched. (b)
    The same with ``--stale`` (no nemesis, 6 threads, 6 s): exit 1, the
    linearizability checker's verdict False. (c) ``zookeeper test
    --stub`` (``zk``, the ``ZkStubRun`` started before phase 16): its
    linearizability verdict True over more than 64 checked ops, the
    rollout kernel launched, exit 0 (2 when the host lacks matplotlib,
    which the suite's perf graphs need: those checkers then read unknown
    and are listed; any other missing module fails). Each path's rollout
    launches are counted."""
    import contextlib
    import logging
    import shutil
    import tempfile
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker import checkers, rollout
    from jepsen_tpu_torch.suites import toystore
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    device = [] if cuda else ["--device", "cpu"]
    out = {"phase": "suites"}
    tools = {t: shutil.which(t) for t in ("start-stop-daemon", "gcc")}
    out["host_tools"] = tools
    launches = {}
    root = logging.getLogger()
    saved_log = (root.level, list(root.handlers))
    base = store.base_dir
    tmp = tempfile.mkdtemp(prefix="jepsen-suites-")
    store.base_dir = os.path.join(tmp, "store")

    def run(main, args):
        rollout.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(sys.stderr):
            try:
                main(args + device)
                code = 0
            except SystemExit as exc:
                code = exc.code
        checkers.join_racers()
        test = store.latest()
        return code, test, rollout.launches, time.monotonic() - t0

    nodes = ["--node", "n1", "--node", "n2", "--node", "n3"]
    try:
        if all(tools.values()):
            code, test, n, wall = run(toystore.main, [
                "test", *nodes, "--time-limit", str(SUITES_TOYSTORE_S),
                "--nemesis-mode", "kill", "--base-port",
                str(toystore.free_base_port(3))])
            res = test["results"]
            if code != 0 or res["valid"] is not True:
                raise AssertionError(f"suites (a): toystore exit {code}, "
                                     f"valid {res.get('valid')!r}")
            if cuda and n <= 0:
                raise AssertionError("suites (a): the toystore run "
                                     "launched no rollout kernel")
            launches["toystore"] = n
            ops = sum(1 for o in test["history"]
                      if o.get("type") == "invoke"
                      and o.get("process") != "nemesis")
            out["a"] = {"exit": code, "valid": res["valid"], "wall_s": wall,
                        "client_ops": ops,
                        "engine": res["linear"].get("engine"),
                        "rollout_launches": n}
            code, test, n, wall = run(toystore.main, [
                "test", *nodes, "--time-limit", str(SUITES_STALE_S),
                "--concurrency", str(SUITES_STALE_CONCURRENCY),
                "--stale", "--nemesis-mode", "none", "--base-port",
                str(toystore.free_base_port(3))])
            lin = test["results"]["linear"]
            if code != 1 or lin["valid"] is not False:
                raise AssertionError(f"suites (b): --stale exit {code}, "
                                     f"linear {lin.get('valid')!r}")
            launches["toystore_stale"] = n
            out["b"] = {"exit": code, "valid": lin["valid"], "wall_s": wall,
                        "engine": lin.get("engine"),
                        "op": {k: lin["op"].get(k)
                               for k in ("f", "value", "process")},
                        "rollout_launches": n}
        else:
            out["toystore_left_out"] = (
                f"the host lacks {[t for t, p in tools.items() if not p]}, "
                "which the toystore rig runs its nodes with")
        code, n, test, wall, waited = zk.result(
            timeout=SUITES_ZK_S + 300)
        res = test["results"]
        # the suite composes the perf graphs beside the checker (as
        # zookeeper.clj does); they need matplotlib, a host library the
        # card's machine may lack, and are then "unknown" (exit 2): the
        # run is held to its linearizability verdict and to each other
        # checker being valid or missing only that library
        host_only = sorted(
            k for k, v in res.items() if isinstance(v, dict)
            and v.get("valid") is not True
            and missing_module(v) == "matplotlib")
        if res["linear"]["valid"] is not True \
                or any(v.get("valid") is not True for k, v in res.items()
                       if isinstance(v, dict) and k not in host_only) \
                or code != (0 if not host_only else 2):
            raise AssertionError(f"suites (c): zookeeper --stub exit "
                                 f"{code}, valid {res.get('valid')!r}, "
                                 f"left out {host_only}")
        checked = sum(1 for o in test["history"]
                      if o.get("type") == "ok"
                      and o.get("process") != "nemesis")
        if checked <= 64 or (cuda and n <= 0):
            raise AssertionError(f"suites (c): zookeeper --stub checked "
                                 f"{checked} ops with {n} rollout "
                                 f"launches")
        launches["zookeeper_stub"] = n
        out["c"] = {"exit": code, "valid": res["linear"]["valid"],
                    "checkers_without_a_host_library": host_only,
                    "wall_s": wall, "waited_s": waited,
                    "client_ops": sum(1 for o in test["history"]
                                      if o.get("type") == "invoke"
                                      and o.get("process") != "nemesis"),
                    "ok_ops": checked,
                    "engine": res["linear"].get("engine"),
                    "rollout_launches": n}
    finally:
        store.base_dir = base
        root.setLevel(saved_log[0])
        root.handlers[:] = saved_log[1]
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.monotonic() - t_start
    return out


class KeptStores:
    """Temporary stores that the monitor, fleet and capacity phases leave
    for the summary phase to read: each phase hands over its store's
    directory and what the summary should read there, in place of
    removing it. ``close`` removes them all."""

    def __init__(self):
        self.dirs = []
        self.reads = {}

    def keep(self, tmp, **reads):
        self.dirs.append(tmp)
        self.reads.update(reads)

    def close(self):
        import shutil
        for d in self.dirs:
            shutil.rmtree(d, ignore_errors=True)
        self.dirs.clear()


#: the store reader's sections a monitored, certified run must show
SUMMARY_RUN_SECTIONS = ("-- lifecycle phases (wall time) --",
                        "-- WGL search telemetry --",
                        "-- streaming monitor --",
                        "-- verdict certificate --")


def read_store(args, here):
    """Start ``python -m jepsen_tpu_torch.trace_summary ARGS`` from the
    checkout's root; ``Popen`` (text output)."""
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.trace_summary", *args],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def summary_phase(dev, kept, main_verdict, here, n_ops=10_000):
    """The store reader (``jepsen_tpu_torch/trace_summary.py``) over the
    stores earlier phases wrote on the card, each run as a user runs it,
    in a subprocess, while (d) runs here. (a) The monitor phase's
    lost-write run (monitored, certified, aborted by the monitor): exit
    0, the lifecycle, op-latency, WGL-telemetry, streaming-monitor and
    certificate sections, its op count equal to the history's client
    completions (an op span closes at its completion), the violation
    instant. (b) ``--campaign`` over the fleet phase's sweep: exit 0, one
    lane per worker beside the coordinator's, each worker's exec row, a
    clean fleetlint audit. (c) ``--campaign`` over capacity (e)'s planned
    sweep: exit 0, the prediction error equal to its ``report.json``'s
    ``error_frac``. (d) Two threads check the main cas-register history
    (``n_ops`` ops) through one ``concurrency_limit(1,
    linearizable({"model": "cas-register"}))`` (the default gate) on the
    card: their checks (each timed inside the limit) must not overlap
    and each verdict must equal the main phase's; the rollout launches of
    both are the ``concurrency_limit`` path's."""
    import threading
    from jepsen_tpu_torch import simulate
    from jepsen_tpu_torch.checker import checkers, core, rollout
    t_start = time.monotonic()
    cuda = dev.type == "cuda"
    reads = kept.reads
    procs = {
        "a": read_store([reads["monitor"]["run_dir"]], here),
        "b": read_store(["--campaign", reads["fleet"]["campaign_dir"]],
                        here),
        "c": read_store(["--campaign", reads["capacity"]["campaign_dir"]],
                        here)}
    out = {"phase": "summary"}
    try:
        # (d) two threads through one limit while the readers run
        hist = simulate.random_history(random.Random(45100),
                                       "cas-register", 64, n_ops, 0.05)
        spans = []
        lock = threading.Lock()

        class Timed(core.Checker):
            """The gate, its wall recorded inside the limit."""

            def __init__(self, inner):
                self.inner = inner

            def check(self, test, h, opts=None):
                t0 = time.monotonic()
                r = self.inner.check(test, h, opts)
                sync(dev)
                with lock:
                    spans.append((t0, time.monotonic(), r["valid"]))
                return r

        opts = {"model": "cas-register"}
        if not cuda:
            opts["engine_opts"] = {"device": "cpu"}
        limited = core.concurrency_limit(
            1, Timed(checkers.linearizable(opts)))
        errors = []

        def check():
            try:
                limited.check({}, hist, {})
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        rollout.launches = 0
        t0 = time.monotonic()
        threads = [threading.Thread(target=check) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        checkers.join_racers()
        d_wall = time.monotonic() - t0
        launches = rollout.launches
        if errors:
            raise errors[0]
        spans.sort()
        if any(t.is_alive() for t in threads) or len(spans) != 2 \
                or spans[0][1] > spans[1][0] \
                or [v for _a, _b, v in spans] != [main_verdict] * 2:
            raise AssertionError(f"summary d: checks {spans}, the main "
                                 f"phase's verdict {main_verdict!r}")
        if cuda and launches <= 0:
            raise AssertionError("summary d: the limited checks launched "
                                 "no rollout kernel")
        out["d"] = {"wall_s": d_wall, "check_s": [b - a for a, b, _v
                                                  in spans],
                    "gap_s": spans[1][0] - spans[0][1],
                    "valid": main_verdict, "rollout_launches": launches}
        texts = {}
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            if p.returncode != 0:
                raise AssertionError(f"summary {k}: exit {p.returncode}: "
                                     f"{stderr[-2000:]}")
            texts[k] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    # (a) the monitored run
    a, run = texts["a"], reads["monitor"]
    want = f"-- op latency ({run['client_ops']} ops, from trace spans) --"
    missing = [x for x in SUMMARY_RUN_SECTIONS + (want,) if x not in a]
    if missing or "!! monitor violation at history index" not in a:
        raise AssertionError(f"summary a: missing {missing}: {a[-3000:]}")
    out["a"] = {"client_ops": run["client_ops"], "lines": len(a.split("\n")),
                "sections": sorted(x for x in a.split("\n")
                                   if x.startswith("-- "))}

    # (b) the fleet's merged trace
    b, fl = texts["b"], reads["fleet"]
    lanes = sorted(x.split(": ", 1)[1].split("   ")[0]
                   for x in b.split("\n") if x.startswith("lane "))
    want = sorted(["coordinator"] + [f"worker {w}" for w in fl["workers"]])
    rows = b.split("-- per-worker (exec / search / sync) --\n")[-1]
    no_exec = [w for w in fl["workers"]
               if f"{w:>16}  exec " not in rows]
    if lanes != want or no_exec \
            or "\n-- fleetlint audit --\nclean: 0 error(s)" not in b:
        raise AssertionError(f"summary b: lanes {lanes} (want {want}), "
                             f"no exec row for {no_exec}: {b[-3000:]}")
    out["b"] = {"lanes": lanes, "lines": len(b.split("\n"))}

    # (c) the planned campaign
    c, cap = texts["c"], reads["capacity"]
    with open(os.path.join(cap["campaign_dir"], "report.json")) as f:
        error_frac = json.load(f)["capacity"]["oracle"]["error_frac"]
    if f"prediction error: {error_frac} (" not in c:
        raise AssertionError(f"summary c: report.json's error_frac "
                             f"{error_frac}: {c[-3000:]}")
    out["c"] = {"error_frac": error_frac, "lines": len(c.split("\n"))}
    out["launches"] = {"concurrency_limit": launches}
    out["seconds"] = time.monotonic() - t_start
    return out


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

    # -- 3b. graph: the search chunk as graph replays against the eager loop
    from jepsen_tpu_torch import simulate
    keys, fifo = simulate.bench_histories(BATCH_KEYS)
    graph_row = graph_phase(dev, keys)
    emit(graph_row)

    # -- 4. invalid histories against the CPU oracle -----------------------
    trial_rows, trials = invalid_trials(dev)
    emit({"phase": "invalid", "trials": trial_rows})

    # -- 5. the gate at the JAX package's defaults -------------------------
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

    kept = KeptStores()
    try:
        # -- 9. monitor: monitored runs, the monitors on the card -------------
        mon_row = monitor_phase(
            dev, run_row["register"]["interpreter_ops_per_s"], kept=kept)
        emit(mon_row)

        # -- 10. cli: the command line, python -m jepsen_tpu_torch and suites -
        cli_row = cli_phase(dev)
        emit(cli_row)

        # -- 11. campaign: a sweep of runs behind one device slot -------------
        camp_row = campaign_phase(dev)
        emit(camp_row)

        # -- 12. fleet: the sweep's cells in worker processes -----------------
        fleet_row = fleet_phase(dev, kept=kept)
        emit(fleet_row)

        # -- 13-15. the key batch, independent, the queue models --------------
        row = batch_phase(keys, oracle)
        emit(row)
        ind = independent_phase(keys[:INDEPENDENT_KEYS])
        emit(ind)
        queues = queue_phase(fifo)
        emit(queues)

        # the suites phase's zookeeper stub: its one-op-a-second run starts
        # here, in a child process, and overlaps phases 16-20
        zk = ZkStubRun(dev)
        try:
            # -- 16-17. the streaming fold and the txn closure ----------------
            rollout.launches = 0
            stream_row = streamlin_phase(keys, dev)
            emit(stream_row)
            stream_launches = scan_only("streamlin")
            rollout.launches = 0
            emit(txn_phase(dev))
            txn_launches = scan_only("txn")

            # -- 18. service: /api/check tenants, the coalescer's lanes, serve 
            svc_row = service_phase(dev, keys, oracle)
            emit(svc_row)

            # -- 19. capacity: the planner's predictions against the card -----
            cap_row = capacity_phase(
                dev, {"peak_bytes": row["peak_bytes"], "key": row["plan_key"]},
                simulate.random_history(random.Random(7), "cas-register", 8,
                                        CAPACITY_FOLD_OPS, 0.0), kept)
            emit(cap_row)

            # -- 20. suites: toystore and zookeeper as their users run them ---
            suites_row = suites_phase(dev, zk)
            emit(suites_row)
        finally:
            zk.close()

        # -- 21. summary: the store reader over the card's own stores ------
        sum_row = summary_phase(dev, kept, main_rows[0]["valid"], here)
        emit(sum_row)
        by_path = {"main": main_launches,
                   "graph": sum(c["rollout_launches"]
                                for c in graph_row["cases"]),
                   **gate["launches"],
                   **obs_row["launches"], "mesh": mesh_row["launches"],
                   **run_row["launches"], **mon_row["launches"],
                   "cli": sum(cli_row["launches"].values()),
                   **cli_row["launches"], **camp_row["launches"],
                   "batch": row["rollout_launches"],
                   "independent": ind["rollout_launches"],
                   **{c["model"]: c["rollout_launches"]
                      for c in queues["checks"] if "rollout_launches" in c},
                   "streamlin": stream_launches, "txn": txn_launches,
                   **svc_row["launches"], **cap_row["launches"],
                   **suites_row["launches"], **sum_row["launches"]}

        main_shape = cases[1]
        emit({"kernels": [{
            "name": "rollout", "route": "cuda",
            "source": "jepsen_tpu_torch/checker/csrc/rollout.cu",
            "replaces": ROLLOUT_REPLACES,
            "launches": main_launches, "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases + adversarial),
            "ms": main_shape["kernel_ms"],
            "kernel_ms": main_shape["kernel_ms"],
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
            "shapes": cases}, fold_entry(stream_row, mon_row, svc_row,
                                         cap_row)]})
    finally:
        kept.close()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
