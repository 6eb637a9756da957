"""Where the time goes on the card, for the main path and the key batch.

``python -m jepsen_tpu_torch.profile_main`` (from the root of a checkout,
on a machine with one CUDA device) checks the two main-path histories of
``chip_smoke.py`` -- 10k ops, 64 processes, cas-register and mutex,
seeded with ``random.Random(45100)`` -- once to warm up, then again under
``torch.profiler``, and prints one JSON line per history: wall time;
the trace split at its first and last kernel into host time before the
search (encode, prepare), the search loop and host time after it
(witness decode and replay); kernel launches per iteration; device busy
time (the sum of kernel times: the search runs on one stream) and the
device's idle share; the rollout kernel's share; and the kernels that
take the most device time. On the card a search's chunks are replays
of a captured CUDA graph (``checker/chunk_graph.py``), so each row also
counts the host's launch calls from the profiler's runtime events
(``host_launches``: a kernel launch, or a graph launch counted as 1,
per iteration over the whole check and per replayed iteration between
the first and the last graph launch) beside the node count of each
graph captured, and the graphs captured, taken from the cache and
replayed (``graphs``). ``--trace-dir DIR`` also writes the Chrome
trace of each profiled check there (default: ``build/profile``).

``--batch`` profiles the key batch of ``chip_smoke.py`` instead: the JAX
package's headline batch (``simulate.bench_histories``: 256 cas-register
keys of 200 ops) through ``parallel.check_batch_encoded``, one warm-up
call and one profiled call, printed as one JSON line with the same
fields but the host time before and after the search (iterations are
the batch's: its longest-running key's), plus the compactions and the
invalid keys. Its trace is not written: it holds hundreds of thousands
of kernels. ``--keys K`` sizes that batch (default 256: the first K keys
of ``simulate.bench_histories``).

``--rung 0`` profiles the JAX package's rung 0 (``tools/profile_kernel.py
--rung 0``, the shape of ``BASELINE.json``'s primary metric, the longest
history decidable in 60 s): an 80,000-op, 64-process cas-register
history from ``random.Random(157000)`` at ``crash_p=0.05``, through
``torch_wgl.check_encoded(..., timeout_s=120, chunk_iters=32)`` after a
``max_configs=1`` warm-up. The whole search runs once unprofiled under
the phase plane: its wall, verdict, whether it hit the timeout, the
split at its first and last ``device`` lap into host time before the
search, the search and host time after it, rollout launches, and the
card's peak allocation beside ``sizemodel``'s prediction. ``torch.profiler``
cannot gather the kernel events of a 120 s search, so the profile covers
the search's first chunks only: a second run stopped at the first chunk
boundary past ``RUNG0_WINDOW_S`` (its chunks and verdict printed; all of
the search when it ends sooner), for launches per iteration, the
device's idle share in the search loop and the rollout kernel's share
of busy time (the first search captured the shape's graph, so this one
replays it from the cache). Its trace is not written either. An
undecided verdict at the timeout is a finding, not a failure.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

HISTORIES = (("cas-register", 0.05), ("mutex", 0.02))

#: rung 0 of ``tools/profile_kernel.py``: its seed (77000 + 80000),
#: processes, ops, crash probability, timeout and chunk size
RUNG0 = {"seed": 157_000, "processes": 64, "n_ops": 80_000,
         "crash_p": 0.05, "timeout_s": 120, "chunk_iters": 32}
#: the profiled window of rung 0: a search stopped at the first chunk
#: boundary past this many seconds
RUNG0_WINDOW_S = 3.0
#: the key batch's default width (``profile_kernel.py --keys``)
BATCH_KEYS = 256
#: the runtime calls that put work on the card: a kernel launch, or a
#: graph launch (1 whatever the graph's node count)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
#: appended by ``profile_call`` to a kernel launch call that ran no
#: kernel: a call recorded into a CUDA graph during its capture
CAPTURED = " (captured)"
#: kernels ``profile_call`` launches on the card before ``fn``, left out
#: of its events. On the H100 a profiling session in a process that has
#: run for minutes can lose the records of its first four kernels (their
#: launch calls recorded, the kernels not; ``chip_smoke.py``'s obs
#: phase prints the count as ``primer_records_lost``): these take that
#: loss in place of ``fn``'s first kernels
PRIMERS = 16
#: primer kernels launched and primer kernel records lost, over every
#: ``profile_call`` of the process (set them to 0 to start a count)
primers_launched = primer_records_lost = 0


def split(events, iterations):
    """The profiled run's time split from its events, each ``(start_us,
    end_us, name, is_kernel)``: the span from the first to the last
    event split at the first and last kernel, kernel launches (per
    iteration), device busy time and idle share, and the kernels that
    take the most device time."""
    start = min(e[0] for e in events)
    span = max(e[1] for e in events) - start
    kern = sorted((e for e in events if e[3]), key=lambda e: e[0])
    first = kern[0][0] - start
    last = kern[-1][1] - start
    busy = sum(e[1] - e[0] for e in kern)
    roll = sum(e[1] - e[0] for e in kern if "jt_rollout_kernel" in e[2])
    its = iterations or 1
    return {"iterations": iterations, "trace_span_s": span / 1e6,
            # host encode and prepare before the first kernel, the search
            # loop between, the witness decode and replay after the last
            "host_before_first_kernel_s": first / 1e6,
            "search_loop_s": (last - first) / 1e6,
            "host_after_last_kernel_s": (span - last) / 1e6,
            "search_loop_per_iteration_s": (last - first) / 1e6 / its,
            "kernel_launches_per_iteration": len(kern) / its,
            **kernel_stats(events, span / 1e6),
            "device_idle_share_in_search_loop": 1 - busy / (last - first),
            "rollout_kernel_s": roll / 1e6,
            "rollout_share_of_busy": roll / busy,
            **host_launches(events, iterations)}


def host_launches(events, iterations):
    """The host's launch calls (``LAUNCH_CALLS``, from events shaped as
    ``split``'s; the calls a capture recorded, marked ``CAPTURED``,
    counted apart): in all and per iteration, the graph launches among
    them, and per replayed iteration the mean of the calls from one
    graph launch to the next, over the intervals that hold no capture (a
    capture's interval also holds its shape's eager first iteration);
    None with fewer than two graph launches."""
    calls = sorted((e for e in events if not e[3] and e[2] in LAUNCH_CALLS),
                   key=lambda e: e[0])
    captured = sorted(e[0] for e in events
                      if not e[3] and e[2].endswith(CAPTURED))
    graphs = [e[0] for e in calls if e[2] == "cudaGraphLaunch"]
    per_replay = None
    spans = [(lo, hi) for lo, hi in zip(graphs, graphs[1:])
             if not any(lo <= t < hi for t in captured)]
    if spans:
        per_replay = sum(sum(1 for e in calls if lo <= e[0] < hi)
                         for lo, hi in spans) / len(spans)
    return {"host_launches": len(calls),
            "host_launches_per_iteration": len(calls) / (iterations or 1),
            "graph_launches": len(graphs),
            "captured_launch_calls": len(captured),
            "host_launches_per_replayed_iteration": per_replay}


def graphs_since(before):
    """The chunk graphs' counters since ``before`` (a
    ``torch_wgl.chunk_graph.stats()``): captures, cache hits, replays,
    evictions, and each new capture's node count."""
    from .checker import torch_wgl
    now = torch_wgl.chunk_graph.stats()
    new = now["captures"] - before["captures"]
    return {**{k: now[k] - before[k]
               for k in ("captures", "hits", "replays", "evictions")},
            "node_counts": now["node_counts"][-new:] if new else [],
            "cached": now["cached"], "cached_bytes": now["cached_bytes"]}


def kernel_stats(events, wall_s, top=10):
    """Kernel launches, device busy seconds (the sum of kernel times:
    the port runs on one stream), the device's idle share of ``wall_s``
    and the ``top`` kernels by device time, from events shaped as
    ``split``'s."""
    kern = [e for e in events if e[3]]
    busy = sum(e[1] - e[0] for e in kern) / 1e6
    by_name = {}
    for e in kern:
        us, c = by_name.get(e[2], (0.0, 0))
        by_name[e[2]] = (us + e[1] - e[0], c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernel_launches": len(kern), "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall_s if wall_s else None,
            "top_kernels": [{"name": k[:90], "device_s": us / 1e6,
                             "count": c} for k, (us, c) in ranked]}


def profile_case(model, crash_p, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import simulate
    from .checker import checkers, rollout, torch_wgl
    hist = simulate.random_history(random.Random(45100), model, 64, 10_000,
                                   crash_p)
    chk = checkers.linearizable({"model": model, "algorithm": "jax-wgl"})
    chk.check({}, hist)                              # warm-up
    torch.cuda.synchronize()
    rollout.launches = 0
    before = torch_wgl.chunk_graph.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        r = chk.check({}, hist)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace-{model}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [(e["ts"], e["ts"] + e["dur"], e["name"],
               e.get("cat") == "kernel")
              for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return {"model": model, "valid": r["valid"],
            "configs_explored": r.get("configs_explored"),
            "rollout_launches": rollout.launches, "wall_s": wall,
            "graphs": graphs_since(before),
            **split(ev, r.get("iterations"))}


def profile_call(fn, host_ops=True):
    """Run ``fn()`` once under ``torch.profiler`` and return ``(result,
    wall seconds, events)``, each event ``(start_us, end_us, name,
    is_kernel)`` from the profiler's raw events (a kernel is a CUDA
    device event other than a memcpy or memset). Raw events are read,
    not a Chrome trace, so calls of hundreds of thousands of kernels
    fit; their device timestamps are not aligned with the host's as the
    Chrome trace's are, so host time before and after the first and
    last kernel is not meaningful from them. ``host_ops=False`` records
    the card's activity alone, without the host's operator events: a
    call of hundreds of thousands of launches then leaves the profiler
    fewer events to gather when it stops (without a card, where the
    profiler has no device activity, host events are recorded all the
    same). A kernel launch call that ran no kernel, one a graph capture
    recorded, gets ``CAPTURED`` appended to its name. On the card the
    window opens with ``PRIMERS`` kernels of its own (``torch.cuda._sleep``),
    whose launch calls and kernels are left out of the events."""
    global primers_launched, primer_records_lost
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops or not cuda:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(PRIMERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    raw = list(prof.profiler.kineto_results.events())
    if cuda:
        # the primers are the window's first launch calls (nothing else
        # launches work while ``fn`` is profiled)
        calls = sorted((e for e in raw if e.device_type() != DeviceType.CUDA
                        and e.name() in LAUNCH_CALLS),
                       key=lambda e: e.start_ns())
        primer = {e.correlation_id() for e in calls[:PRIMERS]}
        kept = sum(e.device_type() == DeviceType.CUDA
                   and e.correlation_id() in primer for e in raw)
        primers_launched += PRIMERS
        primer_records_lost += PRIMERS - kept
        raw = [e for e in raw if e.correlation_id() not in primer
               and "spin_kernel" not in e.name()]
    # a kernel launch call whose correlation id no device event carries
    # ran nothing: a capture recorded it into a graph
    ran = {e.correlation_id() for e in raw
           if e.device_type() == DeviceType.CUDA}
    ev = []
    for e in raw:
        name = e.name()
        if (e.device_type() != DeviceType.CUDA and name in LAUNCH_CALLS
                and name != "cudaGraphLaunch" and ran - {0}
                and e.correlation_id() not in ran):
            name += CAPTURED
        ev.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name,
                   e.device_type() == DeviceType.CUDA
                   and not name.startswith(("Memcpy", "Memset"))))
    return out, wall, ev


def profile_batch(spec, pairs):
    """One profiled call of the key batch on ``pairs``: kernel launches
    (per iteration), device busy time and idle share, the search loop
    (first to last kernel) and the top kernels, plus the batch's
    compactions and verdict counts (``profile_call``)."""
    from . import parallel
    from .checker import torch_wgl
    before = torch_wgl.chunk_graph.stats()
    res, wall, ev = profile_call(
        lambda: parallel.check_batch_encoded(spec, pairs))
    out = split(ev, max((r.get("iterations") or 0) for r in res))
    del out["host_before_first_kernel_s"], out["host_after_last_kernel_s"]
    return {"keys": len(pairs), "graphs": graphs_since(before),
            "history_ops": sum(len(e) for e, _ in pairs),
            "compactions": max((r.get("compactions") or 0) for r in res),
            "invalid_keys": sum(r["valid"] is False for r in res),
            "unknown_keys": sum(r["valid"] == "unknown" for r in res),
            "wall_s": wall, **out}


def rung0_history(n_ops=RUNG0["n_ops"]):
    """Rung 0's history (``RUNG0``), cut to ``n_ops`` where a caller asks
    for fewer."""
    from . import simulate
    return simulate.random_history(random.Random(RUNG0["seed"]),
                                   "cas-register", RUNG0["processes"],
                                   n_ops, RUNG0["crash_p"])


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lap_split(events):
    """Host seconds before the search, the search and host seconds after
    it, from one search's phase-plane spans (``wgl.phase.*``, in time
    order): split at the first and last ``device`` lap."""
    laps = sorted((e for e in events if e.get("cat") == "phase"
                   and e["name"].startswith("wgl.phase.")),
                  key=lambda e: e["ts"])
    dev = [i for i, e in enumerate(laps) if e["name"] == "wgl.phase.device"]
    if not dev:
        return {"host_before_search_s": sum(e["dur"] for e in laps) / 1e6,
                "search_s": 0.0, "host_after_search_s": 0.0}

    def secs(part):
        return sum(e["dur"] for e in part) / 1e6

    return {"host_before_search_s": secs(laps[:dev[0]]),
            "search_s": secs(laps[dev[0]:dev[-1] + 1]),
            "host_after_search_s": secs(laps[dev[-1] + 1:])}


def profile_rung0(n_ops=RUNG0["n_ops"], timeout_s=RUNG0["timeout_s"],
                  window_s=RUNG0_WINDOW_S, device=None):
    """Rung 0 on ``device`` (None: CUDA): the whole search unprofiled,
    then its first chunks under ``torch.profiler`` (``profile_call``),
    as one row (the module's docstring)."""
    import torch

    from . import models, obs, resolve_device
    from .analysis import sizemodel
    from .checker import rollout, torch_wgl
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    spec = models.cas_register_spec
    chunk = RUNG0["chunk_iters"]
    hist = rung0_history(n_ops)
    t0 = time.monotonic()
    e, st = spec.encode(hist)
    encode_s = time.monotonic() - t0
    prep = torch_wgl._prepare_search(spec, e, st)
    if prep[0] == "fast":
        raise RuntimeError(f"rung 0: the host pre-check decided the "
                           f"history ({prep[1].get('valid')!r}); nothing "
                           f"to profile")
    *_, n_pad, C, A, S = prep[1]
    predicted = sizemodel.search_shape(
        "cas-register", len(e), concurrency=C,
        engine="torch-wgl")["hbm"]["total"]
    torch_wgl.check_encoded(spec, e, st, max_configs=1, device=dev)
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    rollout.launches = 0
    before = torch_wgl.chunk_graph.stats()
    test = {}
    with obs.run_scope(test):
        t0 = time.monotonic()
        r = torch_wgl.check_encoded(spec, e, st, timeout_s=timeout_s,
                                    chunk_iters=chunk, device=dev)
        _sync(dev)
        wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    launches = rollout.launches
    graphs = graphs_since(before)
    its = r.get("iterations") or 0
    row = {"rung": 0, "model": "cas-register",
           "n_ops": sum(1 for o in hist if o["type"] == "invoke"),
           "n_encoded": len(e), "n_padded": n_pad, "concurrency": C,
           "valid": r["valid"],
           "timed_out": r.get("error") == "timeout",
           "timeout_s": timeout_s, "chunk_iters": chunk,
           "configs_explored": r.get("configs_explored"),
           "iterations": its, "wall_s": wall, "encode_s": encode_s,
           **lap_split(test["obs"]["tracer"].events()),
           "rollout_launches": launches,
           "rollout_launches_per_iteration": launches / its if its else None,
           "peak_bytes": peak, "predicted_bytes": predicted,
           "peak_over_predicted": peak / predicted if cuda else None,
           "graphs": graphs}
    before = torch_wgl.chunk_graph.stats()
    res, pwall, ev = profile_call(
        lambda: torch_wgl.check_encoded(spec, e, st, timeout_s=window_s,
                                        chunk_iters=chunk, device=dev),
        host_ops=False)
    pits = res.get("iterations") or 0
    window = split(ev, pits)
    del window["host_before_first_kernel_s"], \
        window["host_after_last_kernel_s"]
    row["profiled_window"] = {"timeout_s": window_s, "wall_s": pwall,
                              "chunks": -(-pits // chunk),
                              "valid": res["valid"],
                              "graphs": graphs_since(before), **window}
    return row


def batch_pairs(keys=BATCH_KEYS):
    """The ``--batch`` rung's encoded keys: the first ``keys`` of
    ``simulate.bench_histories``."""
    from . import models, simulate
    spec = models.cas_register_spec
    return spec, [spec.encode(h) for h in simulate.bench_histories(keys)[0]]


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.profile_main")
    ap.add_argument("--trace-dir", default=os.path.join("build", "profile"))
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--batch", action="store_true",
                       help="profile the key batch instead of the main "
                       "path")
    which.add_argument("--rung", type=int, choices=(0,),
                       help="profile rung 0 (the 80,000-op history)")
    ap.add_argument("--keys", type=int, default=BATCH_KEYS,
                    help="keys of the --batch rung (default 256)")
    args = ap.parse_args(argv)
    if args.keys < 1:
        ap.error("--keys must be at least 1")
    if args.keys != BATCH_KEYS and not args.batch:
        ap.error("--keys sizes the --batch rung")
    return args


def main(argv=None):
    import torch
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    if args.batch:
        from . import parallel
        spec, pairs = batch_pairs(args.keys)
        parallel.check_batch_encoded(spec, pairs)       # warm-up
        print(json.dumps({"batch": "cas-register",
                          **profile_batch(spec, pairs)}), flush=True)
        return 0
    if args.rung == 0:
        print(json.dumps(profile_rung0()), flush=True)
        return 0
    for model, crash_p in HISTORIES:
        print(json.dumps(profile_case(model, crash_p, args.trace_dir)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
