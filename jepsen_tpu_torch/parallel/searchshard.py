"""ONE single-key linearizability search sharded over a 1-D device mesh
(the counterpart of ``jepsen_tpu/parallel/searchshard.py``).

``keyshard.py`` scales MULTI-key workloads by making the key axis a
batch dimension. This module covers the other shape: a SINGLE long
history whose search uses every rank of the mesh.

The port runs SPMD over ``torch.distributed``: one process per rank,
each on the device its mesh names, each called with the same history.

* The DFS stack is **partitioned per rank**: each rank runs the whole
  expansion/rollout/dedup pipeline of ``torch_wgl`` on its own configs
  (a K=1 search with its own dedup table). Rank 0 starts with the root
  configuration, every other rank empty. Cross-rank duplicates are
  possible and sound: a missed dedup only costs re-exploration.
* **Collectives per iteration** (``torch_wgl._build_search`` with a
  group): an ``all_gather`` of the frontier sizes, one
  ``batch_isend_irecv`` hand-off of the deepest configs to a STARVING
  right neighbour around the ring (none at world size 1), and one
  ``all_reduce`` of (work, found) before each iteration, so every rank
  runs the same iterations: any rank's work keeps all stepping, any
  rank's success stops all.
* **Once per chunk** the ranks ``all_gather`` their status; rank 0's
  clock rides along and decides the next chunk bound and the timeout for
  every rank (each rank's own clock would let them disagree and
  deadlock).
* **Verdict assembly**, the same on every rank: valid if ANY rank found
  a linearization; invalid only when every rank's stack is empty and no
  rank dropped a config; otherwise unknown. Witness slots merge across
  ranks (deepest first), so the witness equals the JAX engine's.

Each rank's greedy rollout runs in the CUDA kernel where the gate admits
the model, as ``torch_wgl.check_encoded``'s does (the reference pins the
scan under ``shard_map``); the kernel equals the scan bit for bit, so
verdicts, counts and witnesses are unchanged. Heartbeats (with
``shard_tops``), the phase laps and the summary are emitted by rank 0
only.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from ..checker.torch_wgl import (IDX_BEST_DEPTH, IDX_BEST_LIN,
                                 IDX_BEST_STATE, IDX_DROPPED, IDX_EXPLORED,
                                 IDX_IT, IDX_ITS, IDX_STATUS, IDX_TOP,
                                 RUNNING, TOPK, VALID, _adapt_quantum,
                                 _attach_valid_witness, _attach_witness,
                                 _build_search, _plan_sizes,
                                 _prepare_search, make_consts)
from ..obs import phases as obs_phases
from ..obs import search as obs_search
from .keyshard import gather_rows, mesh_device, mesh_group, mesh_table_stats

#: the result's engine name (the certifier's DEVICE_ENGINES knows it)
ENGINE = "jax-wgl-sharded"


def check_encoded_sharded(spec, e, init_state, mesh,
                          max_configs=50_000_000, frontier_width=None,
                          stack_size=None, table_size=None,
                          timeout_s=None, chunk_iters=256, steal=16,
                          rollout_seeds=None, device=None):
    """Run ONE search for ``e`` sharded over ``mesh`` (a 1-D
    ``DeviceMesh``; any other shape raises ValueError). Every rank calls
    it with the same arguments and gets the same result: the dict of
    ``torch_wgl.check_encoded`` with engine ``"jax-wgl-sharded"``, plus
    ``shards`` and the per-rank ``shard_explored`` counts. ``device``
    may only repeat the mesh's."""
    group = mesh_group(mesh)
    dev = mesh_device(mesh, device)
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    lead = rank == 0
    ph = obs_phases.capture(ENGINE) if lead \
        else obs_phases.PhaseSession(ENGINE, None, None)
    prep = _prepare_search(spec, e, init_state)
    if prep[0] == "fast":
        return prep[1]
    (perm, inv32, ret32, fop, args, rets, ok_words, init_state, n_pad,
     C, A, S) = prep[1]
    ph.lap("encode")
    B, W, O, T = _plan_sizes(n_pad, S, C, frontier_width, stack_size,
                             table_size)
    max_iters = max(1, max_configs // (W * D))
    init_carry, _, run_chunk = _build_search(
        spec.step, 1, n_pad, B, S, C, A, W, O, T, NS=rollout_seeds,
        device=str(dev), group=group, steal=steal)
    ph.note_compile(dev.type == "cuda" and run_chunk.uses_kernel
                    and not _build.loaded("rollout"))
    ph.lap("plan")
    consts = make_consts(inv32, ret32, fop, args, rets, ok_words, dev)
    carry = init_carry(init_state[None])
    if not lead:
        # only rank 0 holds the root config: symmetric ranks would
        # explore identically forever; the steal ring feeds the rest
        carry = (carry[:IDX_TOP] + (torch.zeros_like(carry[IDX_TOP]),)
                 + carry[IDX_TOP + 1:])
    ph.sync(carry)
    ph.lap("h2d")

    so = obs_search.capture() if lead else obs_search.SearchObs(None, None)
    so.plan(ENGINE, n_pad, len(e), n_pad)
    t0 = time.monotonic()
    timed_out = False
    it = 0
    eff = min(chunk_iters, 32, max(1, (32 * 16384) // n_pad))
    while True:
        prev_it = it
        t_chunk = time.monotonic()
        bound = min(it + eff, max_iters)
        ph.lap("host")
        carry = run_chunk(carry, consts, bound)
        ph.sync(carry)
        dev_s = ph.lap("device", iteration=bound)
        # rank 0's clock: a chunk that does not end the search ran to
        # its bound on every rank, so the per-iteration wall is known
        # before the status gather it rides
        now = time.monotonic()
        per_it = max(1e-4, (now - t_chunk) / max(1, bound - prev_it))
        clock = [_adapt_quantum(
            chunk_iters, per_it, 3.0,
            timeout_s - (now - t0) if timeout_s is not None else None),
            timeout_s is not None and now - t0 > timeout_s]
        got = gather_rows(group, torch.cat([
            carry[IDX_STATUS].to(torch.int64), carry[IDX_TOP],
            carry[IDX_IT], carry[IDX_EXPLORED],
            carry[IDX_BEST_DEPTH].amax(dim=1),
            torch.as_tensor(clock, dtype=torch.int64, device=dev)]))
        got = got.cpu().numpy().reshape(D, -1)
        status, top, explored = got[:, 0], got[:, 1], got[:, 3]
        it = int(got[0, 2])
        ph.lap("d2h")
        # per-rank frontier sizes are the steal ring's balance signal
        so.heartbeat(ENGINE, iteration=it, chunk_s=time.monotonic() - t_chunk,
                     device_s=dev_s if ph.enabled else None,
                     frontier=int(top.sum()), explored=int(explored.sum()),
                     depth=max(0, int(got[:, 4].max())),
                     shard_tops=[int(t) for t in top])
        if (status == VALID).any() or not ((status == RUNNING)
                                           & (top > 0)).any() \
                or it >= max_iters:
            break
        eff = int(got[0, 5])
        if got[0, 6]:
            timed_out = True
            break

    ph.lap("host")
    parts = [carry[i].reshape(1, -1).to(torch.int64) for i in
             (IDX_STATUS, IDX_TOP, IDX_DROPPED, IDX_EXPLORED, IDX_ITS,
              IDX_BEST_DEPTH, IDX_BEST_LIN, IDX_BEST_STATE)]
    got = gather_rows(group, torch.cat(parts, dim=1)).cpu().numpy()
    tstats = mesh_table_stats(group, carry)
    ph.lap("d2h")
    status, top, dropped, explored, its = got[:, :5].T
    depth = got[:, 5:5 + TOPK]
    best_lin = got[:, 5 + TOPK:5 + TOPK + TOPK * B]
    best_state = got[:, 5 + TOPK + TOPK * B:]
    result = {"configs_explored": int(explored.sum()),
              "iterations": int(its.max()),
              "engine": ENGINE, "shards": D,
              "shard_explored": [int(x) for x in explored],
              **tstats}
    # every rank's TOPK witness slots as one slot group (the decoder
    # sorts by depth), so witness decoding matches the JAX engine's
    slots = {"best_depth": depth.reshape(-1),
             "best_lin": best_lin.astype(np.int32).view(np.uint32)
             .reshape(D * TOPK, B),
             "best_state": best_state.astype(np.int32)
             .reshape(D * TOPK, S)}
    if (status == VALID).any():
        result["valid"] = True
        _attach_valid_witness(result, e, slots, perm, spec, init_state)
    elif timed_out and ((status == RUNNING) & (top > 0)).any():
        result.update(valid="unknown", error="timeout")
    elif not (top > 0).any() and not dropped.any():
        # an empty-everywhere, nothing-dropped state is a sound
        # exhaustion proof whenever it was reached
        result["valid"] = False
        _attach_witness(result, e, slots, perm, spec, init_state)
    else:
        result.update(valid="unknown",
                      error="stack-overflow" if dropped.any()
                      else "max-configs-exceeded")
    so.summary(ENGINE, result, shard_explored=result["shard_explored"])
    ph.lap("host")
    return result


def check_history_sharded(spec, history, mesh, **kw):
    """Encode an event history and run the mesh-sharded search."""
    e, init_state = spec.encode(history)
    return check_encoded_sharded(spec, e, init_state, mesh, **kw)
