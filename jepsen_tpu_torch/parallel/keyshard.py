"""Multi-key batched linearizability checking, on one card or over a
1-D device mesh.

jepsen.independent lifts a single-key test to many keys and checks per-key
subhistories in parallel on CPU threads (reference independent.clj:264-315,
bounded-pmap at :285). Here, as in ``jepsen_tpu/parallel/keyshard.py``,
the key axis is the batch axis of the WGL search (``torch_wgl``): every
key's branch-and-bound advances in lockstep in one search, all keys
sharing one key-salted claim array and dedup table.

Keys finish at different times; the host polls per-key status between
bounded chunks, harvests finished keys, and *compacts* the batch (power-of-
two buckets) so stragglers don't drag finished keys' lanes along --
widening the per-key frontier as the batch shrinks.

The batch rolls its greedy chains on the scan path, one chain per key
(R = 256 steps, none for n <= 64), as the reference pins it
(``keyshard.py:214-226``, ``:271``): the rollout kernel serves single-key
searches only. A batch checkpoints as the reference's does: the carry
in the JAX package's layout, the alive-row map, the iteration and every
already-harvested key's verdict, under the reference's fingerprint.
Under a bound obs registry the batch reports the JAX batch's series
(``wgl.phase_s``, a ``plan`` with keys, lanes and owners, one heartbeat
per chunk with ``keys_alive``, ``keys_running`` and ``compactions``, a
summary); their progress rides the chunk's one status read.

**The mesh batch.** With ``mesh`` (a 1-D
``torch.distributed.device_mesh.DeviceMesh``), the search runs SPMD: one
process per rank, each on its own device, each called with the same
pairs. The key axis, padded to a multiple of the mesh size D, is block
sharded: rank r searches rows ``[r*K/D, (r+1)*K/D)`` with its own claim
array and dedup table, as each device does under the reference's
``shard_map`` (``keyshard.py:228-345``). The loop has no collective per
iteration; once per chunk the ranks ``all_gather`` their rows' status
(rank 0's clock rides along, so every rank takes the same chunk bound,
checkpoint and timeout decisions), a harvest gathers the finished rows,
and a compaction gathers the keyed carry rows, compacts them as one
batch and re-splits them, while each table group stays on its rank.
Every rank returns the same results. A checkpoint is written by rank 0
in the JAX package's layout with D table groups, so a snapshot resumes
across the two engines at the same mesh size.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..checker.torch_wgl import (IDX_BEST_DEPTH, IDX_BEST_LIN,
                                 IDX_BEST_STATE, IDX_BUF_FP, IDX_BUF_LIN,
                                 IDX_BUF_STATE, IDX_DROPPED, IDX_EXPLORED,
                                 IDX_ITS, IDX_STATUS, IDX_TAB, IDX_TFAIL,
                                 IDX_TOP, INF32, KEYED, RUNNING,
                                 _NP_DTYPES, CARRY_LAYOUT, N_CARRY,
                                 _adapt_quantum, _apply_prune, _bucket,
                                 _collective,
                                 _build_search, _checkpoint_owned,
                                 _encode_arrays, _fast_result, _interpret,
                                 _n_floor, _plan_sizes, _priority_order,
                                 _state_abstraction_check, carry_from_numpy,
                                 carry_to_numpy, compact, make_batch_consts,
                                 max_point_concurrency, read_snapshot,
                                 table_stats, write_snapshot)
from ..history import INF_TIME
from ..obs import phases as obs_phases
from ..obs import search as obs_search

logger = logging.getLogger(__name__)

#: the per-key carry fields a harvest reads
_HARVEST = {"status": IDX_STATUS, "top": IDX_TOP, "dropped": IDX_DROPPED,
            "explored": IDX_EXPLORED, "iterations": IDX_ITS,
            "best_depth": IDX_BEST_DEPTH, "best_lin": IDX_BEST_LIN,
            "best_state": IDX_BEST_STATE}

#: the stack buffers, stored flat as ``(K*O+1, ...)`` with a sentinel row
_FLAT = (IDX_BUF_LIN, IDX_BUF_STATE, IDX_BUF_FP)


# ---------------------------------------------------------------------------
# mesh helpers (the counterparts of the reference's shard_map_compat and
# _shard_specs, keyshard.py:47-108): the mesh's group and device, a
# rank's block of rows, and the gathers that assemble the global batch

def mesh_group(mesh):
    """The process group of a 1-D ``DeviceMesh``. Any other mesh raises:
    the search shards over exactly one axis (the reference takes the
    first axis of whatever mesh it is given, ``searchshard.py:77``)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                        f"not {type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(
            f"the multi-device search shards over a 1-D DeviceMesh "
            f"(init_device_mesh(device_type, (D,))), not a {mesh.ndim}-D "
            f"mesh of shape {tuple(mesh.shape)}")
    return mesh.get_group()


def mesh_device(mesh, device=None):
    """The device this rank runs on: ``cuda:<current>`` for a "cuda"
    mesh (each rank sets its card with ``torch.cuda.set_device``), the
    CPU for a "cpu" mesh. An explicit ``device`` that disagrees with the
    mesh raises."""
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    elif mesh.device_type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported mesh device type "
                         f"{mesh.device_type!r}")
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None
                                     and want.index != dev.index):
            raise ValueError(f"device {want} disagrees with the mesh's "
                             f"{dev}")
    return dev


def block_rows(K, D, rank):
    """The rows ``[lo, hi)`` of a K-row batch that ``rank`` of ``D``
    holds (K a multiple of D)."""
    per = K // D
    return rank * per, (rank + 1) * per


def gather_rows(group, x):
    """Every rank's ``x`` concatenated along dim 0 in rank order (equal
    shapes on every rank; bool travels as uint8)."""
    if x.dtype == torch.bool:
        return gather_rows(group, x.to(torch.uint8)).bool()
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _collective(dist.all_gather_into_tensor, out, x, group=group)
    return out


def _gather_carry(group, carry, groups=False):
    """The global carry from every rank's block: the keyed rows in rank
    order (each flat stack buffer keeps one zero sentinel row). With
    ``groups`` the table groups are gathered too, one per rank (the
    reference's global ``(G, ...)`` arrays); else each rank keeps its
    own."""
    out = []
    for i, x in enumerate(carry):
        if i in _FLAT:
            x = torch.cat([gather_rows(group, x[:-1]),
                           torch.zeros_like(x[-1:])])
        elif i in KEYED or groups:
            x = gather_rows(group, x)
        out.append(x)
    return tuple(out)


def _carry_block(carry, lo, hi):
    """Rows ``[lo, hi)`` of a global carry's keyed arrays; the rest as
    they are."""
    out = []
    K = carry[IDX_TOP].shape[0]
    for i, x in enumerate(carry):
        if i in _FLAT:
            O = (x.shape[0] - 1) // K
            x = torch.cat([x[lo * O:hi * O], torch.zeros_like(x[-1:])])
        elif i in KEYED:
            x = x[lo:hi]
        out.append(x)
    return tuple(out)


def _pad_key(e, init_state, spec, n_pad, S_pad, A, enc):
    """Priority-sort one key's encoded arrays (see
    torch_wgl._priority_order) and pad to the common bucket sizes. Returns
    the padded columns plus the priority perm for witness decoding."""
    n = len(e)
    inv32, ret32, _ = enc
    perm, inv32, ret32, fop, args, rets, ok_words = \
        _priority_order(spec, e, inv32, ret32)
    pn = n_pad - n
    inv32 = np.concatenate([inv32, np.full(pn, INF32 - 1, np.int32)])
    ret32 = np.concatenate([ret32, np.full(pn, INF32, np.int32)])
    fop = np.concatenate([fop, np.zeros(pn, np.int32)])
    args = np.concatenate([args, np.zeros((pn, A), np.int32)])
    rets = np.concatenate([rets, np.zeros((pn, A), np.int32)])
    extra = (n_pad + 31) // 32 - len(ok_words)
    ok_words = np.concatenate([ok_words, np.zeros(extra, np.uint32)])
    st = np.asarray(init_state, np.int32)
    if len(st) < S_pad:
        if spec.pad_state is not None:
            st = np.asarray(spec.pad_state(st, S_pad), np.int32)
        else:
            raise ValueError(
                f"model {spec.name} has varying state sizes but no pad_state")
    return inv32, ret32, fop, args, rets, ok_words, st, perm


def _dummy_key(n_pad, S_pad, A):
    """All padding rows, no ok ops: finishes on its first iteration."""
    return (np.full(n_pad, INF32 - 1, np.int32),
            np.full(n_pad, INF32, np.int32),
            np.zeros(n_pad, np.int32),
            np.zeros((n_pad, A), np.int32),
            np.zeros((n_pad, A), np.int32),
            np.zeros((n_pad + 31) // 32, np.uint32),
            np.zeros(S_pad, np.int32),
            None)


def check_batch_encoded(spec, pairs, max_configs=50_000_000,
                        chunk_iters=256, timeout_s=None, mesh=None,
                        frontier_width=None, stack_size=None,
                        table_size=None, checkpoint=None,
                        checkpoint_every_s=60.0, rollout_seeds=None,
                        owners=None, n_floor=None, device=None):
    """Check many keys' histories at once.

    ``pairs`` is a list of (EncodedHistory, init_state). Returns a list of
    per-key result dicts (same shape as torch_wgl.check_encoded results,
    plus the batch-wide ``compactions`` and table diagnostics).
    ``device=None`` means CUDA (raising without a card); the CPU runs
    only when asked for. Any failure raises: there is no per-key or CPU
    fallback.

    ``owners`` (optional, parallel to ``pairs``) labels each key with
    the tenant that submitted it. Pure metadata: the distinct-owner count
    of the searched keys lands on every searched key's result as
    ``batch_owners``.

    ``n_floor`` (optional) raises the op-count bucket floor for this
    batch (padding rows are inert); it never lowers it below the shared
    floor.

    ``checkpoint`` names a file the batch state is snapshotted to (every
    ``checkpoint_every_s``, between chunks, and when a run ends with a
    key undecided): the carry, the alive-row map, the iteration and
    every already-harvested key's verdict, so a rerun with the same
    arguments resumes mid-search, also after a compaction. The
    fingerprint covers every per-key input and the plan sizes but not
    the budget, so a budget-exhausted snapshot resumes under a larger
    one. A stale or foreign file is ignored and left alone.

    ``mesh`` (a 1-D ``DeviceMesh``; any other shape raises ValueError)
    block-shards the key axis over its ranks (see the module docstring):
    every rank calls with the same arguments and gets the same results,
    and its device comes from the mesh.
    """
    group = G = None
    if mesh is not None:
        group = mesh_group(mesh)
        dev = mesh_device(mesh, device)
        G, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        dev = resolve_device(device)
    K_real = len(pairs)
    if K_real == 0:
        return []

    # phase cursor (obs.phases): per-dispatch attribution of the batch;
    # under a mesh rank 0 reports for every rank
    lead = group is None or rank == 0
    ph = obs_phases.capture("jax-wgl-batch") if lead \
        else obs_phases.PhaseSession("jax-wgl-batch", None, None)
    results = [None] * K_real
    live = []
    encs = {}
    for k, (e, st) in enumerate(pairs):
        if len(e) == 0 or e.n_ok == 0:
            results[k] = {"valid": True, "configs_explored": 0}
            continue
        enc = _encode_arrays(e)          # computed once, reused below
        fast = (spec.fast_check(e, enc[0], enc[1])
                if spec.fast_check is not None else None)
        if fast is None and spec.pad_state is None:
            fast = _state_abstraction_check(spec, e, st)
        if fast is not None:
            results[k] = _fast_result(spec, e, st, fast)
            continue
        inv32, ret32 = _apply_prune(spec, e, enc[0], enc[1])
        encs[k] = (inv32, ret32, enc[2])
        live.append(k)
    if not live:
        return results
    ph.lap("encode")

    # common bucket sizes across live keys
    n_pad = _bucket(max(len(pairs[k][0]) for k in live),
                    max(_n_floor(), int(n_floor or 1)))
    A = max(int(pairs[k][0].args.reshape(len(pairs[k][0]), -1).shape[1])
            for k in live)
    S_pad = max(len(pairs[k][1]) for k in live)
    if spec.pad_state is not None:
        S_pad = _bucket(S_pad, 2)
    C = 4
    for k in live:
        inv32, ret32, _ = encs[k]
        C = max(C, max_point_concurrency(
            inv32, np.where(ret32 == INF32, INF_TIME,
                            ret32.astype(np.int64))))
    C = min(_bucket(C, 4), n_pad)

    # shrink per-key budgets relative to single-key defaults: many keys
    # share the card, and a narrow per-key frontier keeps the batched
    # search depth-first (wide frontiers degenerate to BFS over the whole
    # config space, which is catastrophic for valid histories)
    n_live = len(live)
    B, W, O, T = _plan_sizes(n_pad, S_pad, C, frontier_width, stack_size,
                             table_size)
    if frontier_width is None:
        # narrow per key as the batch grows, but never RAISE W above
        # what _plan_sizes chose (its (W, C, S) memory cap must survive)
        W = min(W, max(32, 4096 // _bucket(n_live, 1)))
    O = max(4096, O // _bucket(min(n_live, 8), 1))
    max_iters = max(1, max_configs // (W * n_live))
    if rollout_seeds is None:
        # one greedy chain per key: the key axis already fills the card
        rollout_seeds = 1
    # the batch's rollout depth, also for a batch compacted down to one
    # key (the single-key default is deeper)
    R_batch = 0 if n_pad <= 64 else min(256, n_pad)

    cols = [_pad_key(pairs[k][0], pairs[k][1], spec, n_pad, S_pad, A,
                     encs[k])
            for k in live]
    salts = [k + 1 for k in live]
    # pad the key batch with dummy keys (they finish at once) up to a
    # power of two (and a multiple of the mesh size), so batch sizes and
    # compaction steps hit the same buckets
    K = _bucket(len(cols), 1)
    if group is not None:
        while K % G:
            K += 1
    while len(cols) < K:
        cols.append(_dummy_key(n_pad, S_pad, A))
        salts.append(0)
    # the batch pins the scan rollout: no kernel library to build, so no
    # compile phase
    ph.lap("plan")
    perms = [c[7] for c in cols]          # host-only: witness decoding
    # under a mesh ``consts`` holds every row (each rank slices its
    # block), as the reference's global const arrays do
    consts = make_batch_consts([c[:6] for c in cols], salts, dev)
    Gs = G or 1           # table groups: one per rank

    def build_search(Kc, Wc):
        """The search for a (possibly compacted) batch width: under a
        mesh, the rank's block of Kc / D keys with its own table group
        (the reference builds its local search without a mesh axis, so
        the loop has no collective)."""
        return _build_search(spec.step, Kc // Gs, n_pad, B, S_pad, C, A,
                             Wc, O, T, R=R_batch, NS=rollout_seeds,
                             rollout_kernel="scan", device=str(dev))

    def wide_W(Kc):
        # budget lanes per key (per rank's block under a mesh) as the
        # batch shrinks, honoring the same (W, C, S) ~256 MB step-tensor
        # cap as _plan_sizes
        return max(W, min(2048, 4096 // max(1, Kc // Gs),
                          max(8, (64 << 20) // max(1, C * S_pad))))

    def local(consts):
        """This rank's block of the global const rows."""
        if group is None:
            return consts
        lo, hi = block_rows(consts[0].shape[0], G, rank)
        return tuple(c[lo:hi] for c in consts)

    def consts_for(alive_rows):
        sel = [cols[j][:6] if j >= 0 else _dummy_key(n_pad, S_pad, A)[:6]
               for j in alive_rows]
        return make_batch_consts(
            sel, [live[j] + 1 if j >= 0 else 0 for j in alive_rows], dev)

    fingerprint = resumed = None
    if checkpoint is not None:
        # the budget is not fingerprinted: a budget-exhausted snapshot
        # resumes under a larger one
        fingerprint = _batch_fingerprint(
            spec, cols, salts, (n_pad, B, S_pad, C, A, W, O, T, Gs, K))
        resumed = _load_batch_checkpoint(checkpoint, fingerprint)
        if resumed is None and not _checkpoint_owned(checkpoint,
                                                     fingerprint):
            logger.warning("checkpoint %s belongs to a different check; "
                           "checkpointing disabled for this run",
                           checkpoint)
            checkpoint = None
    if resumed is not None:
        carry_np, alive, it, harvested = resumed
        consts = consts_for(alive)
        _, _, run_chunk = build_search(
            len(alive), W if len(alive) == K else wide_W(len(alive)))
        if group is not None:
            # this rank's keyed rows and its own table group
            lo, hi = block_rows(len(alive), G, rank)
            carry_np = [x[lo:hi] if i in KEYED else x[rank:rank + 1]
                        for i, x in enumerate(carry_np)]
        carry = carry_from_numpy(carry_np, dev)
    else:
        init_carry, _, run_chunk = build_search(K, W)
        states = np.stack([c[6] for c in cols])
        if group is not None:
            lo, hi = block_rows(K, G, rank)
            states = states[lo:hi]
        carry = init_carry(states)
        # alive[r] = index into `live` for row r, or -1 for dummy rows
        alive = [j if j < len(live) else -1 for j in range(K)]
        harvested = {}
        it = 0
    ph.sync(carry)
    ph.lap("h2d")
    t0 = time.monotonic()
    last_ckpt = t0
    timed_out = False
    n_compactions = 0
    # sinks captured once at search start (see obs.search)
    so = obs_search.capture() if lead else obs_search.SearchObs(None, None)
    n_owners = len({str(owners[k]) for k in live}) \
        if owners is not None else None
    # padding accounting: the live keys' real rows against K * n_pad
    so.plan("jax-wgl-batch", n_pad, sum(len(pairs[k][0]) for k in live),
            K * n_pad, keys=len(live), lanes=K, owners=n_owners)
    # adaptive dispatch quantum (torch_wgl._adapt_quantum): ~1 s of
    # measured per-iteration wall, capped by the live-width term below
    # and by ``chunk_iters``; harvest and compaction run between chunks
    eff_chunk = max(1, min(chunk_iters, 8, (8 * 16384) // n_pad))

    def harvest(rows, carry):
        ph.lap("host")
        if group is None:
            got = {name: carry[i].cpu().numpy()
                   for name, i in _HARVEST.items()}
        else:
            got = _gather_harvest(group, carry)
        ph.lap("d2h")
        got["best_lin"] = got["best_lin"].view(np.uint32)
        for r in rows:
            if alive[r] >= 0:
                harvested[alive[r]] = {k: v[r] for k, v in got.items()}

    def clock(now):
        """(the next chunk's quantum, checkpoint now?, stop now?) from the
        host clock; under a mesh rank 0's decides for every rank."""
        per_it = max(1e-4, (now - t_chunk) / max(1, it - prev_it))
        # chunk granularity shrinks as the live batch width grows, so
        # compaction gets its chances
        width_cap = max(4, chunk_iters * 8 // max(16, len(alive)))
        return (_adapt_quantum(
            min(chunk_iters, width_cap), per_it, 1.0,
            timeout_s - (now - t0) if timeout_s is not None else None),
            checkpoint is not None
            and now - last_ckpt >= checkpoint_every_s,
            timeout_s is not None and now - t0 > timeout_s)

    def save(carry):
        # under a mesh rank 0 writes the global carry, D table groups
        if group is not None:
            carry = _gather_carry(group, carry, groups=True)
            if not lead:
                return
        _save_batch_checkpoint(checkpoint, fingerprint, carry, alive, it,
                               harvested)

    while True:
        bound = min(it + eff_chunk, max_iters)
        t_chunk = time.monotonic()
        prev_it = it
        ph.lap("host")
        carry = run_chunk(carry, local(consts), bound)
        # the device bracket's synchronize exists only while phase
        # attribution is on; the status read below is the chunk's sync
        ph.sync(carry)
        dev_s = ph.lap("device", iteration=bound)
        it = bound
        # one host round trip for the whole progress state; bound, the
        # heartbeat's per-row explored and witness depths ride it at the
        # same two launches (cast and cat)
        Kc = len(alive)
        if group is not None:
            # one all_gather of every rank's rows; rank 0's clock rides
            # along and decides for every rank
            now = time.monotonic()
            row = torch.cat([carry[IDX_STATUS].to(torch.int64),
                             carry[IDX_TOP], carry[IDX_ITS],
                             carry[IDX_EXPLORED],
                             carry[IDX_BEST_DEPTH].amax(dim=1),
                             torch.as_tensor(clock(now), dtype=torch.int64,
                                             device=dev)])
            got = gather_rows(group, row).cpu().numpy().reshape(G, -1)
            status, top, its, explored_k, bdepth = (
                got[:, :-3].reshape(G, 5, -1).transpose(1, 0, 2)
                .reshape(5, Kc))
            eff_chunk, want_ckpt, want_stop = (int(x) for x in got[0, -3:])
        elif so.enabled():
            got = torch.cat(
                [carry[IDX_STATUS].to(torch.int64), carry[IDX_TOP],
                 carry[IDX_ITS], carry[IDX_EXPLORED],
                 carry[IDX_BEST_DEPTH].reshape(-1)]).cpu().numpy()
            status, top, its, explored_k = got[:4 * Kc].reshape(4, Kc)
            bdepth = got[4 * Kc:]
        else:
            status, top, its = torch.stack(
                [carry[IDX_STATUS].to(torch.int64), carry[IDX_TOP],
                 carry[IDX_ITS]]).cpu().numpy()
        ph.lap("d2h")
        if group is None:
            now = time.monotonic()
            eff_chunk, want_ckpt, want_stop = clock(now)
        running = (status == RUNNING) & (top > 0) & (its < max_iters)
        n_run = int(running.sum())
        if so.enabled():
            # explored sums the LIVE rows only (compaction pads with a
            # copy of a finished row) plus what harvested keys
            # contributed before their rows were compacted away, so the
            # gauge stays monotone across compactions
            so.heartbeat(
                "jax-wgl-batch", iteration=it,
                chunk_s=time.monotonic() - t_chunk,
                device_s=dev_s if ph.enabled else None,
                frontier=int(top.sum()),
                explored=sum(int(explored_k[r]) for r in range(Kc)
                             if alive[r] >= 0)
                + sum(int(hv["explored"]) for hv in harvested.values()),
                depth=max(0, int(bdepth.max())),
                keys_alive=Kc, keys_running=n_run,
                compactions=n_compactions)
        if n_run == 0:
            harvest(range(len(alive)), carry)
            break
        if want_ckpt:
            save(carry)
            last_ckpt = now
        if want_stop:
            # the not-all-decided save below writes the snapshot
            timed_out = True
            harvest(range(len(alive)), carry)
            break
        # Compact the batch once most keys are done: stragglers would
        # otherwise drag every finished key's lanes through many more
        # lockstep iterations. As the batch shrinks, widen the per-key
        # frontier -- carries are W-independent, so the wider search
        # picks up the stragglers' stacks and the dedup table as-is.
        if len(alive) > Gs and n_run <= len(alive) // 2:
            n_compactions += 1
            done_rows = [r for r in range(len(alive)) if not running[r]]
            harvest(done_rows, carry)
            keep = [r for r in range(len(alive)) if running[r]]
            newK = _bucket(n_run, 1)
            while newK % Gs:           # a whole block of keys per rank
                newK += 1
            idx = keep + [done_rows[0]] * (newK - n_run)
            sel = torch.as_tensor(idx, dtype=torch.int64, device=dev)
            if group is None:
                carry, consts = compact(carry, consts, sel)
            else:
                # the keyed rows reshard; a moved key misses its old
                # rank's dedup entries (key-salted: a cost, never a
                # wrong answer), as under the reference's mesh
                full, consts = compact(_gather_carry(group, carry), consts,
                                       sel)
                carry = _carry_block(full, *block_rows(newK, G, rank))
            alive = [alive[r] for r in keep] + [-1] * (newK - n_run)
            _, _, run_chunk = build_search(newK, wide_W(newK))

    # never clobber a snapshot that belongs to a different check (under a
    # mesh only rank 0 reads the file: the gather is every rank's)
    if checkpoint is not None:
        all_decided = (not timed_out and len(harvested) == len(live)
                       and all(int(h["status"]) != RUNNING
                               or int(h["top"]) == 0
                               for h in harvested.values()))
        if group is not None and not all_decided:
            carry_all = _gather_carry(group, carry, groups=True)
        if lead and _checkpoint_owned(checkpoint, fingerprint):
            if all_decided:
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(checkpoint)
            else:
                _save_batch_checkpoint(
                    checkpoint, fingerprint,
                    carry if group is None else carry_all, alive, it,
                    harvested)

    # the dedup table is shared across keys (key-salted), so occupancy
    # diagnostics are batch-wide: the same numbers go on every searched
    # key's result (summed over the ranks' table groups under a mesh)
    ph.lap("host")
    tstats = table_stats(carry) if group is None \
        else mesh_table_stats(group, carry)
    ph.lap("d2h")
    for j, k in enumerate(live):
        per = harvested[j]
        if (timed_out and int(per["status"]) == RUNNING
                and int(per["top"]) > 0):
            results[k] = {"valid": "unknown", "error": "timeout",
                          "configs_explored": int(per["explored"]),
                          "engine": "jax-wgl"}
        else:
            results[k] = _interpret(spec, pairs[k][0], per, max_iters,
                                    False, pairs[k][1], perms[j])
        results[k].update(tstats)
        # batch-wide diagnostic: how often stragglers were compacted
        results[k]["compactions"] = n_compactions
        if n_owners is not None:
            results[k]["batch_owners"] = n_owners
    so.summary(
        "jax-wgl-batch",
        {"valid": "batch",
         "configs_explored": sum(int(hv["explored"])
                                 for hv in harvested.values()),
         "iterations": max((int(hv["iterations"])
                            for hv in harvested.values()), default=0),
         **tstats},
        keys=len(live))
    ph.lap("host")
    return results


def _gather_harvest(group, carry):
    """The harvest fields of every rank's rows in rank order, as numpy
    arrays of the dtypes a one-card harvest reads (one gather)."""
    parts = [carry[i].reshape(carry[i].shape[0], -1).to(torch.int64)
             for i in _HARVEST.values()]
    got = gather_rows(group, torch.cat(parts, dim=1)).cpu().numpy()
    out, at = {}, 0
    for (name, i), x in zip(_HARVEST.items(), parts):
        w = x.shape[1]
        shape = (got.shape[0],) + tuple(carry[i].shape[1:])
        dt = torch.empty(0, dtype=carry[i].dtype).numpy().dtype
        out[name] = got[:, at:at + w].reshape(shape).astype(dt)
        at += w
    return out


def mesh_table_stats(group, carry):
    """``table_stats`` over every rank's table group: the load over all
    D * T slots and the insert failures summed."""
    tab = carry[IDX_TAB][:, :-1]
    x = torch.stack([(tab != 0).any(dim=-1).sum(),
                     carry[IDX_TFAIL].sum()])
    _collective(dist.all_reduce, x, group=group)
    used, fails = x.tolist()
    total = dist.get_world_size(group) * int(tab.shape[0] * tab.shape[1])
    return {"table_load": round(used / total, 4),
            "table_insert_failures": fails}


def _batch_fingerprint(spec, cols, salts, plan):
    """sha256 over the carry layout, the model, the plan sizes, the salts
    (uint32) and every padded per-key input column: the JAX package's
    batch fingerprint, byte for byte."""
    h = hashlib.sha256()
    h.update(CARRY_LAYOUT.encode())
    h.update(spec.name.encode())
    h.update(np.asarray(plan, np.int64).tobytes())
    h.update(np.asarray(salts, np.uint32).tobytes())
    for c in cols:
        for i in range(7):                     # perm (c[7]) is derived
            h.update(np.ascontiguousarray(c[i]).tobytes())
    return h.hexdigest()


def _save_batch_checkpoint(path, fingerprint, carry, alive, it,
                           harvested):
    """Atomic snapshot: carry + alive map + iteration + already-harvested
    verdicts, every array in the JAX package's dtype."""
    hk = sorted(harvested)
    arrays = {f"c{i}": x for i, x in enumerate(carry_to_numpy(carry))}
    arrays.update(alive=np.asarray(alive, np.int64), it=np.int64(it),
                  hkeys=np.asarray(hk, np.int64))
    for name, i in _HARVEST.items():
        if hk:
            arrays[f"h_{name}"] = np.stack(
                [np.asarray(harvested[j][name]).astype(_NP_DTYPES[i])
                 for j in hk])
    write_snapshot(path, fingerprint, arrays)


def _load_batch_checkpoint(path, fingerprint):
    """-> (carry arrays, alive list, it, harvested dict) or None."""
    data = read_snapshot(path, fingerprint)
    if data is None:
        return None
    carry = [data[f"c{i}"] for i in range(N_CARRY)]
    alive = [int(x) for x in data["alive"]]
    harvested = {j: {name: data[f"h_{name}"][pos] for name in _HARVEST}
                 for pos, j in enumerate(int(x) for x in data["hkeys"])}
    return carry, alive, int(data["it"]), harvested


def check_batch_histories(spec, histories, **kw):
    """Encode per-key event histories and check them all on the device."""
    pairs = [spec.encode(hist) for hist in histories]
    return check_batch_encoded(spec, pairs, **kw)
