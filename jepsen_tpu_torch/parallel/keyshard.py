"""Multi-key batched linearizability checking on one card.

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
summary); their progress rides the chunk's one status read. Not ported
yet (ROADMAP.md A.10): the mesh batch.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..checker.torch_wgl import (IDX_BEST_DEPTH, IDX_BEST_LIN,
                                 IDX_BEST_STATE, IDX_DROPPED, IDX_EXPLORED,
                                 IDX_ITS, IDX_STATUS, IDX_TOP, INF32,
                                 RUNNING, _NP_DTYPES, CARRY_LAYOUT, N_CARRY,
                                 _adapt_quantum, _apply_prune, _bucket,
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

    ``mesh`` is not ported yet and raises NotImplementedError
    (ROADMAP.md A.10).
    """
    if mesh is not None:
        raise NotImplementedError(
            "check_batch_encoded(mesh=...) is not ported to "
            "jepsen_tpu_torch yet: ROADMAP.md queue A, A.10 (the "
            "multi-device search)")
    dev = resolve_device(device)
    K_real = len(pairs)
    if K_real == 0:
        return []

    # phase cursor (obs.phases): per-dispatch attribution of the batch
    ph = obs_phases.capture("jax-wgl-batch")
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
    # power of two, so batch sizes and compaction steps hit the same
    # buckets
    K = _bucket(len(cols), 1)
    while len(cols) < K:
        cols.append(_dummy_key(n_pad, S_pad, A))
        salts.append(0)
    # the batch pins the scan rollout: no kernel library to build, so no
    # compile phase
    ph.lap("plan")
    perms = [c[7] for c in cols]          # host-only: witness decoding
    consts = make_batch_consts([c[:6] for c in cols], salts, dev)

    def build_search(Kc, Wc):
        """The search for a (possibly compacted) batch width."""
        return _build_search(spec.step, Kc, n_pad, B, S_pad, C, A, Wc, O, T,
                             R=R_batch, NS=rollout_seeds,
                             rollout_kernel="scan", device=str(dev))

    def wide_W(Kc):
        # budget lanes per key as the batch shrinks, honoring the same
        # (W, C, S) ~256 MB step-tensor cap as _plan_sizes
        return max(W, min(2048, 4096 // max(1, Kc),
                          max(8, (64 << 20) // max(1, C * S_pad))))

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
            spec, cols, salts, (n_pad, B, S_pad, C, A, W, O, T, 1, K))
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
        carry = carry_from_numpy(carry_np, dev)
    else:
        init_carry, _, run_chunk = build_search(K, W)
        carry = init_carry(np.stack([c[6] for c in cols]))
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
    so = obs_search.capture()
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
        got = {name: carry[i].cpu().numpy() for name, i in _HARVEST.items()}
        ph.lap("d2h")
        got["best_lin"] = got["best_lin"].view(np.uint32)
        for r in rows:
            if alive[r] >= 0:
                harvested[alive[r]] = {k: v[r] for k, v in got.items()}

    while True:
        bound = min(it + eff_chunk, max_iters)
        t_chunk = time.monotonic()
        prev_it = it
        ph.lap("host")
        carry = run_chunk(carry, consts, bound)
        # the device bracket's synchronize exists only while phase
        # attribution is on; the status read below is the chunk's sync
        ph.sync(carry)
        dev_s = ph.lap("device", iteration=bound)
        it = bound
        # one host round trip for the whole progress state; bound, the
        # heartbeat's per-row explored and witness depths ride it at the
        # same two launches (cast and cat)
        Kc = len(alive)
        if so.enabled():
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
        now = time.monotonic()
        per_it = max(1e-4, (now - t_chunk) / max(1, it - prev_it))
        # chunk granularity shrinks as the live batch width grows, so
        # compaction gets its chances
        width_cap = max(4, chunk_iters * 8 // max(16, len(alive)))
        eff_chunk = _adapt_quantum(
            min(chunk_iters, width_cap), per_it, 1.0,
            timeout_s - (now - t0) if timeout_s is not None else None)
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
        now = time.monotonic()
        if checkpoint is not None and now - last_ckpt >= checkpoint_every_s:
            _save_batch_checkpoint(checkpoint, fingerprint, carry, alive,
                                   it, harvested)
            last_ckpt = now
        if timeout_s is not None and now - t0 > timeout_s:
            # the not-all-decided save below writes the snapshot
            timed_out = True
            harvest(range(len(alive)), carry)
            break
        # Compact the batch once most keys are done: stragglers would
        # otherwise drag every finished key's lanes through many more
        # lockstep iterations. As the batch shrinks, widen the per-key
        # frontier -- carries are W-independent, so the wider search
        # picks up the stragglers' stacks and the dedup table as-is.
        if len(alive) > 1 and n_run <= len(alive) // 2:
            n_compactions += 1
            done_rows = [r for r in range(len(alive)) if not running[r]]
            harvest(done_rows, carry)
            keep = [r for r in range(len(alive)) if running[r]]
            newK = _bucket(n_run, 1)
            idx = keep + [done_rows[0]] * (newK - n_run)
            carry, consts = compact(
                carry, consts,
                torch.as_tensor(idx, dtype=torch.int64, device=dev))
            alive = [alive[r] for r in keep] + [-1] * (newK - n_run)
            _, _, run_chunk = build_search(newK, wide_W(newK))

    # never clobber a snapshot that belongs to a different check
    if checkpoint is not None and _checkpoint_owned(checkpoint,
                                                    fingerprint):
        all_decided = (not timed_out and len(harvested) == len(live)
                       and all(int(h["status"]) != RUNNING
                               or int(h["top"]) == 0
                               for h in harvested.values()))
        if all_decided:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(checkpoint)
        else:
            _save_batch_checkpoint(checkpoint, fingerprint, carry, alive,
                                   it, harvested)

    # the dedup table is shared across keys (key-salted), so occupancy
    # diagnostics are batch-wide: the same numbers go on every searched
    # key's result
    ph.lap("host")
    tstats = table_stats(carry)
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
