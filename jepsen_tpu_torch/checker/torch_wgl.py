"""Batched Wing-Gong-Lowe linearizability search in PyTorch, for the H100.

The counterpart of ``jepsen_tpu/checker/jax_wgl.py``, over an explicit
key axis K: ``check_encoded`` runs one key (K=1), and the key batch
(``jepsen_tpu_torch.parallel``) runs K keys in one search, every key's
fingerprints salted by its key id so that all keys share one claim array
and one dedup table. The same batched branch-and-bound over
configurations (bitset of linearized ops, model state), the same dedup,
witness tracking, greedy rollout and stack discipline, held bit for bit
against the JAX engine by the tests at K=1 and at K=4. What changes is
the machinery:

* ``lax.while_loop`` becomes a host loop over ``body``. Every masked
  update in ``body`` is a no-op once a key is no longer running, so the
  loop checks the status between iterations without changing a result.
* The greedy rollout runs in the hand-written CUDA kernel of
  ``rollout.py`` when the search has one key and the gate passes
  (``rollout_kernel="auto"`` on CUDA, or ``"kernel"``), else in the scan
  path ``roll_step`` (the key batch pins the scan, as the reference's
  does).
* uint32 words follow ``words.py``: bitsets are int32 bit patterns,
  fingerprint words int64 values in [0, 2^32).
* ``mode="drop"`` scatters write to a sentinel row instead: the stack
  buffers are stored flat with one extra row (index K*O, the reference's
  drop index) and the table with one extra slot per group (index T,
  re-zeroed after every write so it reads as the reference's fill 0).
* Scatters with duplicate indices (the twin claim, the table insert, the
  push) resolve to the last lane in lane order, as XLA's serial scatter
  does on the CPU, by an ``amax`` over lane indices first. So the search
  is deterministic on the card too, and iteration counts match the
  reference wherever the reference itself is deterministic.

The result's ``engine`` stays ``"jax-wgl"``: it is the name test maps and
the certifier (``jepsen_tpu.analysis.certify.DEVICE_ENGINES``) know this
engine by. Checkpoints share the JAX package's snapshot format, so a
search snapshotted by one engine resumes in the other. Under a bound obs
registry the search reports the JAX engine's series: ``wgl.phase_s`` by
phase (``obs/phases.py``), one heartbeat per chunk and a summary
(``obs/search.py``). Unbound, or with ``phases?`` off, it makes exactly
the syncs and launches it makes without obs. Not ported yet (ROADMAP.md
A.10): the mesh block.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import logging
import os
import time
import zipfile

import numpy as np
import torch

from .. import _build, resolve_device
from ..history import INF_TIME
from ..obs import phases as obs_phases
from ..obs import search as obs_search
from ..util import DEFAULT_N_FLOOR
from ..xp import NP, TORCH
from . import rollout, words
from .words import M32, u32

logger = logging.getLogger(__name__)

INF32 = np.int32(2**31 - 1)

#: linear-probe length for the dedup hash table
PROBES = 4

#: deepest-distinct-config witness slots per key
TOPK = 8

# status codes
RUNNING, VALID = np.int32(0), np.int32(1)

#: the JAX package's carry layout tag: ``carry_to_numpy`` yields exactly
#: that layout
CARRY_LAYOUT = (f"carry-v6:tab-interleaved,probes{PROBES},topk{TOPK},"
                "incfp,tfail")

(IDX_BUF_LIN, IDX_BUF_STATE, IDX_BUF_FP, IDX_TOP, IDX_TAB, IDX_DROPPED,
 IDX_STATUS, IDX_EXPLORED, IDX_BEST_DEPTH, IDX_BEST_LIN, IDX_BEST_STATE,
 IDX_ITS, IDX_IT, IDX_CLAIM, IDX_TFAIL) = range(15)

N_CARRY = IDX_TFAIL + 1

#: carry elements with a leading key axis (the stack buffers, flat
#: ``(K*O+1, ...)`` here, count as keyed); the table, ``it``, the claim
#: array and ``tfail`` are shared by every key
KEYED = (0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11)

#: twin-claim scratch size (fixed so carries are W-independent)
TC = 1 << 16


# ---------------------------------------------------------------------------
# host-side helpers (copies of jax_wgl's)

def max_point_concurrency(invoke_idx, return_idx):
    """Static bound C on WGL candidates: the max, over return points t, of
    |{i : invoke_i < t <= return_i}| (info ops stay open forever)."""
    n = len(invoke_idx)
    if n == 0:
        return 1
    finite = return_idx < INF_TIME
    if not finite.any():
        return n
    # returns sort before invokes at equal positions so an invoke AT t
    # is not counted (the stab requires invoke_i strictly < t)
    events = sorted(
        [(int(t), 1, +1) for t in invoke_idx] +
        [(int(t), 0, -1) for t in return_idx[finite]])
    best, open_ops = 1, 0
    for _t, kind, delta in events:
        if kind == 0:  # sample before closing the op at its return point
            best = max(best, open_ops)
        open_ops += delta
    return min(best, n)


def _bucket(x, lo):
    """Round up to a power of two (>= lo)."""
    return max(lo, 1 << (int(x) - 1).bit_length())


def _n_floor():
    return DEFAULT_N_FLOOR


def _adapt_quantum(cap, per_it, target_s, left_s=None):
    """Next dispatch quantum: ~``target_s`` of measured per-iteration
    wall, capped by ``chunk_iters`` and shrunk to fit the remaining wall
    budget ``left_s`` (budgets are enforced between dispatches)."""
    eff = max(1, min(cap, int(target_s / per_it)))
    if left_s is not None:
        eff = max(1, min(eff, int(left_s / per_it) + 1))
    return eff


def _plan_sizes(n, S, C, frontier_width=None, stack_size=None,
                table_size=None):
    """(B, W, O, T): bitset words, frontier width, stack and table sizes,
    as ``jax_wgl._plan_sizes`` chooses them (kept equal so parity
    compares equal shapes)."""
    B = max(1, (n + 31) // 32)
    if frontier_width is None:
        frontier_width = max(
            8, min(4096, 32768 // max(1, C), 16 * C,
                   (64 << 20) // max(1, C * S)))
    if stack_size is None:
        per = (B + S) * 4
        stack_size = max(4096, min(1 << 18, (128 << 20) // per))
    if table_size is None:
        table_size = max(1 << 20, min(1 << 23, 32 * n))
    return (B, _bucket(frontier_width, 8), _bucket(stack_size, 1024),
            _bucket(table_size, 1024))


def _encode_arrays(e):
    """Dense int32 arrays for the device search. Invoke/return indices are
    re-ranked to small ints; INF_TIME becomes INF32."""
    n = len(e)
    invoke = e.invoke_idx.astype(np.int64)
    ret = e.return_idx
    finite = np.concatenate([invoke, ret[ret < INF_TIME]])
    ranks = {v: i for i, v in enumerate(np.unique(finite))}
    inv32 = np.array([ranks[v] for v in invoke], np.int32) \
        if n else np.zeros(0, np.int32)
    ret32 = np.array([ranks[v] if v < INF_TIME else INF32 for v in ret],
                     np.int32) if n else np.zeros(0, np.int32)
    ok_words = np.zeros(max(1, (n + 31) // 32), np.uint32)
    for i in range(n):
        if e.is_ok[i]:
            ok_words[i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return inv32, ret32, ok_words


def _state_abstraction_check(spec, e, init_state, max_states=4096,
                             max_rounds=64):
    """Sound invalidity pre-check: enumerate an over-approximation of the
    reachable model states; an ok op whose step fails from EVERY
    reachable state appears in no linearization. Returns None (no claim)
    when the state space overflows the cap."""
    n = len(e)
    rows = np.concatenate(
        [np.asarray(e.f, np.int32)[:, None],
         np.asarray(e.args, np.int32).reshape(n, -1),
         np.asarray(e.ret, np.int32).reshape(n, -1)], axis=1)
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    if len(uniq) > 512:
        return None
    A = np.asarray(e.args, np.int32).reshape(n, -1).shape[1]
    uf = uniq[:, 0]
    ua = uniq[:, 1:1 + A]
    ur = uniq[:, 1 + A:]
    states = {np.asarray(init_state, np.int32).tobytes():
              np.asarray(init_state, np.int32)}
    frontier = list(states.values())
    possible = np.zeros(len(uniq), bool)
    for _ in range(max_rounds):
        new = []
        for st in frontier:
            for u in range(len(uniq)):
                st2, ok = spec.step(st, uf[u], ua[u], ur[u], NP)
                if not ok:
                    continue
                possible[u] = True
                st2 = np.asarray(st2, np.int32)
                key = st2.tobytes()
                if key not in states:
                    if len(states) >= max_states:
                        return None
                    states[key] = st2
                    new.append(st2)
        if not new:
            break
        frontier = new
    else:
        return None   # no fixpoint within the round budget
    bad = np.flatnonzero(~possible[inverse] & np.asarray(e.is_ok, bool))
    if len(bad):
        return False, {"op_index": int(bad[0]),
                       "pattern": "impossible-from-every-state",
                       "reachable_states": len(states)}
    return None


def _fast_result(spec, e, init_state, fast, confirm=False):
    """Shape a fast-path decision like a search result, including the
    failure witness op and optional oracle confirmation."""
    result = {"configs_explored": 0, "iterations": 0, "engine": "aspect"}
    if fast is True:
        result["valid"] = True
        return result
    valid, info = fast
    result["valid"] = valid
    result.update({k: v for k, v in info.items() if k != "op_index"})
    i = info.get("op_index")
    if i is not None and e.ops is not None:
        inv, comp = e.ops[i]
        result["op"] = dict(comp if comp is not None else inv)
    if confirm:
        from . import wgl
        oracle = wgl.check_encoded(spec, e, init_state)
        result["confirmed"] = oracle["valid"] is valid
        result["valid"] = oracle["valid"]
    return result


def _apply_prune(spec, e, inv32, ret32):
    """Apply the model's validity-preserving candidate prune (if any):
    dropped rows get the padding-row treatment."""
    if spec.prune is None:
        return inv32, ret32
    keep = spec.prune(e, inv32, ret32)
    if keep is None:
        return inv32, ret32
    keep = np.asarray(keep, bool)
    assert not np.any(~keep & np.asarray(e.is_ok, bool)), \
        "prune must never drop ok ops"
    return (np.where(keep, inv32, INF32 - 1).astype(np.int32),
            np.where(keep, ret32, INF32).astype(np.int32))


def _priority_order(spec, e, inv32, ret32):
    """Renumber ops into linearization-priority order (model hint, else
    earliest deadline). Returns (perm, inv32, ret32, fop, args, rets,
    ok_words), all permuted; witnesses decode back through perm."""
    n = len(e)
    pri = (np.asarray(spec.hint(e, inv32, ret32), np.int64)
           if spec.hint is not None else ret32.astype(np.int64))
    perm = np.argsort(pri, kind="stable").astype(np.int64)
    inv_s = inv32[perm]
    ret_s = ret32[perm]
    fop = np.asarray(e.f, np.int32)[perm]
    args = np.asarray(e.args, np.int32).reshape(n, -1)[perm]
    rets = np.asarray(e.ret, np.int32).reshape(n, -1)[perm]
    ok_s = np.asarray(e.is_ok, bool)[perm]
    ok_words = np.zeros(max(1, (n + 31) // 32), np.uint32)
    for i in np.flatnonzero(ok_s):
        ok_words[i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return perm, inv_s, ret_s, fop, args, rets, ok_words


def _prepare_search(spec, e, init_state, confirm=False):
    """Host-side preparation for a single-key search: empty/fast paths,
    prune, priority order, padding to power-of-two buckets. Returns
    ``("fast", result)`` or ``("search", (perm, inv32, ret32, fop, args,
    rets, ok_words, init_state, n_pad, C, A, S))``."""
    n = len(e)
    if n == 0 or e.n_ok == 0:
        return ("fast", {"valid": True, "configs_explored": 0})

    inv32, ret32, _ = _encode_arrays(e)
    if spec.fast_check is not None:
        fast = spec.fast_check(e, inv32, ret32)
        if fast is not None:
            return ("fast", _fast_result(spec, e, init_state, fast,
                                         confirm))
    if spec.pad_state is None:   # fixed small state spaces only
        fast = _state_abstraction_check(spec, e, init_state)
        if fast is not None:
            return ("fast", _fast_result(spec, e, init_state, fast,
                                         confirm))
    inv32, ret32 = _apply_prune(spec, e, inv32, ret32)
    C = max_point_concurrency(
        inv32,
        np.where(ret32 == INF32, INF_TIME, ret32.astype(np.int64)))
    A = int(e.args.shape[1]) if e.args.ndim == 2 else 1
    perm, inv32, ret32, fop, args, rets, ok_words = _priority_order(
        spec, e, inv32, ret32)

    # padding rows are never candidates while an ok op is outstanding:
    # they "invoke" after every finite return and are not ok ops
    n_pad = _bucket(n, _n_floor())
    C = min(_bucket(C, 4), n_pad)
    if n_pad > n:
        pn = n_pad - n
        inv32 = np.concatenate([inv32, np.full(pn, INF32 - 1, np.int32)])
        ret32 = np.concatenate([ret32, np.full(pn, INF32, np.int32)])
        fop = np.concatenate([fop, np.zeros(pn, np.int32)])
        args = np.concatenate([args, np.zeros((pn, A), np.int32)])
        rets = np.concatenate([rets, np.zeros((pn, A), np.int32)])
        extra = (n_pad + 31) // 32 - len(ok_words)
        ok_words = np.concatenate([ok_words, np.zeros(extra, np.uint32)])

    init_state = np.asarray(init_state, np.int32)
    if spec.pad_state is not None:
        S_pad = _bucket(init_state.shape[0], 2)
        init_state = np.asarray(spec.pad_state(init_state, S_pad), np.int32)
    S = int(init_state.shape[0])
    return ("search", (perm, inv32, ret32, fop, args, rets, ok_words,
                       init_state, n_pad, C, A, S))


# ---------------------------------------------------------------------------
# the device search

def _last_lane(idx, lane, size):
    """Per target index, the largest lane writing it (-1 where none): the
    winner of a scatter with duplicate indices under XLA's serial
    order. ``idx`` in [0, size)."""
    won = torch.full((size,), -1, dtype=torch.int64, device=idx.device)
    return won.scatter_reduce_(0, idx, lane, reduce="amax")


def _winning_index(idx, lane, drop):
    """Scatter targets ``idx`` (in [0, drop]) with every lane but the
    last one per target sent to the sentinel ``drop``: ``dst[idx] =
    src`` then lands as XLA's serial scatter would, whatever order the
    device writes in."""
    won = _last_lane(idx, lane, drop + 1)
    return torch.where(won[idx] == lane, idx, drop)


@functools.lru_cache(maxsize=32)
def _build_search(step_fn, K, n, B, S, C, A, W, O, T, R=None, NS=None,
                  rollout_kernel="auto", device="cuda"):
    """Build the search for one shape bundle. Returns

        init_carry(init_states (K,S) int32) -> carry
        body(carry, consts) -> carry          (one search iteration)
        run_chunk(carry, consts, bound) -> carry

    ``consts`` is ``(invoke (K,n), ret (K,n), fop (K,n), args (K,n,A),
    rets (K,n,A), ok_words (K,B))`` int32 tensors plus ``salt (K,)`` and
    ``n_ok (K,)`` int64, on ``device``; ops in priority order.

    Carry (the JAX package's v6 layout, same order and meaning; see
    ``carry_to_numpy``): buf_lin (K*O+1, B) int32, buf_state (K*O+1, S)
    int32, buf_fp (K*O+1, 2) int64, top (K,) int64, tab (G, T+1, 2)
    int64, dropped (K,) bool, status (K,) int32, explored (K,) int64,
    best_depth (K, TOPK) int64, best_lin (K, TOPK, B) int32, best_state
    (K, TOPK, S) int32, its (K,) int64, it (G,) int64, claim (G, TC)
    int64, tfail (G,) int64."""
    if rollout_kernel not in ("auto", "scan", "kernel"):
        raise ValueError(f"rollout_kernel must be 'auto', 'scan' or "
                         f"'kernel', not {rollout_kernel!r}")
    dev = torch.device(device)
    G = 1          # table groups: one per device shard of a mesh search
    M = W * C
    KM = K * M
    if R is None:
        # greedy chain length per iteration: deep chains for single-key
        # searches, none for trivially short histories (jax_wgl.py:219)
        R = 0 if n <= 64 else min(1024 if K == 1 else 256, n)
    if NS is None:
        NS = max(1, min(8, (64 << 20) // max(1, n * S))) if K == 1 else 1
    if R and K * NS * n * S > (256 << 20):
        R, NS = 0, 1

    # the hand-written rollout: single-key searches whose model and
    # shape pass the gate. "auto" takes it on CUDA; "kernel" insists
    # (on a CPU tensor its wrapper runs the plain version, as the tests
    # want); "scan" keeps the scan path.
    use_kernel = False
    if K == 1 and R and rollout_kernel != "scan":
        ok = rollout.gate(step_fn, NS, R, n, B, S, A) is not None
        if rollout_kernel == "kernel" and not ok:
            raise ValueError(
                f"rollout_kernel='kernel' but the rollout gate refuses "
                f"this model or shape (NS={NS}, R={R}, n={n}, S={S})")
        use_kernel = ok and (rollout_kernel == "kernel"
                             or dev.type == "cuda")
    ML = M + NS * R if R else M
    KML = K * ML
    keys = words.Keys(B, S, dev)

    def i64(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    arange_n = torch.arange(n, dtype=torch.int64, device=dev)
    arange_W = torch.arange(W, dtype=torch.int64, device=dev)
    arange_C = torch.arange(C, dtype=torch.int64, device=dev)
    arange_K = torch.arange(K, dtype=torch.int64, device=dev)
    arange_P = torch.arange(PROBES, dtype=torch.int64, device=dev)
    lane = torch.arange(KML, dtype=torch.int64, device=dev)
    # DFS rank of expansion lanes: parents ascending, candidates in
    # descending priority (jax_wgl.py:483-484)
    dfs_rank = (arange_W[:, None] * C
                + (C - 1 - arange_C)[None, :]).reshape(M)
    inf32 = torch.tensor(int(INF32), dtype=torch.int32, device=dev)
    running_c = torch.tensor(int(RUNNING), dtype=torch.int32, device=dev)
    valid_c = torch.tensor(int(VALID), dtype=torch.int32, device=dev)

    def step_planes(state, f, a, r):
        """Model step batched component first: state (..., S) against
        op columns f (...), a/r (..., A) broadcastable to one shape L.
        Returns (state' (L..., S) int32, ok (L...))."""
        st2, ok = step_fn(state.movedim(-1, 0), f, a.movedim(-1, 0),
                          r.movedim(-1, 0), TORCH)
        shape = torch.broadcast_shapes(st2.shape[1:], ok.shape)
        st2 = torch.broadcast_to(st2, (st2.shape[0],) + shape)
        return (st2.movedim(0, -1).to(torch.int32),
                torch.broadcast_to(ok, shape))

    def depth_of(lin, okw):
        """Linearized ok ops of bitsets lin (..., B) against okw (B,)."""
        return words.popcount32(u32(lin & okw)).sum(-1)

    def first_true(mask, dim):
        """Index of the first True along dim (0 for an all-False row,
        as jnp.argmax gives)."""
        return torch.argmax(mask.to(torch.uint8), dim=dim)

    def topk_insert(bd3, bl3, bs3, cd, cl, cs):
        """Insert one candidate config per key (cd (K,), cl (K,B), cs
        (K,S)) into the TOPK distinct-deepest slots
        (jax_wgl.py:421-439)."""
        dup = ((bl3 == cl[:, None, :]).all(-1)
               & (bs3 == cs[:, None, :]).all(-1)
               & (bd3 >= 0)).any(dim=1)
        mind = bd3.amin(dim=1)
        do = (cd >= 0) & (cd >= mind) & ~dup
        sloteq = bd3 == mind[:, None]
        spk = sloteq & (sloteq.cumsum(dim=1) == 1) & do[:, None]
        return (torch.where(spk, cd[:, None], bd3),
                torch.where(spk[..., None], cl[:, None, :], bl3),
                torch.where(spk[..., None], cs[:, None, :], bs3))

    def roll_step(lin_r, st_r, alive, invoke, ret, fop, args, rets):
        """One step of the scan rollout over (K, NS) chains
        (jax_wgl.py:515-547); the fingerprint sums follow after the loop
        (``chain_sums``). Returns (lin, st, alive, j)."""
        unl = words.unpack_unlin(lin_r, n)                   # (K,NS,n)
        rm = torch.where(unl, ret[:, None, :], inf32).amin(dim=2)
        elig = unl & (invoke[:, None, :] < rm[..., None])
        stn, okn = step_planes(st_r[:, :, None, :], fop[:, None, :],
                               args[:, None, :, :], rets[:, None, :, :])
        succ = elig & okn & alive[..., None]
        j = first_true(succ, 2)                              # (K,NS)
        took = succ.any(dim=2)
        wsel = j[..., None] // 32
        oldw = lin_r.gather(2, wsel)
        neww = torch.where(took[..., None], oldw | words.bit_mask(
            j[..., None]), oldw)
        picked = stn.gather(2, j[:, :, None, None].expand(K, NS, 1, S))
        newst = torch.where(took[..., None], picked[:, :, 0], st_r)
        return (lin_r.scatter(2, wsel, neww), newst, alive & took,
                torch.where(took, j, -1))

    def chain_sums(prev_lin, j, seed_s1, seed_s2):
        """Incremental fingerprint lin-sums along chains: ``prev_lin``
        (..., R, B) the uint32 bitsets before each step, ``j`` (..., R)
        the op taken (-1 once dead). Each taken step flips one word, so
        its delta is one ``lin_deltas`` and the sums are cumsums."""
        took = j >= 0
        jc = j.clamp(min=0).to(torch.int64)
        wsel = jc // 32
        bit = u32(words.bit_mask(jc))
        oldw = prev_lin.gather(-1, wsel[..., None])[..., 0]
        d1, d2 = keys.lin_deltas(oldw, oldw | bit, wsel)
        zero = torch.zeros_like(d1)
        return ((seed_s1[..., None]
                 + torch.where(took, d1, zero).cumsum(dim=-1)) & M32,
                (seed_s2[..., None]
                 + torch.where(took, d2, zero).cumsum(dim=-1)) & M32)

    def kernel_chains(seed_lin, seed_st, seed_ok, invoke, ret, fop, args,
                      rets):
        """Roll the K=1 chains in the kernel and rebuild the per-step
        bitsets from (j, st) (jax_wgl.py:549-591). Returns (lin
        (1,NS,R,B) int32, prev_lin (1,NS,R,B) uint32 in int64, st, j)."""
        j, st = rollout.run(step_fn, seed_lin[0], seed_st[0], seed_ok[0],
                            invoke[0], ret[0], fop[0], args[0], rets[0],
                            R)
        ch_lin, prev = rollout.chain_bitsets(seed_lin[0], j)
        return words.to_i32(ch_lin)[None], prev[None], st[None], j[None]

    def body(carry, consts):
        (buf_lin, buf_state, buf_fp, top, tab, dropped, status,
         explored, best_depth, best_lin, best_state, its, it,
         claim, tfail) = carry
        invoke, ret, fop, args, rets, ok_words, salt, n_ok = consts
        running = (status == running_c) & (top > 0)           # (K,)

        # -- pop per-key frontiers from the ring stack ---------------------
        start = torch.where(running, (top - W).clamp(min=0), top)
        idx = start[:, None] + arange_W[None, :]              # (K,W)
        fvalid = (idx < top[:, None]) & running[:, None]
        gidx = (arange_K[:, None] * O + idx % O).reshape(K * W)
        lin = buf_lin[gidx].reshape(K, W, B)
        state = buf_state[gidx].reshape(K, W, S)
        fsum = buf_fp[gidx].reshape(K, W, 2)
        top = start

        # -- candidate selection (the WGL rule) ----------------------------
        unlin = words.unpack_unlin(lin, n)                    # (K,W,n)
        rmin = torch.where(unlin, ret[:, None, :], inf32).amin(dim=2)
        cand = unlin & (invoke[:, None, :] < rmin[..., None]) \
            & fvalid[..., None]
        rank = cand.to(torch.int64).cumsum(dim=2)             # (K,W,n)
        if n * C <= 32768:
            onehot = (rank[..., None] == (arange_C + 1)) & cand[..., None]
            ci = (onehot * arange_n[None, None, :, None]).sum(dim=2)
        else:
            # column C is the sentinel the dropped candidates land on
            tgt = torch.where(cand & (rank <= C), rank - 1, C)
            ci = torch.zeros((K * W, C + 1), dtype=torch.int64,
                             device=dev)
            ci.scatter_(1, tgt.reshape(K * W, n),
                        arange_n.expand(K * W, n))
            ci = ci[:, :C].reshape(K, W, C)
        cvalid = arange_C[None, None, :] < rank[..., -1:]     # (K,W,C)

        # -- model step over (key, frontier, candidate) --------------------
        gci = (arange_K[:, None, None] * n + ci).reshape(KM)
        fc = fop.reshape(K * n)[gci].reshape(K, W, C)
        ac = args.reshape(K * n, A)[gci].reshape(K, W, C, A)
        rc = rets.reshape(K * n, A)[gci].reshape(K, W, C, A)
        st2, okf = step_planes(state[:, :, None, :], fc, ac, rc)

        wselc = ci // 32
        bitc = words.bit_mask(ci)
        oldw = lin.gather(2, wselc)                           # (K,W,C)
        lin2 = lin[:, :, None, :].expand(K, W, C, B).contiguous()
        lin2.scatter_(3, wselc[..., None], (oldw | bitc)[..., None])
        # incremental fingerprint sums: each child flips one word
        d1, d2 = keys.lin_deltas(u32(oldw), u32(oldw | bitc), wselc)
        sum1c = (fsum[..., 0][:, :, None] + d1) & M32
        sum2c = (fsum[..., 1][:, :, None] + d2) & M32

        child_valid = cvalid & okf & fvalid[..., None]
        # a valid child adds the unlinearized op ci to its parent, so its
        # linearized-ok count is the parent's plus ci's ok bit (the same
        # number as popcount(lin2 & okw), without the (K,W,C,B) pass)
        okw = ok_words[:, None, :]
        okbit = (ok_words.gather(1, wselc.reshape(K, -1)).reshape(K, W, C)
                 >> (ci % 32).to(torch.int32)) & 1
        depth_c = depth_of(lin, okw)[..., None] + okbit
        done = depth_c == n_ok[:, None, None]
        status = torch.where(
            running & (child_valid & done).any(dim=2).any(dim=1),
            valid_c, status)

        # -- witness tracking ----------------------------------------------
        depth = torch.where(child_valid, depth_c, -1).reshape(K, M)
        bd = depth.amax(dim=1)                                # (K,)
        lin2k = lin2.reshape(K, M, B)
        st2k = st2.reshape(K, M, S)
        pick = first_true(depth == bd[:, None], 1)
        best_depth, best_lin, best_state = topk_insert(
            best_depth, best_lin, best_state, bd,
            lin2k[arange_K, pick], st2k[arange_K, pick])

        # -- greedy rollout ------------------------------------------------
        sum1k = sum1c.reshape(K, M)
        sum2k = sum2c.reshape(K, M)
        if R:
            # seeds: the top-NS valid children in DFS order (distinct
            # ranks, so topk's order is the reference's NS masked-max
            # picks); a missing seed is dead and all zero
            score = torch.where(child_valid.reshape(K, M), dfs_rank[None],
                                -1)
            sval, sidx = score.topk(NS, dim=1)                # (K,NS)
            seed_ok = running[:, None] & (sval >= 0)
            rows = arange_K[:, None]
            seed_lin = torch.where(seed_ok[..., None], lin2k[rows, sidx], 0)
            seed_st = torch.where(seed_ok[..., None], st2k[rows, sidx], 0)
            seed_s1 = torch.where(seed_ok, sum1k.gather(1, sidx), 0)
            seed_s2 = torch.where(seed_ok, sum2k.gather(1, sidx), 0)
            if use_kernel:
                ch_lin, prev, ch_st, ch_j = kernel_chains(
                    seed_lin, seed_st, seed_ok, invoke, ret, fop, args,
                    rets)
            else:
                c = (seed_lin, seed_st, seed_ok)
                steps = []
                for _ in range(R):
                    *c, j = roll_step(*c, invoke, ret, fop, args, rets)
                    steps.append((c[0], c[1], j))
                ch_lin, ch_st, ch_j = (torch.stack(xs, dim=2)
                                       for xs in zip(*steps))
                prev = u32(torch.cat([seed_lin[:, :, None],
                                      ch_lin[:, :, :-1]], dim=2))
            ch_s1, ch_s2 = chain_sums(prev, ch_j, seed_s1, seed_s2)
            # flip the seed axis so the BEST seed's chain flattens to the
            # LAST lanes (top of stack), then fold seeds into one axis
            ch_lin, ch_st, ch_alive, ch_s1, ch_s2 = (
                x.flip(1).reshape((K, NS * R) + x.shape[3:])
                for x in (ch_lin, ch_st, ch_j >= 0, ch_s1, ch_s2))

            ch_depth = torch.where(ch_alive, depth_of(ch_lin, okw), -1)
            ch_done = (ch_depth == n_ok[:, None]) & ch_alive
            status = torch.where(running & ch_done.any(dim=1), valid_c,
                                 status)
            cbd = ch_depth.amax(dim=1)
            cpick = first_true(ch_depth == cbd[:, None], 1)
            best_depth, best_lin, best_state = topk_insert(
                best_depth, best_lin, best_state, cbd,
                ch_lin[arange_K, cpick], ch_st[arange_K, cpick])

            all_lin = torch.cat([lin2k, ch_lin], dim=1)
            all_st = torch.cat([st2k, ch_st], dim=1)
            all_val = torch.cat([child_valid.reshape(K, M), ch_alive],
                                dim=1)
            all_s1 = torch.cat([sum1k, ch_s1], dim=1)
            all_s2 = torch.cat([sum2k, ch_s2], dim=1)
        else:
            all_lin, all_st = lin2k, st2k
            all_val = child_valid.reshape(K, M)
            all_s1, all_s2 = sum1k, sum2k

        # -- fingerprints (key-salted) --------------------------------------
        lin2f = all_lin.reshape(KML, B)
        st2f = all_st.reshape(KML, S)
        sum1f = all_s1.reshape(KML)
        sum2f = all_s2.reshape(KML)
        saltw = salt[:, None].expand(K, ML).reshape(KML)
        h1, h2 = keys.finalize_fp(sum1f, sum2f, st2f, saltw)
        cv = all_val.reshape(KML)

        # -- in-batch twin dedup: of the lanes with equal fingerprints at a
        # claimed slot, exactly the scatter winner survives
        cslot = torch.where(cv, h1 & (TC - 1), TC)
        won = _last_lane(cslot, lane, TC + 1)
        claim = torch.where(won[None, :TC] >= 0, won[None, :TC], claim)
        winner = torch.where(cv, won[cslot], 0)
        dup = cv & (winner != lane) & (h1[winner] == h1) \
            & (h2[winner] == h2)

        # -- one vectorized probe round against the seen-table -------------
        live = cv & ~dup
        tab0 = tab[0]
        slots = ((h1 & (T - 1))[:, None] + arange_P[None, :]) & (T - 1)
        slots = torch.where(live[:, None], slots, T)
        cur = tab0[slots]                                     # (KML,P,2)
        cur1, cur2 = cur[..., 0], cur[..., 1]
        seen = ((cur1 == h1[:, None]) & (cur2 == h2[:, None])).any(dim=1) \
            & live
        empty = (cur1 == 0) & (cur2 == 0)
        islot = slots.gather(1, first_true(empty, 1)[:, None])[:, 0]
        has_empty = empty.any(dim=1)
        want = live & ~seen & has_empty
        tab0.index_put_((_winning_index(torch.where(want, islot, T), lane,
                                        T),), torch.stack([h1, h2], dim=-1))
        tab0[T] = 0                   # the sentinel reads as fill 0
        tfail = tfail + (live & ~seen & ~has_empty).sum()

        # -- push fresh configs (per-key positions, one flat scatter) -------
        fresh = (live & ~seen).reshape(K, ML)
        fe = fresh[:, :M].reshape(K, W, C).to(torch.int64)
        row_tot = fe.sum(dim=2)                               # (K,W)
        rows_before = row_tot.cumsum(dim=1) - row_tot
        suffix_in_row = row_tot[:, :, None] - fe.cumsum(dim=2)
        offs = (rows_before[:, :, None] + suffix_in_row).reshape(K, M)
        cnt = row_tot.sum(dim=1)                              # (K,)
        if R:
            fc_ = fresh[:, M:].to(torch.int64)
            offs = torch.cat([offs, cnt[:, None] + fc_.cumsum(dim=1) - 1],
                             dim=1)
            cnt = cnt + fc_.sum(dim=1)
        pos = top[:, None] + offs
        dropped = dropped | (running & (top + cnt > O))
        fpos = _winning_index(torch.where(
            fresh, arange_K[:, None] * O + pos % O, K * O).reshape(KML),
            lane, K * O)
        buf_lin.index_put_((fpos,), lin2f)
        buf_state.index_put_((fpos,), st2f)
        buf_fp.index_put_((fpos,), torch.stack([sum1f, sum2f], dim=-1))
        # renormalize the absolute counter (slot indices are mod O)
        top = top + cnt
        top = torch.where(top >= 2 * O, top - O, top)

        explored = explored + torch.where(running, fvalid.sum(dim=1), 0)
        its = its + running.to(torch.int64)
        it = it + 1
        return (buf_lin, buf_state, buf_fp, top, tab, dropped, status,
                explored, best_depth, best_lin, best_state, its, it,
                claim, tfail)

    def init_carry(init_states):
        init_states = torch.as_tensor(init_states, dtype=torch.int32,
                                      device=dev).reshape(K, S)
        buf_lin = torch.zeros((K * O + 1, B), dtype=torch.int32,
                              device=dev)
        buf_state = torch.zeros((K * O + 1, S), dtype=torch.int32,
                                device=dev)
        buf_state[arange_K * O] = init_states
        # every slot starts with the all-zero bitset's lin-sums
        z1, z2 = keys.empty_lin_sums()
        buf_fp = torch.stack([z1, z2]).expand(K * O + 1, 2).contiguous()
        return (buf_lin, buf_state, buf_fp, i64(np.ones(K)),
                torch.zeros((G, T + 1, 2), dtype=torch.int64, device=dev),
                torch.zeros(K, dtype=torch.bool, device=dev),
                torch.full((K,), int(RUNNING), dtype=torch.int32,
                           device=dev),
                i64(np.zeros(K)), i64(np.full((K, TOPK), -1)),
                torch.zeros((K, TOPK, B), dtype=torch.int32, device=dev),
                torch.zeros((K, TOPK, S), dtype=torch.int32, device=dev),
                i64(np.zeros(K)), i64(np.zeros(G)),
                i64(np.zeros((G, TC))), i64(np.zeros(G)))

    def run_chunk(carry, consts, bound):
        """Advance the search until every key succeeds/exhausts or the
        iteration counter reaches ``bound``. The status is read between
        iterations (one host sync each); ``body`` is a no-op for keys no
        longer running, so the reading cadence changes no result."""
        it = int(carry[IDX_IT][0])
        while it < bound:
            if not bool(((carry[IDX_STATUS] == running_c)
                         & (carry[IDX_TOP] > 0)).any()):
                break
            carry = body(carry, consts)
            it += 1
        return carry

    # whether a chunk launches the rollout kernel (obs arms its compile
    # phase on the first dispatch that builds or loads the library)
    run_chunk.uses_kernel = use_kernel
    return init_carry, body, run_chunk


# ---------------------------------------------------------------------------
# carries across packages

#: numpy dtypes of the JAX package's carry, by index
_NP_DTYPES = (np.uint32, np.int32, np.uint32, np.int32, np.uint32, bool,
              np.int32, np.int32, np.int32, np.uint32, np.int32, np.int32,
              np.int32, np.int32, np.int32)


def carry_to_numpy(carry):
    """The port's carry as the JAX package's carry, as numpy arrays in the
    v6 layout (what ``jax.device_get(carry)`` gives there): the sentinel
    rows dropped, the stack reshaped to (K, O, ...), every word in its
    JAX dtype."""
    K = carry[IDX_TOP].shape[0]
    out = []
    for i, x in enumerate(carry):
        x = x.detach().cpu()
        if i in (IDX_BUF_LIN, IDX_BUF_STATE, IDX_BUF_FP):
            x = x[:-1].reshape((K, -1) + tuple(x.shape[1:]))
        elif i == IDX_TAB:
            x = x[:, :-1]
        x = x.numpy()
        dt = _NP_DTYPES[i]
        if dt is np.uint32 and x.dtype == np.int32:
            x = x.view(np.uint32)
        out.append(x.astype(dt))
    return out


def carry_from_numpy(arrays, device):
    """The JAX package's carry (numpy arrays in the v6 layout, e.g. the
    ``c0..c14`` of a checkpoint) as the port's carry on ``device``."""
    dev = resolve_device(device)
    out = []
    for i, x in enumerate(arrays):
        x = np.asarray(x)
        if i in (IDX_BUF_LIN, IDX_BUF_STATE, IDX_BUF_FP):
            x = x.reshape((-1,) + x.shape[2:])
            x = np.concatenate([x, np.zeros((1,) + x.shape[1:], x.dtype)])
        elif i == IDX_TAB:
            x = np.concatenate(
                [x, np.zeros((x.shape[0], 1, 2), x.dtype)], axis=1)
        if i in (IDX_BUF_LIN, IDX_BEST_LIN):
            t = torch.from_numpy(
                np.ascontiguousarray(x.astype(np.uint32).view(np.int32)))
        elif i in (IDX_BUF_STATE, IDX_STATUS, IDX_BEST_STATE):
            t = torch.from_numpy(np.ascontiguousarray(x.astype(np.int32)))
        elif i == IDX_DROPPED:
            t = torch.from_numpy(np.ascontiguousarray(x.astype(bool)))
        else:
            t = torch.from_numpy(np.ascontiguousarray(
                x.astype(np.uint32 if _NP_DTYPES[i] is np.uint32
                         else np.int32).astype(np.int64)))
        out.append(t.to(dev))
    return tuple(out)


def make_batch_consts(cols, salts, device):
    """The search's constant op columns for K keys, on ``device``:
    ``cols`` holds each key's ``(invoke, ret, fop, args, rets,
    ok_words)`` (ok_words uint32), ``salts`` each key's uint32 salt
    (k+1 for a live key, 0 for a dummy one). Returns the six columns
    stacked as int32 (K, ...) tensors, the salts as the int64 ``salt``
    (K,) and each key's ok-op count as the int64 ``n_ok`` (K,)."""
    def t(i):
        x = np.stack([np.asarray(c[i]) for c in cols])
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32,
                               device=device)
    n_ok = [int(np.unpackbits(np.asarray(c[5], np.uint32).view(np.uint8))
                .sum()) for c in cols]
    return tuple(t(i) for i in range(6)) + (
        torch.as_tensor(np.asarray(salts, np.uint32).astype(np.int64),
                        device=device),
        torch.as_tensor(n_ok, dtype=torch.int64, device=device))


def make_consts(inv32, ret32, fop, args, rets, ok_words, device):
    """The search's constant op columns for one key (salt 0), on
    ``device``."""
    return make_batch_consts(
        [(inv32, ret32, fop, args, rets, np.asarray(ok_words, np.uint32))],
        [0], device)


def compact(carry, consts, sel):
    """Keep the key rows ``sel`` (an int64 tensor of row indices, rows
    may repeat) of a K-key carry and its consts, in that order: the
    counterpart of ``jnp.take(c, sel, axis=0)`` on every KEYED carry
    array and every const (``keyshard.py:487-489``). The stack buffers
    are stored flat as ``(K*O+1, ...)`` with a sentinel row, so each one
    drops its sentinel, is viewed as ``(K, O, ...)``, keeps rows ``sel``
    and gets a zero sentinel back. The shared arrays stay as they are."""
    K = carry[IDX_TOP].shape[0]
    out = []
    for i, x in enumerate(carry):
        if i in (IDX_BUF_LIN, IDX_BUF_STATE, IDX_BUF_FP):
            rows = x[:-1].reshape((K, -1) + tuple(x.shape[1:]))
            rows = rows.index_select(0, sel).reshape((-1,)
                                                     + tuple(x.shape[1:]))
            x = torch.cat([rows, torch.zeros_like(x[-1:])])
        elif i in KEYED:
            x = x.index_select(0, sel)
        out.append(x)
    return tuple(out), tuple(c.index_select(0, sel) for c in consts)


# ---------------------------------------------------------------------------
# public entry points

def table_stats(carry):
    """Dedup-table occupancy diagnostics: load factor from one reduction
    over the table plus the accumulated insert-failure count."""
    tab = carry[IDX_TAB][:, :-1]
    used = int((tab != 0).any(dim=-1).sum())
    fails = int(carry[IDX_TFAIL].sum())
    total = int(tab.shape[0] * tab.shape[1])
    return {"table_load": round(used / total, 4),
            "table_insert_failures": fails}


def check_encoded(spec, e, init_state, max_configs=50_000_000,
                  frontier_width=None, stack_size=None, table_size=None,
                  confirm=False, timeout_s=None, chunk_iters=256,
                  checkpoint=None, checkpoint_every_s=60.0, cancel=None,
                  rollout_seeds=None, rollout_kernel="auto",
                  rollout_depth=None, device=None):
    """Device WGL search over an EncodedHistory. The result dict mirrors
    ``jax_wgl.check_encoded``: {"valid": True|False|"unknown",
    "configs_explored", "iterations", "engine", table diagnostics, and a
    witness}. ``device=None`` means CUDA (raising without a card);
    ``rollout_kernel`` is "auto" (the CUDA kernel on CUDA when its gate
    passes), "kernel" (insist) or "scan".

    ``checkpoint`` names a file the search carry is snapshotted to every
    ``checkpoint_every_s`` (between chunks), on a timeout or cancel, and
    when the search ends undecided; a rerun with the same arguments
    resumes from it, and a decided run deletes it. The snapshot is the
    JAX package's: the carry in its v6 layout (``carry_to_numpy``) under
    a fingerprint hashed over the same host arrays as ``jax_wgl``'s, so a
    snapshot written by either engine resumes in the other. A file
    holding another check's snapshot is left alone."""
    # phase cursor (obs.phases): this search's wall by phase; a pair of
    # clock reads per lap when obs is unbound
    ph = obs_phases.capture("jax-wgl")
    dev = resolve_device(device)
    prep = _prepare_search(spec, e, init_state, confirm)
    if prep[0] == "fast":
        return prep[1]
    (perm, inv32, ret32, fop, args, rets, ok_words, init_state, n_pad,
     C, A, S) = prep[1]
    ph.lap("encode")
    B, W, O, T = _plan_sizes(n_pad, S, C, frontier_width, stack_size,
                             table_size)
    max_iters = max(1, max_configs // W)
    init_carry, _, run_chunk = _build_search(
        spec.step, 1, n_pad, B, S, C, A, W, O, T, R=rollout_depth,
        NS=rollout_seeds, rollout_kernel=rollout_kernel, device=str(dev))
    # the first dispatch that builds or loads the kernel's library is
    # the build's wall, not the search's
    ph.note_compile(dev.type == "cuda" and run_chunk.uses_kernel
                    and not _build.loaded("rollout"))
    ph.lap("plan")
    consts = make_consts(inv32, ret32, fop, args, rets, ok_words, dev)
    carry = init_carry(init_state[None])
    ph.sync(carry)
    ph.lap("h2d")
    fingerprint = None
    if checkpoint is not None:
        fingerprint = search_fingerprint(
            spec, (inv32, ret32, fop, args, rets, ok_words, init_state),
            (n_pad, B, S, C, W, O, T))
        resumed = read_snapshot(checkpoint, fingerprint)
        if resumed is not None:
            carry = carry_from_numpy(
                [resumed[f"c{i}"] for i in range(N_CARRY)], dev)
        elif not _checkpoint_owned(checkpoint, fingerprint):
            # another check's live snapshot: never touch it
            logger.warning("checkpoint %s belongs to a different check; "
                           "checkpointing disabled for this run",
                           checkpoint)
            checkpoint = None
    t0 = time.monotonic()
    last_ckpt = t0
    timed_out = False
    # sinks captured ONCE at search start: a competition straggler must
    # not write into a later run's artifacts
    so = obs_search.capture()
    so.plan("jax-wgl", n_pad, len(e), n_pad)
    it = int(carry[IDX_IT][0])
    eff = min(chunk_iters, 32, max(1, (32 * 16384) // n_pad))
    while True:
        prev_it = it
        t_chunk = time.monotonic()
        ph.lap("host")
        carry = run_chunk(carry, consts, min(it + eff, max_iters))
        # the device bracket's synchronize exists only while phase
        # attribution is on; the status read below is the chunk's sync
        ph.sync(carry)
        dev_s = ph.lap("device", iteration=it)
        if so.enabled():
            # the heartbeat's explored and witness depths ride the same
            # single read, at the same two launches (cast and cat)
            got = torch.cat(
                [carry[IDX_STATUS][:1].to(torch.int64), carry[IDX_TOP][:1],
                 carry[IDX_IT][:1], carry[IDX_EXPLORED][:1],
                 carry[IDX_BEST_DEPTH][0]]).tolist()
            status, top, it, explored = got[:4]
            depth = max(0, max(got[4:]))
        else:
            status, top, it = (int(x) for x in torch.stack(
                [carry[IDX_STATUS][0].to(torch.int64), carry[IDX_TOP][0],
                 carry[IDX_IT][0]]).tolist())
            explored = depth = None
        ph.lap("d2h")
        so.heartbeat("jax-wgl", iteration=it,
                     chunk_s=time.monotonic() - t_chunk,
                     device_s=dev_s if ph.enabled else None,
                     frontier=top, explored=explored, depth=depth)
        if status != RUNNING or top == 0 or it >= max_iters:
            break
        now = time.monotonic()
        per_it = max(1e-4, (now - t_chunk) / max(1, it - prev_it))
        eff = _adapt_quantum(
            chunk_iters, per_it, 3.0,
            timeout_s - (now - t0) if timeout_s is not None else None)
        if checkpoint is not None and \
                now - last_ckpt >= checkpoint_every_s:
            save_carry(checkpoint, fingerprint, carry)
            last_ckpt = now
        if (timeout_s is not None and now - t0 > timeout_s) or \
                (cancel is not None and cancel.is_set()):
            timed_out = True
            if checkpoint is not None:
                save_carry(checkpoint, fingerprint, carry)
            break

    ph.lap("host")
    out = {"status": carry[IDX_STATUS][0], "top": carry[IDX_TOP][0],
           "dropped": carry[IDX_DROPPED][0],
           "explored": carry[IDX_EXPLORED][0],
           "iterations": carry[IDX_ITS][0],
           "best_depth": carry[IDX_BEST_DEPTH][0],
           "best_lin": carry[IDX_BEST_LIN][0],
           "best_state": carry[IDX_BEST_STATE][0]}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["best_lin"] = out["best_lin"].view(np.uint32)
    tstats = table_stats(carry)
    ph.lap("d2h")
    if timed_out and int(out["status"]) == RUNNING and int(out["top"]) > 0:
        result = {"valid": "unknown", "error": "timeout",
                  "configs_explored": int(out["explored"]),
                  "iterations": int(out["iterations"]),
                  "engine": "jax-wgl", **tstats,
                  **({"checkpoint": checkpoint} if checkpoint else {})}
        so.summary("jax-wgl", result)
        ph.lap("host")
        return result
    result = _interpret(spec, e, out, max_iters, confirm, init_state,
                        perm)
    result.update(tstats)
    so.summary("jax-wgl", result)
    ph.lap("host")
    # never clobber a snapshot that belongs to a different check
    if checkpoint is not None and _checkpoint_owned(checkpoint,
                                                    fingerprint):
        if result.get("valid") in (True, False):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(checkpoint)       # decided: the snapshot is spent
        else:
            # undecided (budget/overflow): a rerun with a larger budget
            # resumes instead of restarting
            save_carry(checkpoint, fingerprint, carry)
            result["checkpoint"] = checkpoint
    return result


# ---------------------------------------------------------------------------
# checkpoints: the JAX package's snapshot format

def search_fingerprint(spec, cols, sizes):
    """sha256 over the carry layout, the model name, the padded host
    columns ``(invoke, ret, fop, args, rets, ok_words, init_state)`` in
    the dtypes ``_prepare_search`` gives them (int32 and uint32, as the
    JAX package's) and the plan sizes ``(n_pad, B, S, C, W, O, T)``:
    ``jax_wgl.check_encoded``'s fingerprint, byte for byte."""
    h = hashlib.sha256()
    h.update(CARRY_LAYOUT.encode())
    h.update(spec.name.encode())
    for a in tuple(cols) + (np.asarray(sizes, np.int64),):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _checkpoint_owned(path, fingerprint):
    """True when path is free or holds a snapshot with this
    fingerprint (a file that is not a snapshot counts as free)."""
    if not os.path.exists(path):
        return True
    try:
        with np.load(path) as data:
            return bytes(data["fingerprint"]).decode() == fingerprint
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return True


def write_snapshot(path, fingerprint, arrays):
    """Atomically write a fingerprinted npz snapshot (shared by the
    single-key and batched checkpoint paths)."""
    tmp = f"{path}.tmp"     # np.savez appends .npz to names without it
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        tmp, fingerprint=np.frombuffer(fingerprint.encode(), np.uint8),
        **arrays)
    os.replace(f"{tmp}.npz", path)


def read_snapshot(path, fingerprint):
    """A fingerprinted snapshot's array dict, or None when the file is
    absent, not a snapshot, or belongs to a different check."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            if bytes(data["fingerprint"]).decode() != fingerprint:
                return None
            return {k: data[k] for k in data.files if k != "fingerprint"}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def save_carry(path, fingerprint, carry):
    """Snapshot a search carry in the JAX package's layout (``c0`` ..
    ``c14``, ``carry_to_numpy``)."""
    write_snapshot(path, fingerprint,
                   {f"c{i}": x for i, x in enumerate(carry_to_numpy(carry))})


def _interpret(spec, e, out, max_iters, confirm, init_state, perm=None):
    status = int(out["status"])
    explored = int(out["explored"])
    result = {"configs_explored": explored,
              "iterations": int(out["iterations"]),
              "engine": "jax-wgl"}
    if status == VALID:
        result["valid"] = True
        _attach_valid_witness(result, e, out, perm, spec, init_state)
        return result
    exhausted = int(out["top"]) == 0
    dropped = bool(out["dropped"])
    if exhausted and not dropped:
        result["valid"] = False
        _attach_witness(result, e, out, perm, spec, init_state)
        if confirm:
            from . import wgl
            oracle = wgl.check_encoded(spec, e, init_state)
            result["confirmed"] = oracle["valid"] is False
            result["valid"] = oracle["valid"]
        return result
    result["valid"] = "unknown"
    result["error"] = ("stack-overflow" if dropped
                       else "max-configs-exceeded")
    return result


def _decode_slots(e, out, perm):
    """Decode the TOPK witness slots into (linearized bool[n], state)
    pairs, deepest-first; perm maps priority-sorted bit positions back to
    original op indices."""
    depths = np.asarray(out["best_depth"]).reshape(-1)
    lins = np.asarray(out["best_lin"], np.uint32).reshape(len(depths), -1)
    states = np.asarray(out["best_state"],
                        np.int32).reshape(len(depths), -1)
    n = len(e)
    slots = []
    for s in np.argsort(-depths, kind="stable"):
        if depths[s] < 0:
            continue
        bits = (lins[s][np.arange(n) // 32]
                >> (np.arange(n) % 32).astype(np.uint32)) & 1
        linearized = np.zeros(n, bool)
        pos = perm[:n] if perm is not None else np.arange(n)
        linearized[pos] = bits.astype(bool)
        slots.append((linearized, states[s]))
    return slots


def _attach_witness(result, e, out, perm, spec, init_state):
    """Decode the TOPK deepest distinct stuck configurations into
    knossos-style witness fields (see checker/witness.py)."""
    slots = _decode_slots(e, out, perm)
    if not slots:
        # no child ever linearized: the root config IS the stuck config
        slots = [(np.zeros(len(e), bool),
                  np.asarray(init_state, np.int32))]
    from . import witness
    witness.attach_multi(result, spec, e, slots, init_state)


def _attach_valid_witness(result, e, out, perm, spec, init_state):
    """On VALID the winning configuration sits in the TOPK witness slots:
    the deepest slot covering every ok op is the linearization found."""
    is_ok = np.asarray(e.is_ok, bool)
    n_ok = int(is_ok.sum())
    for linearized, _state in _decode_slots(e, out, perm):
        if int((linearized & is_ok).sum()) == n_ok:
            from . import witness
            result["witness"] = witness.build(
                spec, e, result.get("engine"), True, linearized,
                init_state)
            return


def check_history(spec, history, **kw):
    """Encode an event history for ``spec`` and run the device search."""
    e, init_state = spec.encode(history)
    return check_encoded(spec, e, init_state, **kw)
