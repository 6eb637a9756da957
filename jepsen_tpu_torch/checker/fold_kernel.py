"""The streaming frontier fold: the CUDA kernel, its gate, its scratch
plan, its plain PyTorch version and its launch count.

The counterpart of the reference's one jitted program per fold
(``jepsen_tpu/checker/streamlin.py:_build_fold``, XLA, not Pallas): the
kernel (``csrc/fold.cu``) folds every event of every lane, closure
passes included, in one launch, and its outputs equal ``plain``'s array
for array. ``plain`` is the same fold in torch ops, a host loop over the
events that reads its loop condition before and after every closure
pass.

``run`` is the only entry. On a CPU tensor it runs ``plain`` (the
tests). On a CUDA tensor it launches the kernel or raises, with no
fallback, when ``gate`` knows the model; a model the kernel has no step
for (a user-registered one) keeps ``plain`` on the card, decided on the
model alone before any launch and counted in ``plain_folds``. ``plan``
owns the kernel's per-lane scratch layout.

Array contract (K lanes): ``lin`` (K, F, B) int32 bitset words, ``st``
(K, F, S) int32, ``live`` (K, F) bool, ``open_w`` (K, B) int32,
``w_f`` (K, NW) int32, ``w_args``/``w_ret`` (K, NW, A) int32,
``clear_w`` (K, B) int32; events host int (K, E). Returns (lin, st,
live, open_w, status, viol, passes, steps, n_live), each with the lane
axis.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..models.mutex import _mutex_step
from ..models.registers import _cas_step, _multi_step, _register_step
from ..xp import TORCH
from . import words
from .rollout import _check

#: kernel model ids (the ``switch`` in csrc/fold.cu), keyed by the port's
#: step functions; any other model keeps ``plain``
MODEL_IDS = {_register_step: 0, _cas_step: 1, _mutex_step: 2,
             _multi_step: 3}

#: the reference's two fingerprints' (multiplier, offset) constants
_MIX = ((0x9E3779B1, 0x85EBCA6B), (0xC2B2AE35, 0x27D4EB2F))

#: the kernel's per-lane statistics (``run``'s ``clocks``, JF_STATS in
#: csrc/fold.cu): thread 0's clock cycles in each phase, then counts
STAT_NAMES = ("seen_rows", "candidates", "sort", "merge_fixup",
              "dedup_compaction", "return", "passes", "entries",
              "candidate_entries", "full_sort_passes", "global_pool_passes",
              "fixup_passes", "returns", "in_place_passes", "entries_max",
              "multi_tile_passes")
STATS = len(STAT_NAMES)
#: the phases among them, whose cycles make a lane's total
PHASES = STAT_NAMES[:6]

#: kernel launches since the count was last reset (set it to 0 to start
#: a count); the wrapper adds one per launch, and nowhere else. A launch
#: recorded into a CUDA graph goes to that capture's own count instead
#: (``counting_captured``), and each replay of the graph adds it here
#: (``add_replayed``), as ``rollout.launches`` counts
launches = 0
#: folds on CUDA tensors that ran ``plain`` because the gate does not
#: know their model
plain_folds = 0
_launches_lock = threading.Lock()
_captured = threading.local()


@contextlib.contextmanager
def counting_captured():
    """Route this thread's launches to a capture's own count while the
    block runs: yields a one-item list that counts them."""
    prev = getattr(_captured, "count", None)
    _captured.count = count = [0]
    try:
        yield count
    finally:
        _captured.count = prev


def _note_launch():
    global launches
    count = getattr(_captured, "count", None)
    if count is not None:
        count[0] += 1
        return
    with _launches_lock:
        launches += 1


def add_replayed(n):
    """A replay of a graph that recorded ``n`` launches."""
    global launches
    if n:
        with _launches_lock:
            launches += n


def gate(step_fn):
    """The kernel's model id for this step function, else None (the fold
    keeps ``plain``). Decides on the model alone; the shape is checked
    by ``run``, which raises on one the kernel cannot take."""
    return MODEL_IDS.get(step_fn)


def fingerprint_words(n):
    """The per-word multipliers of the fold's four fingerprints over n
    words, (4, n) uint32: the reference's two (even at odd word
    indices), then two odd ones (``words.hash_keys``; ROADMAP.md C.3)."""
    idx = np.arange(n, dtype=np.uint32)
    return np.stack([idx * np.uint32(m) + np.uint32(a) for m, a in _MIX]
                    + list(words.hash_keys(n))).astype(np.uint32)


def _fingerprint_cols(n, dev):
    """``fingerprint_words(n)`` as four int64 tensors on ``dev``."""
    return [torch.as_tensor(c.astype(np.int64), device=dev)
            for c in fingerprint_words(n)]


def _mix(w, c):
    """A fingerprint's term for word ``w`` under multiplier ``c``
    (uint32 values in int64 tensors)."""
    t = words.mul32(w, c)
    t = t ^ (t >> 15)
    t = words.mul32(t, 0x2C1B3C6D)
    return t ^ (t >> 12)


def _fingerprints(lin_w, st_w, cols):
    """32-bit multiply-shift sums over each config's words (lin bitset
    words then state words), one per row of per-column multipliers
    ``cols``; uint32 values in int64 tensors."""
    w = words.u32(torch.cat([lin_w, st_w], -1))
    return [_mix(w, c).sum(-1) & words.M32 for c in cols]


def _lexsort(keys):
    """The stable permutation sorting the last axis by ``keys``, least
    significant first (non-negative int64 tensors), as ``jnp.lexsort``:
    one stable sort per key."""
    order = None
    for k in keys:
        if order is not None:
            k = k.gather(-1, order)
        o = torch.sort(k, dim=-1, stable=True).indices
        order = o if order is None else order.gather(-1, o)
    return order


def _tolist(t):
    return t.tolist()


def plain(step, arrays, ev_kind, ev_slot, C, read=_tolist):
    """The fold in torch ops: a host loop over the events ``ev_kind``/
    ``ev_slot`` (host int (K, E)) into the frontiers ``arrays`` (tensors
    with a leading lane axis K). ``read`` makes each host read of a
    device value (the loop conditions)."""
    lin, st, live, open_w = (arrays[k] for k in
                             ("lin", "st", "live", "open_w"))
    w_f, w_args, w_ret = arrays["w_f"], arrays["w_args"], arrays["w_ret"]
    K, F, B = lin.shape
    S, A = st.shape[2], w_args.shape[2]
    NW = B * 32
    P = F * (C + 1)
    dev = lin.device
    i32 = torch.int32

    def i32s(x):
        return torch.as_tensor(np.asarray(x), dtype=i32, device=dev)

    status = torch.zeros(K, dtype=i32, device=dev)
    viol = torch.full((K,), -1, dtype=i32, device=dev)
    passes = torch.zeros(K, dtype=i32, device=dev)
    steps = torch.zeros(K, dtype=i32, device=dev)
    slot_ids = torch.arange(NW, dtype=torch.int64, device=dev)
    b_ids = torch.arange(B, dtype=torch.int64, device=dev)
    shifts = torch.arange(32, dtype=i32, device=dev)
    cols = _fingerprint_cols(B + S, dev)
    # ~pool_o: the F established configs (0) sort before candidates (1)
    new_key = (torch.arange(P, device=dev) >= F).to(torch.int64)

    for t in range(ev_kind.shape[1]):
        kind = ev_kind[:, t]
        if not (kind > 0).any():
            continue
        s = np.clip(ev_slot[:, t], 0, NW - 1)
        s_t = i32s(s)
        word = torch.as_tensor(s // 32, dtype=torch.int64, device=dev)
        sh = i32s(s % 32)[:, None]                       # (K, 1)
        bit = words.bit_mask(s_t)
        one_hot = b_ids[None, :] == word[:, None]        # (K, B)
        act = status == 0
        if (kind == 1).any():
            m = act & torch.as_tensor(kind == 1, device=dev)
            open_w = open_w | torch.where(
                m[:, None] & one_hot, bit[:, None], 0)
        if not (kind == 2).any():
            continue

        def tbit(lin_w):
            """(K, F') whether each config has the returning slot."""
            wv = lin_w.gather(2, word[:, None, None].expand(
                K, lin_w.shape[1], 1))[..., 0]
            return ((wv >> sh) & 1) == 1

        R = act & torch.as_tensor(kind == 2, device=dev)
        bits = ((open_w[:, :, None] >> shifts) & 1).reshape(K, NW)
        n_open = bits.sum(-1)
        # open slot ids ascending, padded with NW
        oidx = torch.sort(torch.where(bits > 0, slot_ids, NW),
                          dim=-1).values[:, :C]
        j_valid = oidx < NW
        jc = oidx.clamp(max=NW - 1)
        f_j = w_f.gather(1, jc)                                  # (K, C)
        a_j = w_args.gather(1, jc[..., None].expand(K, C, A))
        r_j = w_ret.gather(1, jc[..., None].expand(K, C, A))
        j_word = jc // 32
        j_sh = (jc % 32).to(i32)[:, None, :]                     # (K,1,C)
        add_mask = torch.where(
            b_ids[None, None, :] == j_word[..., None],
            words.bit_mask(jc)[..., None], 0)                    # (K,C,B)
        # the step's op columns, component first against (K, F, C)
        sf = f_j[:, None, :]
        sa = a_j.permute(2, 0, 1)[:, :, None, :]
        sr = r_j.permute(2, 0, 1)[:, :, None, :]

        seen = live
        work = live & ~tbit(lin)
        p = torch.zeros(K, dtype=i32, device=dev)
        stp = steps
        ovf = n_open > C
        nlin, nst = lin, st
        cond = R & work.any(-1) & ~ovf
        any_act, any_ret, go = read(torch.stack(
            [act.any(), R.any(), cond.any()]))
        if not any_act:
            break           # every lane stopped: later events are no-ops
        if not any_ret:
            continue
        while go:
            st_planes = nst.permute(2, 0, 1)[..., None]         # (S,K,F,1)
            st2, ok = step(st_planes, sf, sa, sr, TORCH)
            st2 = torch.broadcast_to(st2, (S, K, F, C)).permute(
                1, 2, 3, 0).reshape(K, F * C, S).to(i32)
            ok = torch.broadcast_to(ok, (K, F, C)).reshape(K, F * C)
            lw = nlin.gather(2, j_word[:, None, :].expand(K, F, C))
            already = ((lw >> j_sh) & 1) == 1                    # (K,F,C)
            parent_ok = work[:, :, None] & j_valid[:, None, :] & ~already
            stp2 = stp + parent_ok.sum((1, 2), dtype=i32)
            cand_valid = parent_ok.reshape(K, F * C) & ok
            cand_lin = (nlin[:, :, None, :]
                        | add_mask[:, None, :, :]).reshape(K, F * C, B)
            # dedup pool: the F survivors-so-far + all F*C candidates;
            # old entries sort first among equal fingerprints so the
            # established config wins: the reference's
            # jnp.lexsort((~o, h2, h1, ~v)) with h4, h3 after h2
            pool_lin = torch.cat([nlin, cand_lin], 1)
            pool_st = torch.cat([nst, st2], 1)
            pool_v = torch.cat([seen, cand_valid], 1)
            h1, h2, h3, h4 = _fingerprints(pool_lin, pool_st, cols)
            order = _lexsort([h4 * 2 + new_key, h3, h2,
                              ((~pool_v).to(torch.int64) << 32) | h1])
            sl = pool_lin.gather(1, order[..., None].expand(K, P, B))
            ss = pool_st.gather(1, order[..., None].expand(K, P, S))
            sv = pool_v.gather(1, order)
            so = order < F
            same = sv[:, 1:] & sv[:, :-1]
            for h in (h1, h2, h3, h4):
                hs = h.gather(1, order)
                same = same & (hs[:, 1:] == hs[:, :-1])
            dup = torch.cat([
                torch.zeros((K, 1), dtype=torch.bool, device=dev), same], 1)
            keep = sv & ~dup
            ovf2 = ovf | (keep.sum(-1) > F)
            # kept rows take positions 0.. in sorted order; the rest
            # (and any past F) land on the sentinel row F, dropped
            pos = torch.where(keep, (keep.cumsum(-1) - 1).clamp(max=F), F)

            def compact(x, fill_dtype):
                out = torch.zeros((K, F + 1) + x.shape[2:],
                                  dtype=fill_dtype, device=dev)
                ix = pos.reshape(pos.shape + (1,) * (x.dim() - 2))
                return out.scatter_(1, ix.expand(x.shape), x)[:, :F]

            lin3 = compact(sl, i32)
            st3 = compact(ss, i32)
            seen3 = compact(keep, torch.bool)
            old3 = compact(so & keep, torch.bool)
            # fresh configs without the target go back to work;
            # expanded (old) ones retire to dedup-only ghosts
            work3 = seen3 & ~tbit(lin3) & ~old3
            if K == 1:
                nlin, nst, seen, work, stp, ovf = (lin3, st3, seen3, work3,
                                                   stp2, ovf2)
                p = p + 1
            else:
                nlin = torch.where(cond[:, None, None], lin3, nlin)
                nst = torch.where(cond[:, None, None], st3, nst)
                seen = torch.where(cond[:, None], seen3, seen)
                work = torch.where(cond[:, None], work3, work)
                stp = torch.where(cond, stp2, stp)
                ovf = torch.where(cond, ovf2, ovf)
                p = p + cond.to(i32)
            cond = R & work.any(-1) & ~ovf & (p < C + 1)
            go = read(cond.any())
        final = seen & tbit(nlin)
        violated = ~final.any(-1) & ~ovf
        open_w2 = open_w & torch.where(one_hot, ~bit[:, None], -1)
        status2 = torch.where(ovf, 2, torch.where(violated, 1, status))
        viol2 = torch.where(violated, s_t, viol)
        if K == 1:
            lin, st, live, open_w = nlin, nst, final, open_w2
            status, viol, passes, steps = status2, viol2, passes + p, stp
        else:
            lin = torch.where(R[:, None, None], nlin, lin)
            st = torch.where(R[:, None, None], nst, st)
            live = torch.where(R[:, None], final, live)
            open_w = torch.where(R[:, None], open_w2, open_w)
            status = torch.where(R, status2, status)
            viol = torch.where(R, viol2, viol)
            passes = torch.where(R, passes + p, passes)
            steps = torch.where(R, stp, steps)
    # recycle fully-sealed slots: their bit is set in EVERY live config
    # (the return event forced it), so clearing is uniform
    lin = lin & ~arrays["clear_w"][:, None, :]
    return (lin, st, live, open_w, status, viol, passes, steps,
            live.sum(-1, dtype=i32))


#: the most entries the kernel's pool keeps in shared memory (24 bytes
#: each, 48 KiB); a pass whose sorted entries are more runs the same code
#: over the global pool. It is at most the kernel's sort tile (JF_T *
#: JF_IPT = 512 * 4). On the card a larger pool left less of the SM's
#: memory to L1, which the pass's gathers of rows and orders hit, and was
#: slower (PERF.md)
SMEM_POOL = 2048


class Plan(NamedTuple):
    """Byte offsets of one lane's scratch, each 16-byte aligned, and the
    shared pool's capacity; the kernel's ``JfLayout``."""
    lane_bytes: int
    lin0: int          # F * B words: row heap 0's bitsets ...
    st0: int           # ... F * S words: its states ...
    fp0: int           # ... F * 16 bytes: its rows' h1..h4
    lin1: int          # row heap 1, the same three parts
    st1: int
    fp1: int
    ord0: int          # F int32 each: row -> heap slot, two buffers
    ord1: int
    alist: int         # F int32: the seen rows at a return's first pass
    worklist: int      # F int32: the rows to expand ...
    workslot: int      # ... F int32: their heap slots
    ops: int           # C * (2 + 2A) int32: open slots, f, args, rets
    key0: int          # P = F * (C + 1) uint32 each: the global pool's
    val0: int          # h1 and entry index, two buffers for the sort ...
    key1: int
    val1: int
    ent: int           # ... and P * 16 bytes: h2, h3, h4, pool index
    smem_items: int    # entries of the shared pool: min(SMEM_POOL, P)


def plan(F, B, S, A, C):
    """One lane's scratch layout for a fold of this shape."""
    P = F * (C + 1)
    heap = (("lin", 4 * F * B), ("st", 4 * F * S), ("fp", 16 * F))
    parts = tuple((f"{n}{h}", b) for h in (0, 1) for n, b in heap) + (
        ("ord0", 4 * F), ("ord1", 4 * F), ("alist", 4 * F),
        ("worklist", 4 * F), ("workslot", 4 * F),
        ("ops", 4 * C * (2 + 2 * A)), ("key0", 4 * P), ("val0", 4 * P),
        ("key1", 4 * P), ("val1", 4 * P), ("ent", 16 * P))
    offs, off = {}, 0
    for name, n in parts:
        offs[name] = off
        off += (n + 15) // 16 * 16
    return Plan(off, **offs, smem_items=min(SMEM_POOL, P))


def scratch_bytes(K, F, B, S, A, C):
    """Global scratch of one launch: K lanes of ``plan``."""
    return K * plan(F, B, S, A, C).lane_bytes


class _Layout(ctypes.Structure):
    """``JfLayout`` of csrc/fold.cu."""
    _fields_ = [(name, ctypes.c_longlong) for name in Plan._fields]


def _launcher():
    from .. import _build
    fn = _build.library("fold").jf_fold_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.POINTER(_Layout)] \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def run(step, arrays, ev_kind, ev_slot, C, read=_tolist, clocks=None):
    """Fold the events into the frontiers ``arrays`` (module docstring).
    CPU tensors run ``plain`` (whose host reads go through ``read``); on
    CUDA tensors a model the gate knows launches the kernel, raising on
    any refusal, and makes no host read; any other model runs
    ``plain``. ``clocks``, a (K, STATS) int64 tensor on the card, gets
    the kernel's per-lane statistics added into it (``STAT_NAMES``);
    the outputs do not change."""
    global plain_folds
    dev = arrays["lin"].device
    model = gate(step)
    if dev.type != "cuda" or model is None:
        if dev.type == "cuda":
            with _launches_lock:
                plain_folds += 1
        return plain(step, arrays, ev_kind, ev_slot, C, read)
    return _launch(model, arrays, ev_kind, ev_slot, C, clocks,
                   torch.cuda.current_stream(dev).cuda_stream)


def _launch(model, arrays, ev_kind, ev_slot, C, clocks, stream):
    """``run``'s kernel launch on ``stream`` (a CUDA stream handle) for
    model id ``model``: the checks, the upload, the outputs and the
    scratch on the arrays' device, the launch and its count."""
    dev = arrays["lin"].device
    K, F, B = arrays["lin"].shape
    S, A = arrays["st"].shape[2], arrays["w_args"].shape[2]
    NW = B * 32
    C = int(C)
    ev_kind = np.asarray(ev_kind, np.int32)
    ev_slot = np.asarray(ev_slot, np.int32)
    E = ev_kind.shape[1]
    if (model < 3 and S != 1) or (model == 1 and A < 2) \
            or (model == 3 and S != A) or C < 1 or F * (C + 1) >= 2**31 \
            or ev_kind.shape != (K, E) or ev_slot.shape != (K, E):
        raise ValueError(f"fold kernel refuses this shape (K={K}, F={F}, "
                         f"B={B}, S={S}, A={A}, C={C}, events "
                         f"{ev_kind.shape}/{ev_slot.shape}) for model "
                         f"{model}")
    i32 = torch.int32
    for name, dtype, shape in (
            ("lin", i32, (K, F, B)), ("st", i32, (K, F, S)),
            ("live", torch.bool, (K, F)), ("open_w", i32, (K, B)),
            ("w_f", i32, (K, NW)), ("w_args", i32, (K, NW, A)),
            ("w_ret", i32, (K, NW, A)), ("clear_w", i32, (K, B))):
        _check(name, arrays[name], dtype, shape, dev, "fold")
    # one upload: the fingerprint multipliers, then every lane's kinds
    # and slots
    n = 4 * (B + S)
    host = np.concatenate([fingerprint_words(B + S).view(np.int32).ravel(),
                           np.stack([ev_kind, ev_slot], 1).ravel()])
    up = torch.from_numpy(host).to(dev)
    p = plan(F, B, S, A, C)
    lin = torch.empty((K, F, B), dtype=i32, device=dev)
    st = torch.empty((K, F, S), dtype=i32, device=dev)
    live = torch.empty((K, F), dtype=torch.bool, device=dev)
    open_w = torch.empty((K, B), dtype=i32, device=dev)
    res = torch.empty((K, 5), dtype=i32, device=dev)
    scratch = torch.empty(K * p.lane_bytes, dtype=torch.uint8, device=dev)
    if clocks is not None:
        _check("clocks", clocks, torch.int64, (K, STATS), dev, "fold")
    err = _launcher()(
        arrays["lin"].data_ptr(), arrays["st"].data_ptr(),
        arrays["live"].data_ptr(), arrays["open_w"].data_ptr(),
        arrays["w_f"].data_ptr(), arrays["w_args"].data_ptr(),
        arrays["w_ret"].data_ptr(), arrays["clear_w"].data_ptr(),
        up.data_ptr(), up[n:].data_ptr(), lin.data_ptr(), st.data_ptr(),
        live.data_ptr(), open_w.data_ptr(), res.data_ptr(),
        scratch.data_ptr(), ctypes.byref(_Layout(*p)), K, F, B, S, A, C, E,
        model, None if clocks is None else clocks.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fold kernel launch failed: CUDA error {err}")
    _note_launch()
    return (lin, st, live, open_w, res[:, 0], res[:, 1], res[:, 2],
            res[:, 3], res[:, 4])


def barrier_ns(dev, n=1 << 16):
    """The card's time for one barrier of a 1024-thread block, from the
    kernel's ``jf_barrier_probe`` (``n`` barrier pairs, timed with CUDA
    events after a warm-up): the latency floor's unit."""
    from .. import _build
    fn = _build.library("fold").jf_barrier_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    for reps in (16, n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        if fn(reps, out.data_ptr(), stream.cuda_stream) != 0:
            raise RuntimeError("fold barrier probe launch failed")
        b.record(stream)
        b.synchronize()
    return a.elapsed_time(b) * 1e6 / (2 * n)
