"""Device-resident incremental linearizability: the streaming frontier
fold (the PyTorch port of ``jepsen_tpu.checker.streamlin``).

``checker/linear.py`` sweeps a history's *events* in time order,
maintaining the set of configurations (linearized-bitset, model state)
consistent with the prefix so far; an empty set at a return event is
the violation. The config set after a prefix is a *frontier* that later
events only ever extend, so the monitor keeps it ON DEVICE across chunk
boundaries (``monitor/wgl_stream.py`` owns the seal/probe split that
makes the carry sound) and re-checks a live stream in O(window):

    fold :: (frontier tensor, newly encoded cells) -> extended frontier

Device layout (all pow-2 shapes, a leading lane axis K of streams):

* ``lin``   (K, F, B) int32 -- per-config linearized bitset over window
                               SLOTS, uint32 bit patterns (B = NW/32)
* ``st``    (K, F, S) int32 -- per-config model state (fixed-width
                               models only; dynamic sizes fall back)
* ``live``  (K, F)    bool  -- which frontier rows are real configs
* ``open_w``(K, B)    int32 -- the open-op slot set as a bitset
* events    (K, E) host     -- 1 = invoke (opens the slot),
                               2 = return (forces the closure), 0 = pad

At a return event the fold runs the same BFS closure as the CPU sweep:
every not-yet-done config expands by every open op through the
branch-free ``spec.step`` (component first, over F*C candidates), the
pool dedups by multiply-shift fingerprints (sort + adjacent compare),
and the survivors compact back into the F rows.

The dedup differs from the JAX package's in one respect. The reference
keys it on one pair of 32-bit sums whose per-word multipliers
(``idx * 0x9E3779B1 + 0x85EBCA6B`` and ``idx * 0xC2B2AE35 + 0x27D4EB2F``)
are even at every odd word index, so the pair cannot tell apart configs
that differ only in those words' top bits (slots 62-63, 127, 189-191,
...): it drops one of them, and on histories of more than 62 ops the
offline face reports violations that the CPU sweep does not. Here a
second pair with odd multipliers (``words.hash_keys``) joins the sort
key after the reference's pair and the duplicate test, so distinct
configs survive. Where the reference's pair has no such collision, the
order, and so every carry array, is the reference's. ``n_keep > F`` or
more than C simultaneously-open slots flags overflow (status 2): the
caller grows the capacity and retries, or falls back to the flat
engines.

The JAX package compiles the fold into one program: a ``lax.scan`` over
the events, a ``lax.cond`` per event and a ``lax.while_loop`` of
closure passes per return. Here the loop over events runs on the host
and issues torch ops:

* an invoke is a masked OR into the open-slot set (no host read);
* a return reads, once before its first pass and once after each pass,
  whether any lane still has work -- the reference's loop condition.
  Those reads are the host syncs a fold pays (``syncs`` counts them,
  with the one read of the results);
* lanes (the reference's ``vmap``) each keep their carry while their own
  condition is false, so a lane's result equals its solo fold; after a
  violation or an overflow every later event of that lane is a no-op.

``check_encoded`` is the offline face: one fold over a whole encoded
history, with the verdict names of ``linear.check_encoded``.
``FoldJob``/``solo_fold``/``batch_fold`` run one stream or many streams
of one shape in one fold; under a bound obs registry ``batch_fold``
records the JAX batch fold's plan and heartbeat (``obs/search.py``)
from numbers it has already read. The reference's coalescer lane
(``fold_lane_spec``) waits for ROADMAP.md A.11(d).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..history import INF_TIME
from ..obs import search as obs_search
from ..util import bucket as _bucket
from ..xp import TORCH
from . import words

__all__ = ["DEFAULT_FRONTIER_CAP", "FRONTIER_CAP_MAX",
           "DEFAULT_WINDOW_CAP", "WINDOW_FLOOR", "OPEN_FLOOR",
           "EVENT_FLOOR", "FoldJob", "fresh_frontier", "history_job",
           "solo_fold", "batch_fold", "check_encoded"]

#: default / hard maximum frontier capacity (configs)
DEFAULT_FRONTIER_CAP = 4096
FRONTIER_CAP_MAX = 65536

#: initial frontier capacity floor (growth doubles, in pow-2 buckets)
FRONTIER_FLOOR = 64

#: window slot capacity: unsealed + forever-open (info) rows live in
#: slots; past the cap the stream degrades to flat re-checks
DEFAULT_WINDOW_CAP = 4096
WINDOW_FLOOR = 64

#: pow-2 floors for the open-op candidate axis and the event axis
OPEN_FLOOR = 8
EVENT_FLOOR = 64

#: positional order of FoldJob.arrays
_ARRAY_ORDER = ("lin", "st", "live", "open_w", "ev_kind", "ev_slot",
                "w_f", "w_args", "w_ret", "clear_w")

#: the reference's two fingerprints' (multiplier, offset) constants
_MIX = ((0x9E3779B1, 0x85EBCA6B), (0xC2B2AE35, 0x27D4EB2F))

#: host reads of device values made by folds (loop conditions and
#: results): a plain module counter; set it to 0 before a run to count
syncs = 0


def _read(t):
    """One host read of a device tensor, counted."""
    global syncs
    syncs += 1
    return t.tolist()


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


def _fingerprint_cols(n, dev):
    """The per-word multipliers of the four fingerprints over n words:
    the reference's two (even at odd word indices), then two odd ones
    (module docstring)."""
    idx = np.arange(n, dtype=np.uint32)
    return [torch.as_tensor(c.astype(np.int64), device=dev) for c in
            [idx * np.uint32(m) + np.uint32(a) for m, a in _MIX]
            + list(words.hash_keys(n))]


def _fingerprints(lin_w, st_w, cols):
    """32-bit multiply-shift sums over each config's words (lin bitset
    words then state words), one per row of per-column multipliers
    ``cols``; uint32 values in int64 tensors."""
    w = words.u32(torch.cat([lin_w, st_w], -1))
    out = []
    for c in cols:
        t = words.mul32(w, c)
        t = t ^ (t >> 15)
        t = words.mul32(t, 0x2C1B3C6D)
        t = t ^ (t >> 12)
        out.append(t.sum(-1) & words.M32)
    return out


def _fold(step, arrays, ev_kind, ev_slot, C):
    """Fold the events ``ev_kind``/``ev_slot`` (host int (K, E)) into
    the frontiers ``arrays`` (device tensors with a leading lane axis
    K, named as ``_ARRAY_ORDER``). Returns (lin, st, live, open_w,
    status, viol, passes, steps, n_live), each with the lane axis."""
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
        any_act, any_ret, go = _read(torch.stack(
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
            go = _read(cond.any())
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


def fresh_frontier(F, B, S, init_state):
    """The singleton frontier {(nothing linearized, init_state)} as
    host arrays shaped for the fold."""
    lin = np.zeros((F, B), np.uint32)
    st = np.zeros((F, S), np.int32)
    st[0] = np.asarray(init_state, np.int32)
    live = np.zeros(F, bool)
    live[0] = True
    open_w = np.zeros(B, np.uint32)
    return lin, st, live, open_w


def _tensor(a, dev):
    """A fold array (numpy, uint32 bitsets as int32 bit patterns, or a
    tensor) on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


class FoldJob:
    """One stream's frontier-extension step, for the solo path or a
    batch. ``arrays`` follow ``_ARRAY_ORDER``; ``len(job)`` is the REAL
    event count. Event arrays are host numpy; the frontier and window
    arrays may be tensors on the job's ``device`` (None: CUDA)."""

    __slots__ = ("spec", "C", "arrays", "n_events", "device")

    def __init__(self, spec, C, arrays, n_events, device=None):
        self.spec = spec
        self.C = int(C)
        self.arrays = arrays
        self.n_events = int(n_events)
        self.device = resolve_device(device)

    def __len__(self):
        return self.n_events

    @property
    def F(self):
        return int(self.arrays["lin"].shape[0])

    @property
    def B(self):
        return int(self.arrays["lin"].shape[1])

    @property
    def S(self):
        return int(self.arrays["st"].shape[1])

    @property
    def E(self):
        return int(self.arrays["ev_kind"].shape[0])

    @property
    def A(self):
        return int(self.arrays["w_args"].shape[1])

    def shape_key(self):
        return (self.spec.name, self.F, self.B, self.S, self.C, self.A)


def _results(out, batch=None):
    """Per-lane result dicts of one fold (one host read)."""
    rows = _read(torch.stack(list(out[4:9]), 1))
    res = []
    for k, (status, viol, passes, steps, n_live) in enumerate(rows):
        r = {"engine": "streamlin", "status": status, "viol_slot": viol,
             "passes": passes, "steps": steps, "n_live": n_live,
             "lin": out[0][k], "st": out[1][k], "live": out[2][k],
             "open_w": out[3][k]}
        if batch is not None:
            r["batch"] = batch
        res.append(r)
    return res


def solo_fold(job):
    """Run one FoldJob. Returns the fold result dict; the frontier
    tensors stay on the job's device for the caller to re-commit."""
    dev = job.device
    t0 = time.monotonic()
    arrays = {k: _tensor(job.arrays[k], dev)[None]
              for k in _ARRAY_ORDER if not k.startswith("ev_")}
    out = _fold(job.spec.step, arrays,
                np.asarray(job.arrays["ev_kind"], np.int32)[None],
                np.asarray(job.arrays["ev_slot"], np.int32)[None], job.C)
    r = _results(out)[0]
    r["device_s"] = time.monotonic() - t0
    return r


def _pad_events(a, E):
    a = np.asarray(a, np.int32)
    if a.shape[0] == E:
        return a
    return np.pad(a, (0, E - a.shape[0]))


def batch_fold(jobs):
    """Run many FoldJobs as lane-batched folds, grouped by full shape
    key (a mixed batch can never mis-stack). K pads to a pow-2 with
    inert (zero-event) lanes. Returns one result dict per job, in
    order."""
    results = [None] * len(jobs)
    groups: dict = {}
    for i, job in enumerate(jobs):
        groups.setdefault(job.shape_key(), []).append(i)
    t0 = time.monotonic()
    for _key, idxs in groups.items():
        members = [jobs[i] for i in idxs]
        if len(members) == 1:
            results[idxs[0]] = dict(solo_fold(members[0]), batch=1)
            continue
        dev = members[0].device
        E = _bucket(max(m.E for m in members), EVENT_FLOOR)
        K = _bucket(len(members), 1)
        # pad lanes are member 0 with no events: a fold over zero
        # events is the identity, so the lane is inert
        pad = K - len(members)
        arrays = {}
        for name in _ARRAY_ORDER:
            if name.startswith("ev_"):
                continue
            parts = [_tensor(m.arrays[name], dev) for m in members]
            arrays[name] = torch.stack(parts + parts[:1] * pad)
        ev = {name: np.stack([_pad_events(m.arrays[name], E)
                              for m in members]
                             + [np.zeros(E, np.int32)] * pad)
              for name in ("ev_kind", "ev_slot")}
        out = _fold(members[0].spec.step, arrays, ev["ev_kind"],
                    ev["ev_slot"], members[0].C)
        for i, r in zip(idxs, _results(out, batch=len(members))):
            results[i] = r
    dt = time.monotonic() - t0
    so = obs_search.capture()
    so.plan("streamlin-batch",
            _bucket(max((len(j) for j in jobs), default=1), EVENT_FLOOR),
            sum(len(j) for j in jobs), sum(j.E for j in jobs),
            keys=len(jobs), owners=1)
    so.heartbeat("streamlin-batch", iteration=1, chunk_s=dt, device_s=dt,
                 frontier=max((r["n_live"] for r in results if r),
                              default=0))
    return results


def history_job(spec, e, init_state, F=FRONTIER_FLOOR, device=None):
    """The fold job of a whole encoded history, as the offline face
    folds it: every invoke and return in time order, op row i in slot i,
    the singleton frontier in F rows, and C the bucket of the history's
    peak count of open ops."""
    n = len(e)
    init = np.asarray(init_state, np.int32)
    S = max(1, int(init.shape[0]))
    A = int(spec.arg_width)
    NW = _bucket(n, WINDOW_FLOOR)
    B = NW // 32
    events = sorted(
        [(int(e.invoke_idx[i]), 1, i) for i in range(n)]
        + [(int(e.return_idx[i]), 2, i) for i in range(n)
           if e.return_idx[i] < INF_TIME])
    c_now = c_max = 0
    for _t, kind, _i in events:
        c_now += 1 if kind == 1 else -1
        c_max = max(c_max, c_now)
    C = min(NW, _bucket(max(1, c_max), OPEN_FLOOR))
    E = _bucket(len(events), EVENT_FLOOR)
    ev_kind = np.zeros(E, np.int32)
    ev_slot = np.zeros(E, np.int32)
    for k, (_t, kind, i) in enumerate(events):
        ev_kind[k] = kind
        ev_slot[k] = i
    w_f = np.zeros(NW, np.int32)
    w_args = np.zeros((NW, A), np.int32)
    w_ret = np.zeros((NW, A), np.int32)
    w_f[:n] = e.f
    w_args[:n] = np.asarray(e.args, np.int32).reshape(n, A)
    w_ret[:n] = np.asarray(e.ret, np.int32).reshape(n, A)
    lin, st, live, open_w = fresh_frontier(F, B, S, init)
    return FoldJob(spec, C, {
        "lin": lin, "st": st, "live": live, "open_w": open_w,
        "ev_kind": ev_kind, "ev_slot": ev_slot, "w_f": w_f,
        "w_args": w_args, "w_ret": w_ret,
        "clear_w": np.zeros(B, np.uint32)}, len(events), device)


def check_encoded(spec, e, init_state, max_configs=DEFAULT_FRONTIER_CAP,
                  cancel=None, device=None):
    """The offline face: one frontier fold over a whole encoded history
    on ``device`` (None: CUDA). Same verdict names as
    ``linear.check_encoded`` (True / False with the violating ``op`` /
    "unknown" with ``max-configs-exceeded``); ``configs_explored``
    counts model-step evaluations."""
    n = len(e)
    if n == 0 or e.n_ok == 0:
        return {"valid": True, "configs_explored": 0,
                "engine": "streamlin"}
    dev = resolve_device(device)
    cap = min(_bucket(max(1, int(max_configs))), FRONTIER_CAP_MAX)
    F = min(cap, FRONTIER_FLOOR)
    steps = 0
    while True:
        if cancel is not None and cancel.is_set():
            return {"valid": "unknown", "error": "cancelled",
                    "configs_explored": steps, "engine": "streamlin"}
        r = solo_fold(history_job(spec, e, init_state, F, dev))
        steps += r["steps"]
        if r["status"] == 2 and F < cap:
            F = min(cap, F * 2)
            continue
        break
    if r["status"] == 2:
        return {"valid": "unknown", "error": "max-configs-exceeded",
                "configs_explored": steps, "engine": "streamlin",
                "frontier_cap": F}
    if r["status"] == 1:
        out = {"valid": False, "configs_explored": steps,
               "engine": "streamlin"}
        i = r["viol_slot"]
        if e.ops is not None and 0 <= i < len(e.ops):
            inv, comp = e.ops[i]
            out["op"] = dict(comp if comp is not None else inv)
        return out
    return {"valid": True, "configs_explored": steps,
            "engine": "streamlin", "frontier": r["n_live"]}
