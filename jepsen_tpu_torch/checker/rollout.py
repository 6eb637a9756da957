"""Greedy rollout of the single-key search: the CUDA kernel, its gate, its
plain PyTorch version and its launch count.

The counterpart of ``jepsen_tpu/checker/pallas_rollout.py``: the kernel
(``csrc/rollout.cu``) replaces ``build_fused_rollout``. Contract, for NS
seed configurations of one key and R steps: at each step ``rm`` is the
min return over the unlinearized ops, an op is eligible when it is
unlinearized and ``invoke < rm``, and the chain takes the first eligible
op in index (= priority) order whose model step succeeds, flips it out
and takes its post-state. It returns ``j`` (NS, R) int32, the op taken at
each step (-1 from the step the chain wedges onward), and ``st``
(NS, R, S) int32, the state after each step (repeated once the chain is
dead). The caller rebuilds the per-step bitsets and fingerprint sums.

``run`` is the only entry: on a CPU tensor it runs ``plain`` (the tests);
on a CUDA tensor it launches the kernel or raises -- there is no
fallback. ``gate`` decides on the model and the shape alone whether the
kernel applies; when it returns None the search keeps its scan path.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.mutex import _mutex_step
from ..models.registers import _cas_step, _register_step
from ..xp import TORCH
from . import words

INF32 = 2**31 - 1

#: kernel model ids (the ``switch`` in csrc/rollout.cu), keyed by the
#: port's step functions; any other model keeps the scan path
MODEL_IDS = {_register_step: 0, _cas_step: 1, _mutex_step: 2}

#: shared memory one block may use on an H100 (232,448 bytes), less the
#: kernel's static reduction scratch
SMEM_BUDGET = 232448 - 1024

#: kernel launches since the count was last reset (set it to 0 to start
#: a count); the wrapper adds one per launch, and nowhere else
launches = 0


def gate(step_fn, NS, R, n, B, S, A):
    """The kernel's model id when it can roll this shape, else None (the
    caller keeps the scan path). Decides on the model and the shape
    alone: a model with a kernel step, one state word, ``n % 32 == 0``
    with ``B == n / 32``, and the packed bitset within shared memory."""
    model = MODEL_IDS.get(step_fn)
    if model is None or S != 1 or NS < 1 or R < 1:
        return None
    if n % 32 or B != n // 32 or A < 1:
        return None
    if B * 4 > SMEM_BUDGET:
        return None
    return model


def plain(step_fn, seed_lin, seed_st, seed_ok, invoke, ret, fop, args,
          rets, R):
    """The kernel's function in plain PyTorch: a Python loop over the R
    steps, vectorised over the NS chains and the n ops."""
    NS, _ = seed_lin.shape
    n = invoke.shape[0]
    dev = seed_lin.device
    lin = seed_lin.clone()
    st = seed_st.clone()
    alive = seed_ok.clone()
    rows = torch.arange(NS, device=dev)
    f_b = fop[None, :]                                   # (1, n)
    a_b = args.T[:, None, :]                             # (A, 1, n)
    r_b = rets.T[:, None, :]
    j_out = torch.empty((NS, R), dtype=torch.int32, device=dev)
    st_out = torch.empty((NS, R) + tuple(st.shape[1:]), dtype=torch.int32,
                         device=dev)
    inf = torch.tensor(INF32, dtype=torch.int32, device=dev)
    for t in range(R):
        unl = words.unpack_unlin(lin, n)                 # (NS, n)
        rm = torch.where(unl, ret[None, :], inf).amin(dim=1)
        elig = unl & (invoke[None, :] < rm[:, None])
        stn, okn = step_fn(st.T[:, :, None], f_b, a_b, r_b, TORCH)
        succ = elig & torch.broadcast_to(okn, elig.shape)
        jf = torch.argmax(succ.to(torch.uint8), dim=1)   # first success
        took = succ.any(dim=1) & alive
        bit = torch.where(took, words.bit_mask(jf), 0)
        w = jf // 32
        lin[rows, w] = lin[rows, w] | bit
        stn = torch.broadcast_to(stn, (stn.shape[0], NS, n))
        new = stn[:, rows, jf].T.to(torch.int32)         # (NS, S)
        st = torch.where(took[:, None], new, st)
        alive = took
        j_out[:, t] = torch.where(took, jf.to(torch.int32), -1)
        st_out[:, t] = st
    return j_out, st_out


def chain_bitsets(seed_lin, j):
    """The per-step bitsets of chains rolled from ``seed_lin`` (NS, B)
    int32 that took ops ``j`` (NS, R) (-1 once dead): returns (after
    each step, before each step), both (NS, R, B) uint32 values in int64.

    The reference ORs one-hot word masks with an associative scan
    (``jax_wgl.py:563-568``); torch has no OR-scan. Every live step sets
    a bit that was clear (an op leaves the unlinearized set once), so
    the masks are disjoint and an integer cumsum over them IS the OR."""
    NS, R = j.shape
    took = j >= 0
    jc = j.clamp(min=0).to(torch.int64)
    bits = torch.where(took, words.u32(words.bit_mask(jc)), 0)
    masks = torch.zeros((NS, R, seed_lin.shape[1]), dtype=torch.int64,
                        device=seed_lin.device)
    masks.scatter_(2, (jc // 32)[..., None], bits[..., None])
    seed = words.u32(seed_lin)[:, None, :]
    after = seed | masks.cumsum(dim=1)
    return after, torch.cat([seed, after[:, :-1]], dim=1)


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"rollout: {name} on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"rollout: {name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"rollout: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"rollout: {name} is not contiguous")


def _launcher():
    from .. import _build
    fn = _build.library("rollout").jt_rollout_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def run(step_fn, seed_lin, seed_st, seed_ok, invoke, ret, fop, args, rets,
        R):
    """Roll the NS seed chains R steps: ``seed_lin`` (NS, B) int32 bit
    patterns, ``seed_st`` (NS, S) int32, ``seed_ok`` (NS,) bool;
    ``invoke``/``ret``/``fop`` (n,) int32 and ``args``/``rets`` (n, A)
    int32 in priority order. Returns ``(j, st)``. CPU tensors run
    ``plain``; CUDA tensors launch the kernel (raising on any refusal)."""
    global launches
    dev = seed_lin.device
    if dev.type != "cuda":
        return plain(step_fn, seed_lin, seed_st, seed_ok, invoke, ret,
                     fop, args, rets, R)
    NS, B = seed_lin.shape
    n = invoke.shape[0]
    S = seed_st.shape[1]
    A = args.shape[1]
    model = gate(step_fn, NS, R, n, B, S, A)
    if model is None:
        raise ValueError(f"rollout kernel refuses this model or shape "
                         f"(NS={NS}, R={R}, n={n}, B={B}, S={S}, A={A})")
    i32 = torch.int32
    for name, x, dtype, shape in (
            ("seed_lin", seed_lin, i32, (NS, B)),
            ("seed_st", seed_st, i32, (NS, S)),
            ("seed_ok", seed_ok, torch.bool, (NS,)),
            ("invoke", invoke, i32, (n,)), ("ret", ret, i32, (n,)),
            ("fop", fop, i32, (n,)), ("args", args, i32, (n, A)),
            ("rets", rets, i32, (n, A))):
        _check(name, x, dtype, shape, dev)
    j = torch.empty((NS, R), dtype=i32, device=dev)
    st = torch.empty((NS, R, S), dtype=i32, device=dev)
    err = _launcher()(
        seed_lin.data_ptr(), seed_st.data_ptr(), seed_ok.data_ptr(),
        invoke.data_ptr(), ret.data_ptr(), fop.data_ptr(), args.data_ptr(),
        rets.data_ptr(), j.data_ptr(), st.data_ptr(), NS, R, n, B, A,
        model, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return j, st
