"""Greedy rollout of the single-key search: the CUDA kernel, its gate,
its launch plan, its plain PyTorch version and its launch count.

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
``plan`` owns the kernel's layout for one launch: the chain's min tree,
its state's size, and where the op columns and the state live (shared
memory or a global scratch buffer); the kernel reads it and recomputes
none of it.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import torch

from ..models.mutex import _mutex_step
from ..models.registers import _cas_step, _register_step
from ..xp import TORCH
from . import words

INF32 = 2**31 - 1

#: kernel model ids (the ``switch`` in csrc/rollout.cu), keyed by the
#: port's step functions; any other model keeps the scan path
MODEL_IDS = {_register_step: 0, _cas_step: 1, _mutex_step: 2}

#: shared memory one block may use on an H100 (232,448 bytes), less 1 KB
#: of slack
SMEM_BUDGET = 232448 - 1024

#: kernel launches since the count was last reset (set it to 0 to start
#: a count); the wrapper adds one per launch, and nowhere else. A launch
#: recorded into a CUDA graph (``chunk_graph``) goes to that graph's own
#: count instead, and each replay of the graph adds it here
launches = 0
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
    """One launch of the kernel: into the capture's count while this
    thread records a graph, else into ``launches``."""
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


def gate(step_fn, NS, R, n, B, S, A):
    """The kernel's model id when it can roll this shape, else None (the
    caller keeps the scan path). Decides on the model and the shape
    alone: a model with a kernel step, one state word, ``n % 32 == 0``
    with ``B == n / 32``, and ``B * 4 <= SMEM_BUDGET`` (n up to 1,851,392
    ops). The kernel itself keeps a chain's state in global memory where
    shared memory is short, so the last limit is only the one the gate
    has always had."""
    model = MODEL_IDS.get(step_fn)
    if model is None or S != 1 or NS < 1 or R < 1:
        return None
    if n % 32 or B != n // 32 or A < 1:
        return None
    if B * 4 > SMEM_BUDGET:
        return None
    return model


def tree_sizes(B):
    """Entries per level of a chain's min tree over B bitset words: B,
    then ceil(/32) up to the first level of at most 32 entries."""
    sizes = [B]
    while sizes[-1] > 32:
        sizes.append((sizes[-1] + 31) // 32)
    return sizes


def _pad(x):
    return (x + 31) // 32 * 32


def state_bytes(B):
    """Bytes of one chain's state in the kernel: the min tree, two int32
    per entry with each level padded to a multiple of 32 entries, then
    the bitset padded to a multiple of 32 words."""
    return 8 * sum(_pad(s) for s in tree_sizes(B)) + 4 * _pad(B)


class Plan(NamedTuple):
    staged: bool       # invoke/ret (bulk copy) and the step's fields in
                       # shared memory, else read through L1/L2
    state_smem: bool   # the chain's state in shared memory, else scratch
    smem: int          # dynamic shared bytes per block
    scratch: int       # global scratch bytes (0 when state_smem)
    ops_off: int       # shared offset of the packed fields (staged)
    state_off: int     # shared offset of the chain's state (state_smem)


def plan(NS, n, B, aligned=True):
    """Where one launch keeps its data: the invoke/ret columns (8 bytes
    per op, after a 16-byte mbarrier) and the model step's fields packed
    (16 bytes per op) in shared memory beside the chain's state when all
    of it fits, else every column read through L1/L2. Staging needs both
    columns 16-byte aligned, as the bulk copy does. The chain's state
    goes to shared memory when it fits, else to a global scratch buffer
    of ``NS * state_bytes(B)`` bytes."""
    sb = state_bytes(B)
    cols = 16 + 24 * n
    if aligned and cols + sb <= SMEM_BUDGET:
        return Plan(True, True, cols + sb, 0, 16 + 8 * n, cols)
    if sb <= SMEM_BUDGET:
        return Plan(False, True, sb, 0, 0, 0)
    return Plan(False, False, 0, NS * sb, 0, 0)


class _Layout(ctypes.Structure):
    """``JtLayout`` of csrc/rollout.cu."""
    _fields_ = [("size", ctypes.c_int * 4), ("pad", ctypes.c_int * 4),
                ("off", ctypes.c_int * 4), ("lin_off", ctypes.c_longlong),
                ("state_bytes", ctypes.c_longlong),
                ("ops_off", ctypes.c_longlong),
                ("state_off", ctypes.c_longlong)]


def _layout(B, p):
    sizes = tree_sizes(B)
    pads = [_pad(x) for x in sizes]
    offs = [sum(pads[:k]) for k in range(len(sizes))]
    fill = [0] * (4 - len(sizes))
    c4 = ctypes.c_int * 4
    return _Layout(c4(*sizes, *fill), c4(*pads, *fill), c4(*offs, *fill),
                   8 * sum(pads), state_bytes(B), p.ops_off, p.state_off)


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


def _check(name, x, dtype, shape, device, kernel="rollout"):
    """Raise unless the kernel's argument ``name`` lies on ``device``
    with this dtype and shape, contiguous."""
    if x.device != device:
        raise ValueError(f"{kernel}: {name} on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def _launcher():
    from .. import _build
    fn = _build.library("rollout").jt_rollout_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.POINTER(_Layout)] \
            + [ctypes.c_int] * 9 + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def run(step_fn, seed_lin, seed_st, seed_ok, invoke, ret, fop, args, rets,
        R):
    """Roll the NS seed chains R steps: ``seed_lin`` (NS, B) int32 bit
    patterns, ``seed_st`` (NS, S) int32, ``seed_ok`` (NS,) bool;
    ``invoke``/``ret``/``fop`` (n,) int32 and ``args``/``rets`` (n, A)
    int32 in priority order. Returns ``(j, st)``. CPU tensors run
    ``plain``; CUDA tensors launch the kernel (raising on any refusal)."""
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
    aligned = invoke.data_ptr() % 16 == 0 and ret.data_ptr() % 16 == 0
    p = plan(NS, n, B, aligned)
    j = torch.empty((NS, R), dtype=i32, device=dev)
    st = torch.empty((NS, R, S), dtype=i32, device=dev)
    scratch = (torch.empty(p.scratch, dtype=torch.uint8, device=dev)
               if p.scratch else None)
    err = _launcher()(
        seed_lin.data_ptr(), seed_st.data_ptr(), seed_ok.data_ptr(),
        invoke.data_ptr(), ret.data_ptr(), fop.data_ptr(), args.data_ptr(),
        rets.data_ptr(), j.data_ptr(), st.data_ptr(),
        scratch.data_ptr() if p.scratch else None,
        ctypes.byref(_layout(B, p)), NS, R, n, B, A, model,
        len(tree_sizes(B)), int(p.staged), int(p.state_smem), p.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed: CUDA error "
                           f"{err}")
    _note_launch()
    return j, st
