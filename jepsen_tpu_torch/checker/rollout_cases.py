"""Inputs that hold the rollout kernel (``rollout.py``) against its plain
version on the paths its bookkeeping adds, and the work a rollout needs.

``adversarial`` builds, with numpy from one seed, the cases the kernel's
min tree, frontier and early stop must get right: ops not sorted by ret,
an eligible success only at the tail, chains that wedge mid-launch, dense
seed bitsets whose frontier is past word 0, all seeds dead, and n =
131072. The CPU tests hold ``rollout.plain`` against the JAX package's
Pallas kernel in interpret mode on them, the card tests and
``chip_smoke.py`` hold the kernel against ``rollout.plain``.

``main_path`` gives the rollout's inputs at the main-path shapes: the op
columns of a simulated 64-process history and NS seed configurations
from its search (``MAIN_SHAPES``).

``work`` counts, from a rollout's output, what the function needed on
these inputs: the live steps, the longest chain, and the ops from each
step's frontier word to the op taken (to n for the step that wedges).
"""

from __future__ import annotations

import random
from typing import NamedTuple

import numpy as np
import torch

from .. import models, simulate
from ..history import NIL
from . import torch_wgl

INF32 = 2**31 - 1
FULL = 0xFFFFFFFF


class Case(NamedTuple):
    name: str
    model: str
    R: int
    seed_lin: np.ndarray    # (NS, B) uint32
    seed_st: np.ndarray     # (NS, 1) int32
    seed_ok: np.ndarray     # (NS,) bool
    invoke: np.ndarray      # (n,) int32
    ret: np.ndarray         # (n,) int32
    fop: np.ndarray         # (n,) int32
    args: np.ndarray        # (n, A) int32
    rets: np.ndarray        # (n, A) int32

    @property
    def step(self):
        return models.model_spec(self.model).step

    def tensors(self, device="cpu"):
        """The arguments of ``rollout.run`` after ``step_fn``, before R,
        on ``device`` (``seed_lin`` as int32 bit patterns)."""
        xs = (self.seed_lin.view(np.int32), self.seed_st, self.seed_ok,
              self.invoke, self.ret, self.fop, self.args, self.rets)
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                for x in xs]


def pack(bits):
    """(NS, n) bool, n % 32 == 0 -> (NS, n/32) uint32 words, op i at bit
    i % 32 of word i // 32."""
    NS, n = bits.shape
    w = bits.reshape(NS, n // 32, 32).astype(np.uint64)
    return (w << np.arange(32, dtype=np.uint64)).sum(axis=2) \
        .astype(np.uint32)


def real_columns(model, n_ops, seed, procs=8, crash_p=0.05):
    """Op columns of a simulated ``n_ops``-op history as the search sees
    them (priority order, padded to a pow-2 bucket): (invoke, ret, fop,
    args, rets, rows before padding, initial state)."""
    spec = models.model_spec(model)
    hist = simulate.random_history(random.Random(seed), model, procs, n_ops,
                                   crash_p)
    e, st = spec.encode(hist)
    kind, prep = torch_wgl._prepare_search(spec, e, st)
    assert kind == "search", f"{model}: decided by a fast path"
    _, inv, ret, fop, args, rets, _, init, _, _, _, _ = prep
    return inv, ret, fop, args, rets, len(e), int(init[0])


#: the main-path shapes: (model, history ops, crash probability). The
#: first three encode to n = 8192 (7.5k register ops encode to 7.5k
#: rows, 10k cas/mutex ops to fewer); the last to n = 131072
MAIN_SHAPES = (("register", 7_500, 0.05), ("cas-register", 10_000, 0.05),
               ("mutex", 10_000, 0.02), ("cas-register", 100_000, 0.05))


def main_path(model, n_ops, crash_p, device, NS=8, iters=3):
    """The rollout's inputs for a simulated ``n_ops``-op, 64-process
    history (seeded ``random.Random(45100)``) as the search sees them, on
    ``device``: ``(seed_lin, seed_st, seed_ok, invoke, ret, fop, args,
    rets)`` and the encoded row count. The seeds are the top of the
    search's stack after ``iters`` iterations without rollout; the last
    is marked dead so the dead-seed path runs too."""
    spec = models.model_spec(model)
    hist = simulate.random_history(random.Random(45100), model, 64, n_ops,
                                   crash_p)
    e, init_state = spec.encode(hist)
    kind, prep = torch_wgl._prepare_search(spec, e, init_state)
    assert kind == "search", f"{model}: history decided by a fast path"
    (_, inv32, ret32, fop, args, rets, ok_words, init_state, n_pad, C, A,
     S) = prep
    B, W, O, T = torch_wgl._plan_sizes(n_pad, S, C)
    init_carry, _, run_chunk = torch_wgl._build_search(
        spec.step, 1, n_pad, B, S, C, A, W, O, T, R=0,
        rollout_kernel="scan", device=str(device))
    consts = torch_wgl.make_consts(inv32, ret32, fop, args, rets, ok_words,
                                   device)
    with torch_wgl.chunk_graph.Lease() as lease:
        carry = run_chunk(init_carry(init_state[None]), consts, iters,
                          lease)
        top = int(carry[torch_wgl.IDX_TOP][0])
        pos = torch.tensor([(top - 1 - k) % O for k in range(NS)],
                           device=device)
        seed_ok = torch.tensor([k < top for k in range(NS)], device=device)
        seed_ok[-1] = False
        cols = [x[0].contiguous() for x in consts[:5]]
        # gathered copies: the graph's static carry goes back to the cache
        return [carry[torch_wgl.IDX_BUF_LIN][pos].contiguous(),
                carry[torch_wgl.IDX_BUF_STATE][pos].contiguous(), seed_ok,
                *cols], len(e)


def _padded(n, A):
    """Columns of n padding rows as ``torch_wgl._prepare_search`` makes
    them, for the caller to fill from the front."""
    inv = np.full(n, INF32 - 1, np.int32)
    ret = np.full(n, INF32, np.int32)
    return (inv, ret, np.zeros(n, np.int32), np.zeros((n, A), np.int32),
            np.zeros((n, A), np.int32))


def _case(name, model, R, bits, states, ok, cols):
    return Case(name, model, R, pack(bits),
                np.asarray(states, np.int32).reshape(-1, 1),
                np.asarray(ok, bool), *cols)


def _unsorted(rng, seed):
    """Real cas-register columns in a random op order (padding rows
    included), so rm is rarely the frontier op's ret."""
    inv, ret, fop, args, rets, _, _ = real_columns(
        "cas-register", 600, seed, crash_p=0.1)
    perm = rng.permutation(len(inv))
    cols = (inv[perm], ret[perm], fop[perm], args[perm], rets[perm])
    bits = rng.rand(4, len(inv)) < 0.03
    states = rng.choice([NIL, 0, 1, 2, 3], size=4)
    return _case("unsorted", "cas-register", 48, bits, states,
                 [True, True, True, False], cols)


def _tail_success():
    """Register: 2040 overlapping reads of 7, then 7 crashed reads of 5
    and a crashed write of 7 at the tail (ret INF32, early invoke). From
    state 0 every eligible read fails, so the only success is the last
    op; the reads between are not eligible and must be skipped."""
    n = 2048
    inv, ret, fop, args, rets = _padded(n, 1)
    k = np.arange(n - 8)
    inv[:n - 8], ret[:n - 8], rets[:n - 8, 0] = 10 * k, 10 * k + 25, 7
    inv[n - 8:n - 1], rets[n - 8:n - 1, 0] = 3 + np.arange(7), 5
    inv[n - 1], fop[n - 1], args[n - 1, 0] = 1, 1, 7
    bits = np.zeros((4, n), bool)
    bits[2, :1000] = True            # frontier at word 31, rm = ret[1000]
    return _case("tail-success", "register", 48, bits, [0, 7, 0, 5],
                 [True] * 4, (inv, ret, fop, args, rets))


def _failing_tail():
    """cas-register at the main-path size n = 8192, the worst case of the
    search past the frontier word: 7168 overlapping reads of 7, then 768
    crashed CAS 5 -> 6 and 256 crashed writes of 0 (ret INF32, early
    invoke, so always eligible). From state 0 every eligible read and CAS
    fails, so each step tests the 24 words of failing CAS before it takes
    a write at the tail, and keeps state 0; the chains wedge once the
    writes run out, after 256 steps. One chain starts past 3000 reads,
    one in state 5 (it takes a CAS first), one is dead."""
    n, m, c = 8192, 7168, 768
    inv, ret, fop, args, rets = _padded(n, 2)
    k = np.arange(m)
    inv[:m], ret[:m], rets[:m, 0] = 10 * k, 10 * k + 25, 7
    tail = np.arange(n - m)
    inv[m:] = 1 + tail % 20
    fop[m:m + c], args[m:m + c, 0], args[m:m + c, 1] = 2, 5, 6
    fop[m + c:], args[m + c:, 0] = 1, 0
    bits = np.zeros((4, n), bool)
    bits[1, :3000] = True
    return _case("failing-tail", "cas-register", 272, bits, [0, 0, 5, 0],
                 [True, True, True, False], (inv, ret, fop, args, rets))


def _wedge_mid():
    """cas-register, 200 sequential ops then padding: ten writes, a read
    of 99 that only a chain in state 99 passes, then writes and reads
    that agree. Chains wedge at step 10 and 5; one runs on; two start
    with every real op linearized (rm = INF32: the padding rows, reads
    of 0, are eligible), one in state 0, one in state 1."""
    n, m = 1024, 200
    inv, ret, fop, args, rets = _padded(n, 2)
    k = np.arange(m)
    inv[:m], ret[:m] = 10 * k, 10 * k + 5
    fop[:10], args[:10, 0] = 1, k[:10] + 1
    rets[10, 0] = 99                                  # read 99
    odd = k[11:] % 2 == 1
    fop[11:m] = np.where(odd, 1, 0)                   # write k%4 / read it
    args[11:m, 0] = np.where(odd, k[11:] % 4, 0)
    rets[11:m, 0] = np.where(odd, 0, (k[11:] - 1) % 4)
    bits = np.zeros((6, n), bool)
    bits[1, :5] = True
    bits[2, :10] = True
    bits[3:, :m] = True
    return _case("wedge-mid", "cas-register", 48, bits,
                 [NIL, 5, 99, 0, 1, 0], [True] * 5 + [False],
                 (inv, ret, fop, args, rets))


def _dense_frontier(rng, seed):
    """Real cas-register columns (n = 4096) under dense seed bitsets: the
    first 40 or 100 words full, a lone clear bit in word 3 before 36 more
    full words, every word but the last full."""
    cols = real_columns("cas-register", 3000, seed)[:5]
    n = len(cols[0])
    bits = np.zeros((4, n), bool)
    bits[0, :40 * 32] = True
    bits[0] |= rng.rand(n) < 0.2
    bits[1, :100 * 32] = True
    bits[2, :40 * 32] = True
    bits[2, 3 * 32 + 5] = False
    bits[3, :n - 32] = True
    states = rng.choice([NIL, 0, 1, 2, 3], size=4)
    return _case("dense-frontier", "cas-register", 48, bits, states,
                 [True] * 4, cols)


def _all_dead(rng, seed):
    cols = real_columns("cas-register", 600, seed)[:5]
    bits = rng.rand(4, len(cols[0])) < 0.05
    return _case("all-dead", "cas-register", 16, bits, [NIL, 0, 1, 2],
                 [False] * 4, cols)


def _n131072(rng, seed, n=131072):
    """A real 2000-op cas-register history repeated in time until it
    fills n = 131072 ops (three tree levels), re-sorted by ret as the
    priority order sorts it, then padded. Seeds: empty; the first 2000
    words full; 2% random bits; the first 2000 words full but for one
    early read that fails in the seed's state (rm stays small, so the
    search must cross the whole bitset for an eligible op); dead."""
    inv0, ret0, fop0, args0, rets0, rows, init = real_columns(
        "cas-register", 2000, seed)
    inv0, ret0 = inv0[:rows].astype(np.int64), ret0[:rows].astype(np.int64)
    span = int(max(inv0.max(), ret0[ret0 < INF32].max())) + 1
    reps = n // rows
    shift = np.repeat(np.arange(reps, dtype=np.int64) * span, rows)
    inv = np.tile(inv0, reps) + shift
    ret = np.where(np.tile(ret0, reps) < INF32, np.tile(ret0, reps) + shift,
                   INF32)
    order = np.argsort(ret, kind="stable")
    m = reps * rows
    cols = _padded(n, args0.shape[1])
    cols[0][:m], cols[1][:m] = inv[order], ret[order]
    for dst, src in zip(cols[2:], (fop0, args0, rets0)):
        dst[:m] = np.concatenate([src[:rows]] * reps)[order]
    fop, rets = cols[2], cols[4]
    lone = int(np.flatnonzero((fop[:m] == 0) & (rets[:m, 0] != NIL))[0])
    bits = np.zeros((5, n), bool)
    bits[1, :2000 * 32] = True
    bits[2] = rng.rand(n) < 0.02
    bits[3, :2000 * 32] = True
    bits[3, lone] = False
    states = [init, *rng.choice([NIL, 0, 1, 2, 3], size=2),
              rets[lone, 0] ^ 1, 0]
    return _case("n131072", "cas-register", 16, bits, states,
                 [True] * 4 + [False], cols)


#: the cases ``adversarial`` returns, in order
NAMES = ("unsorted", "tail-success", "wedge-mid", "dense-frontier",
         "all-dead", "n131072", "failing-tail")


def adversarial(seed=45100):
    """Every adversarial case, made from ``seed``."""
    rng = np.random.RandomState(seed)
    return [_unsorted(rng, seed), _tail_success(), _wedge_mid(),
            _dense_frontier(rng, seed + 1), _all_dead(rng, seed + 2),
            _n131072(rng, seed + 3), _failing_tail()]


def work(seed_lin, seed_ok, j, n):
    """What a rollout with outputs ``j`` (NS, R) from ``seed_lin`` (NS, B)
    uint32 and ``seed_ok`` (NS,) needed, as numpy ints: ``live`` steps
    (every step a chain entered alive, the wedge step included),
    ``live_max`` (the most of one chain), and ``scanned``: per live step
    the ops from the chain's frontier word (the first word with an
    unlinearized op) up to the op taken, or to n for the step that
    wedges."""
    lin = np.array(seed_lin, np.uint32)
    j = np.asarray(j)
    NS, B = lin.shape
    live = live_max = scanned = 0
    for s in range(NS):
        if not seed_ok[s]:
            continue
        f, steps = 0, 0
        for jf in j[s]:
            steps += 1
            while f < B and lin[s, f] == FULL:
                f += 1
            if jf < 0:
                scanned += n - 32 * f
                break
            scanned += int(jf) - 32 * f + 1
            lin[s, jf // 32] |= np.uint32(1 << (int(jf) % 32))
        live += steps
        live_max = max(live_max, steps)
    return {"live": live, "live_max": live_max, "scanned": scanned}
