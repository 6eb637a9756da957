"""The fold kernel's module (jepsen_tpu_torch/checker/fold_kernel.py) on
the CPU: ``fold_kernel.run`` on CPU tensors (its plain version) against
the JAX package's ``_build_fold`` (jepsen_tpu/checker/streamlin.py, run
under JAX_PLATFORMS=cpu as tests/test_torch_streamlin.py runs it) on the
cases of ``checker/fold_cases.py``: seeded register, cas-register, mutex
and multi-register-3 histories, valid and corrupted, solo (K=1) and as a
lane batch of three with a pad lane (K=4), through an overflow in the
middle of a fold, more open ops than the open-op axis and sealed slots
cleared; every carry array and scalar equal. Tolerance: equality (all
integers). Then the gate (the model alone), the scratch plan, the launch
count a CPU fold leaves alone, and the module's imports without JAX or
the JAX package. The kernel itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.checker import streamlin as jstreamlin
from jepsen_tpu_torch.checker import fold_cases, fold_kernel, streamlin
from jepsen_tpu_torch.models import queues, registers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALARS = ("status", "viol_slot", "passes", "steps", "n_live")


@pytest.fixture(scope="module")
def cases():
    return {c.name: c for c in fold_cases.cases("cpu")}


def _jax_spec(model):
    if model.startswith("multi-register"):
        return jm.multi_register_spec(fold_cases.MULTI_KEYS)
    return jm.model_spec(model)


def test_case_names(cases):
    assert tuple(cases) == fold_cases.NAMES


@pytest.mark.parametrize("name", fold_cases.NAMES)
def test_run_on_cpu_equals_jax_fold(cases, name):
    """Each lane of ``fold_kernel.run`` over the case's fold equals the
    JAX fold of the same job (solo, or the JAX lane batch), and ends in
    the case's status."""
    case = cases[name]
    before = (fold_kernel.launches, fold_kernel.plain_folds)
    out = fold_kernel.run(*streamlin.fold_inputs(case.jobs))
    assert (fold_kernel.launches, fold_kernel.plain_folds) == before
    spec = _jax_spec(case.model)
    jobs = [jstreamlin.FoldJob(spec, j.C, j.arrays, len(j))
            for j in case.jobs]
    want = ([jstreamlin.solo_fold(jobs[0])] if len(jobs) == 1
            else jstreamlin.batch_fold(jobs))
    K = out[0].shape[0]
    assert K == (1 if len(jobs) == 1 else 4)
    for k, w in enumerate(want):
        got = dict(zip(SCALARS, (int(x[k]) for x in out[4:9])))
        assert got == {s: int(w[s]) for s in SCALARS}, (k, got)
        assert np.array_equal(out[0][k].numpy().view(np.uint32),
                              np.asarray(w["lin"]))
        assert np.array_equal(out[3][k].numpy().view(np.uint32),
                              np.asarray(w["open_w"]))
        assert np.array_equal(out[1][k].numpy(), np.asarray(w["st"]))
        assert np.array_equal(out[2][k].numpy(), np.asarray(w["live"]))
    assert tuple(int(s) for s in out[4][:len(jobs)]) == case.status
    if K > len(jobs):   # the pad lane: member 0 with no events
        pad = streamlin.fold_inputs(case.jobs)[1]
        assert int(out[4][-1]) == 0 and int(out[6][-1]) == 0
        assert np.array_equal(out[2][-1].numpy(), pad["live"][0].numpy())


def test_solo_fold_goes_through_run(cases, monkeypatch):
    """``streamlin``'s folds are ``fold_kernel.run`` calls: solo once,
    and once per shape group of a batch."""
    calls = []
    real = fold_kernel.run

    def spy(*a, **kw):
        calls.append(a[1]["lin"].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(fold_kernel, "run", spy)
    streamlin.solo_fold(cases["register"].jobs[0])
    streamlin.batch_fold(cases["pad lane"].jobs)
    assert calls == [1, 4]


def test_gate_decides_on_the_model_alone():
    assert fold_kernel.gate(registers._register_step) == 0
    assert fold_kernel.gate(registers._cas_step) == 1
    assert fold_kernel.gate(fold_cases.spec_of("mutex").step) == 2
    for keys in (["x"], ["x", "y", "z"], list("abcdefgh")):
        assert fold_kernel.gate(
            registers.multi_register_spec(keys).step) == 3
    assert fold_kernel.gate(queues._fifo_step) is None
    assert fold_kernel.gate(queues._unordered_step) is None
    assert fold_kernel.gate(lambda *a: a) is None


def test_plan_layout():
    """Every part of a lane's scratch is 16-byte aligned and the parts
    do not overlap: two row heaps (bitsets, states and the four
    fingerprints of each slot), two row-to-slot orders, the seen list, the
    work list and its slots, the open ops and the global pool (two key and
    two index buffers, and h2..h4 with the pool index per entry); a
    launch's scratch is K lanes. The shared pool holds ``SMEM_POOL``
    entries, or the whole pool when it is smaller."""
    F, B, S, A, C = 8192, 8, 3, 3, 16
    p = fold_kernel.plan(F, B, S, A, C)
    P = F * (C + 1)
    sizes = {"lin0": 4 * F * B, "st0": 4 * F * S, "fp0": 16 * F,
             "lin1": 4 * F * B, "st1": 4 * F * S, "fp1": 16 * F,
             "ord0": 4 * F, "ord1": 4 * F, "alist": 4 * F,
             "worklist": 4 * F, "workslot": 4 * F,
             "ops": 4 * C * (2 + 2 * A), "key0": 4 * P, "val0": 4 * P,
             "key1": 4 * P, "val1": 4 * P, "ent": 16 * P}
    assert set(sizes) | {"lane_bytes", "smem_items"} == set(p._fields)
    spans = sorted((getattr(p, k), getattr(p, k) + n)
                   for k, n in sizes.items())
    assert all(a % 16 == 0 for a, _ in spans)
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= p.lane_bytes < spans[-1][1] + 16
    assert fold_kernel.scratch_bytes(8, F, B, S, A, C) == 8 * p.lane_bytes
    assert p.smem_items == fold_kernel.SMEM_POOL == 2048
    assert fold_kernel.plan(16, 1, 1, 2, 8).smem_items == 16 * 9


@pytest.mark.parametrize("model", ["register", "cas-register", "mutex",
                                   "multi-register-3"])
def test_incremental_fingerprint_equals_the_childs(model):
    """The kernel's candidate fingerprints (``jf_refp`` in csrc/fold.cu):
    the parent's four sums plus, for the bitset word that gains the op's
    slot and for each state word the step changes, the new word's term
    minus the old one's, mod 2^32 in ``words.mul32`` arithmetic, equal
    ``fold_kernel._fingerprints`` of the child row. Seeded parents (the
    op's slot clear, as in a work row), ops of every kind the model has
    and the model's own step for the child's state (``jf_post``'s
    counterpart)."""
    from jepsen_tpu_torch.checker import words
    from jepsen_tpu_torch.history import NIL
    from jepsen_tpu_torch.xp import TORCH
    spec = fold_cases.spec_of(model)
    rng = np.random.default_rng(45118)
    R, B = 512, 3
    S, A = (3, 3) if model.startswith("multi") else (1, spec.arg_width)
    NW = 32 * B
    vals = np.array([NIL, 0, 1, 2, 3, 7, 2**29 + 5], np.int64)
    lin = rng.integers(0, 2**32, (R, B), dtype=np.uint64).astype(np.uint32)
    st = rng.choice(vals, (R, S)).astype(np.int32)
    if model == "mutex":
        st = rng.integers(0, 2, (R, S)).astype(np.int32)
    slot = rng.integers(0, NW, R)
    f = rng.integers(0, 3 if model == "cas-register" else 2, R)
    args = rng.choice(vals, (R, A)).astype(np.int32)
    rets = rng.choice(vals, (R, A)).astype(np.int32)
    word, bit = slot // 32, (np.uint32(1) << (slot % 32).astype(np.uint32))
    lin[np.arange(R), word] &= ~bit                   # a work row lacks it
    st2, _ok = spec.step(torch.as_tensor(st.T), torch.as_tensor(f),
                         torch.as_tensor(args.T), torch.as_tensor(rets.T),
                         TORCH)
    st2 = torch.broadcast_to(torch.as_tensor(st2), (S, R)).T.to(torch.int32)
    child = lin.copy()
    child[np.arange(R), word] |= bit
    cols = fold_kernel._fingerprint_cols(B + S, "cpu")
    lin_t = torch.as_tensor(lin.view(np.int32))
    st_t = torch.as_tensor(st)
    want = fold_kernel._fingerprints(torch.as_tensor(child.view(np.int32)),
                                     st2, cols)
    got = fold_kernel._fingerprints(lin_t, st_t, cols)
    w_old = words.u32(lin_t[np.arange(R), word])
    w_new = words.u32(torch.as_tensor(child.view(np.int32))[np.arange(R),
                                                           word])
    s_old, s_new = words.u32(st_t), words.u32(st2)
    changed = 0
    for c, m in enumerate(cols):
        mw = m[torch.as_tensor(word)]
        h = got[c] + fold_kernel._mix(w_new, mw) - fold_kernel._mix(w_old,
                                                                     mw)
        for i in range(S):
            diff = s_new[:, i] != s_old[:, i]
            changed += int(diff.sum())
            h = h + torch.where(
                diff, fold_kernel._mix(s_new[:, i], m[B + i])
                - fold_kernel._mix(s_old[:, i], m[B + i]), 0)
        assert torch.equal(h & words.M32, want[c]), c
    assert changed > 0


def test_fingerprint_words_are_the_plain_folds():
    """The kernel's multipliers (one upload per fold) are the plain
    fold's four columns."""
    w = fold_kernel.fingerprint_words(11)
    cols = fold_kernel._fingerprint_cols(11, "cpu")
    assert w.dtype == np.uint32 and w.shape == (4, 11)
    for row, c in zip(w, cols):
        assert np.array_equal(row.astype(np.int64), c.numpy())


def test_cpu_fold_reads_through_the_callers_counter(cases):
    """On the CPU the plain fold's host reads go through ``read``
    (``streamlin`` counts them in ``syncs``); no launch is counted."""
    reads = []

    def read(t):
        reads.append(1)
        return t.tolist()

    before = fold_kernel.launches
    fold_kernel.run(*streamlin.fold_inputs(cases["mutex"].jobs), read=read)
    assert reads and fold_kernel.launches == before
    streamlin.syncs = 0
    streamlin.solo_fold(cases["mutex"].jobs[0])
    assert streamlin.syncs == len(reads) + 1     # + the results' read


_PROBE = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch.checker import fold_cases, fold_kernel, streamlin
leaked = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith("jax.") or m == "jepsen_tpu"
    or m.startswith("jepsen_tpu.")))
assert not leaked, leaked
print(fold_kernel.MODEL_IDS and len(fold_cases.NAMES))
"""


def test_imports_without_jax_or_jepsen_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(fold_cases.NAMES)
