"""The port's greedy rollout (jepsen_tpu_torch/checker/rollout.py): its
plain PyTorch version equals the JAX package's Pallas kernel run in
interpret mode, bit for bit, on real histories and on the adversarial
cases of rollout_cases.py; its gate takes and refuses what it should;
its launch plan keeps data where it fits; the cumsum-for-OR bitset
rebuild equals an explicit OR; a failed build raises. The CUDA kernel
itself runs only on a card (test_torch_cuda.py). Tolerance: equality
(all integers)."""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import models as jm
from jepsen_tpu.checker import pallas_rollout
from jepsen_tpu_torch import _build
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import simulate
from jepsen_tpu_torch.history import NIL
from jepsen_tpu_torch.checker import rollout, rollout_cases, torch_wgl, words

SPECS = ["register", "cas-register", "mutex"]


def _inputs(name, n_ops, NS, seed):
    """Op columns of a real encoded history (padded to a pow-2 bucket, so
    padding rows are present) and random seeds, some dead."""
    spec = tm.model_spec(name)
    hist = simulate.random_history(random.Random(seed), name, 6, n_ops, 0.1)
    e, st = spec.encode(hist)
    kind, prep = torch_wgl._prepare_search(spec, e, st)
    assert kind == "search"
    _, inv, ret, fop, args, rets, _, _, n_pad, _, A, S = prep
    assert n_pad > len(e)                       # padding rows present
    rng = np.random.RandomState(seed)
    B = n_pad // 32
    # seeds: a random prefix of the priority order linearized (plus some
    # random bits), random states; seed 1 and the last are dead
    seed_lin = np.zeros((NS, B), np.uint32)
    for s in range(NS):
        k = rng.randint(0, len(e))
        bits = np.zeros(n_pad, bool)
        bits[:k] = True
        bits[rng.rand(n_pad) < 0.02] = True
        for i in np.flatnonzero(bits):
            seed_lin[s, i // 32] |= np.uint32(1) << np.uint32(i % 32)
    domain = [0, 1] if name == "mutex" else [NIL, 0, 1, 2, 3]
    seed_st = rng.choice(np.array(domain, np.int32), size=(NS, S))
    seed_ok = np.ones(NS, bool)
    seed_ok[1] = seed_ok[-1] = False
    return spec, (seed_lin, seed_st, seed_ok, inv, ret, fop, args, rets), \
        (n_pad, B, S, A)


@pytest.mark.parametrize("name,n_ops,R", [
    ("register", 150, 40), ("cas-register", 150, 40), ("mutex", 150, 40),
    ("cas-register", 700, 24)])
def test_plain_equals_pallas_interpret(name, n_ops, R):
    NS = 4
    spec, cols, (n, B, S, A) = _inputs(name, n_ops, NS, 45100 + n_ops)
    seed_lin, seed_st, seed_ok, inv, ret, fop, args, rets = cols
    built = pallas_rollout.build_fused_rollout(
        jm.model_spec(name).step, NS, R, n, B, S, A, interpret=True)
    assert built is not None
    prep, run = built
    j_want, st_want = run(jnp.asarray(seed_lin), jnp.asarray(seed_st),
                          jnp.asarray(seed_ok),
                          *prep(*(jnp.asarray(x) for x in
                                  (inv, ret, fop, args, rets))))
    t = torch.from_numpy
    j, st = rollout.run(spec.step, t(seed_lin.view(np.int32)), t(seed_st),
                        t(seed_ok), t(inv), t(ret), t(fop), t(args),
                        t(rets), R)
    assert np.array_equal(j.numpy(), np.asarray(j_want))
    assert np.array_equal(st.numpy(), np.asarray(st_want))
    assert (j.numpy()[~seed_ok] == -1).all()
    assert (j.numpy() >= 0).any()               # some chain did move


@pytest.fixture(scope="module")
def adversarial():
    return {c.name: c for c in rollout_cases.adversarial()}


@pytest.mark.parametrize("name", rollout_cases.NAMES)
def test_plain_equals_pallas_interpret_adversarial(adversarial, name):
    """Ops not sorted by ret, a success only at the tail, chains that
    wedge mid-launch, dense seeds, all seeds dead, n = 131072."""
    c = adversarial[name]
    NS, B = c.seed_lin.shape
    n, A = c.args.shape
    built = pallas_rollout.build_fused_rollout(
        jm.model_spec(c.model).step, NS, c.R, n, B, 1, A, interpret=True)
    assert built is not None
    prep, run = built
    j_want, st_want = run(jnp.asarray(c.seed_lin), jnp.asarray(c.seed_st),
                          jnp.asarray(c.seed_ok),
                          *prep(*(jnp.asarray(x) for x in
                                  (c.invoke, c.ret, c.fop, c.args,
                                   c.rets))))
    j, st = rollout.run(c.step, *c.tensors(), c.R)
    assert np.array_equal(j.numpy(), np.asarray(j_want))
    assert np.array_equal(st.numpy(), np.asarray(st_want))
    assert (j.numpy()[~c.seed_ok] == -1).all()
    if c.seed_ok.any():
        assert (j.numpy() >= 0).any()


def test_adversarial_cases_reach_their_paths(adversarial):
    """Each case exercises what its name says (plain version, which the
    test above holds equal to the reference)."""
    def roll(c):
        return rollout.plain(c.step, *c.tensors(), c.R)[0].numpy()
    c = adversarial["unsorted"]
    assert (np.diff(c.ret[c.ret < rollout.INF32]) < 0).any()
    j = roll(adversarial["tail-success"])
    assert j[0, 0] == 2047 and j[2, 0] == 2047 and j[3, 0] == 2040
    j = roll(adversarial["wedge-mid"])
    assert (j[0, 10:] == -1).all() and (j[0, :10] >= 0).all()
    assert (j[1, 5:] == -1).all() and (j[2] >= 0).all()
    assert j[3, 0] == 200 and (j[4] == -1).all()
    c = adversarial["dense-frontier"]
    assert (c.seed_lin[:, :3] == rollout_cases.FULL).all()
    assert not c.seed_ok.any() or roll(c).max() >= 32 * 3
    assert not adversarial["all-dead"].seed_ok.any()
    c = adversarial["n131072"]
    assert len(c.invoke) == 131072
    assert len(rollout.tree_sizes(c.seed_lin.shape[1])) == 3
    j = roll(c)
    assert (j[3] == -1).all() and (j[1] >= 64000).all()
    c = adversarial["failing-tail"]
    j = roll(c)
    assert (j[:2, :256] >= 7936).all() and (j[:2, 256:] == -1).all()
    assert j[2, 0] == 7168 and (j[2, 1:257] >= 7936).all()
    assert (j[3] == -1).all()
    # every live step looked past the 24 words of failing CAS
    assert rollout_cases.work(c.seed_lin, c.seed_ok, j, 8192)["scanned"] \
        > 769 * 24 * 32


def test_plan():
    """Shared memory holds what fits: at n=8192 the op columns, the
    packed fields and the chain's state; from n=16384 to n=131072 only
    the chain's state; at n=2^20 nothing (state in global scratch).
    Misaligned columns are not staged. The layout the kernel reads
    follows the plan."""
    assert rollout.tree_sizes(256) == [256, 8]
    assert rollout.tree_sizes(4096) == [4096, 128, 4]
    # the largest B the gate takes needs the kernel's 4 levels, no more
    big = rollout.SMEM_BUDGET // 4
    assert rollout.gate(tm.model_spec("cas-register").step, 8, 1024,
                        32 * big, big, 1, 2) == 1
    assert len(rollout.tree_sizes(big)) == 4
    assert rollout.state_bytes(256) == 8 * (256 + 32) + 4 * 256
    assert rollout.state_bytes(4096) == 8 * (4096 + 128 + 32) + 4 * 4096
    p = rollout.plan(8, 8192, 256)
    assert (p.staged, p.state_smem, p.scratch) == (True, True, 0)
    assert p.smem == 16 + 24 * 8192 + rollout.state_bytes(256)
    assert (p.ops_off, p.state_off) == (16 + 8 * 8192, 16 + 24 * 8192)
    assert not rollout.plan(8, 8192, 256, aligned=False).staged
    for n in (16384, 1 << 17):
        p = rollout.plan(8, n, n // 32)
        assert (p.staged, p.state_smem, p.state_off) == (False, True, 0)
        assert p.smem == rollout.state_bytes(n // 32) <= rollout.SMEM_BUDGET
    p = rollout.plan(8, 1 << 20, 1 << 15)
    assert (p.staged, p.state_smem, p.smem) == (False, False, 0)
    assert p.scratch == 8 * rollout.state_bytes(1 << 15)
    lay = rollout._layout(4096, rollout.plan(8, 1 << 17, 1 << 12))
    assert list(lay.size) == [4096, 128, 4, 0]
    assert list(lay.pad) == [4096, 128, 32, 0]
    assert list(lay.off) == [0, 4096, 4224, 0]
    assert lay.lin_off == 8 * 4256
    assert lay.state_bytes == rollout.state_bytes(4096)


def test_work_counts_from_the_frontier_word():
    """Live steps, the longest chain, and the ops from each step's
    frontier word to the op taken (to n for the step that wedges)."""
    n = 128
    bits = np.zeros((3, n), bool)
    bits[0, :40] = True                  # frontier word 1
    lin = rollout_cases.pack(bits)
    j = np.array([[40, 70, -1, -1],      # 40-32+1, 70-32+1, 128-32
                  [0, 1, 2, 3],          # 1+2+3+4, all live
                  [5, 6, 7, 8]])         # dead seed: not counted
    w = rollout_cases.work(lin, np.array([True, True, False]), j, n)
    assert w == {"live": 7, "live_max": 4,
                 "scanned": 9 + 39 + 96 + 1 + 2 + 3 + 4}


def test_gate():
    reg, cas, mutex = (tm.model_spec(m).step for m in SPECS)
    # the shapes test_fused_pallas_gates_off_big_states takes and refuses
    assert rollout.gate(cas, 8, 256, 8192, 256, 1, 2) == 1
    assert rollout.gate(reg, 8, 1024, 8192, 256, 1, 1) == 0
    assert rollout.gate(mutex, 8, 1024, 8192, 256, 1, 1) == 2
    assert rollout.gate(cas, 8, 256, 8192, 256, 8192, 1) is None  # big S
    assert rollout.gate(cas, 8, 256, 8192, 256, 4, 1) is None
    # no kernel step: the multi-register (and any other model)
    multi = tm.multi_register_spec(["x", "y"]).step
    assert rollout.gate(multi, 8, 256, 8192, 256, 1, 2) is None
    # shape: n % 32, B == n / 32, shared memory
    assert rollout.gate(cas, 8, 256, 8200, 257, 1, 2) is None
    assert rollout.gate(cas, 8, 256, 8192, 255, 1, 2) is None
    assert rollout.gate(cas, 8, 1024, 1 << 17, 1 << 12, 1, 2) == 1
    assert rollout.gate(cas, 8, 1024, 1 << 21, 1 << 16, 1, 2) is None


def test_kernel_mode_raises_when_the_gate_refuses():
    spec = tm.multi_register_spec(["x", "y"])
    with pytest.raises(ValueError, match="gate refuses"):
        torch_wgl._build_search(spec.step, 1, 256, 8, 2, 8, 2, 64, 4096,
                                1024, rollout_kernel="kernel",
                                device="cpu")


def test_cumsum_rebuild_equals_explicit_or():
    NS = 4
    spec, cols, (n, B, S, A) = _inputs("cas-register", 300, NS, 7)
    t = torch.from_numpy
    seed_lin = t(cols[0].view(np.int32))
    j, _ = rollout.plain(spec.step, seed_lin, t(cols[1]), t(cols[2]),
                         *(t(x) for x in cols[3:]), 64)
    after, before = rollout.chain_bitsets(seed_lin, j)
    lin = words.u32(seed_lin).numpy().copy()
    for step in range(j.shape[1]):
        assert np.array_equal(before[:, step].numpy(), lin)
        for s in range(NS):
            i = int(j[s, step])
            if i >= 0:
                assert not (lin[s, i // 32] >> (i % 32)) & 1
                lin[s, i // 32] |= 1 << (i % 32)
        assert np.array_equal(after[:, step].numpy(), lin)


def test_wrapper_runs_plain_on_cpu_without_counting():
    spec, cols, _ = _inputs("mutex", 150, 2, 3)
    t = torch.from_numpy
    before = rollout.launches
    rollout.run(spec.step, t(cols[0].view(np.int32)), t(cols[1]),
                t(cols[2]), *(t(x) for x in cols[3:]), 8)
    assert rollout.launches == before


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "SOURCES", {"broken": "rollout.cu"})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(_build.BuildError, match="nvcc failed"):
        _build.library("broken")
    # an outside source (an earlier kernel to time against) builds the same way
    with pytest.raises(_build.BuildError, match="nvcc failed on rollout.cu"):
        _build.library_of(os.path.join(_build.CSRC, "rollout.cu"))
