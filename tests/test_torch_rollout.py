"""The port's greedy rollout (jepsen_tpu_torch/checker/rollout.py): its
plain PyTorch version equals the JAX package's Pallas kernel run in
interpret mode, bit for bit; its gate takes and refuses what it should;
the cumsum-for-OR bitset rebuild equals an explicit OR; a failed build
raises. The CUDA kernel itself runs only on a card (test_torch_cuda.py).
Tolerance: equality (all integers)."""

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
from jepsen_tpu_torch.checker import rollout, torch_wgl, words

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
