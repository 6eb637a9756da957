"""The port on a CUDA card: the rollout kernel against its plain version,
the wrapper's checks, and the device search against the same search on
the CPU. Every test is marked ``cuda`` and skips without a card (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it runs where they are absent too:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance: equality (all integers)."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import models, simulate
from jepsen_tpu_torch.checker import rollout, torch_wgl
from jepsen_tpu_torch.history import NIL

pytestmark = pytest.mark.cuda
SPECS = ["register", "cas-register", "mutex"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel has no CPU "
                    "mode (chip_smoke.py runs it on the card)")
    return torch.device("cuda")


def _inputs(name, n_ops, NS, seed, dev):
    """Op columns of a real encoded history (with padding rows) and random
    seeds in the model's domain, two of them dead, on ``dev``."""
    spec = models.model_spec(name)
    hist = simulate.random_history(random.Random(seed), name, 8, n_ops, 0.1)
    e, st = spec.encode(hist)
    kind, prep = torch_wgl._prepare_search(spec, e, st)
    assert kind == "search"
    _, inv, ret, fop, args, rets, _, _, n_pad, _, _, S = prep
    rng = np.random.RandomState(seed)
    bits = np.zeros((NS, n_pad), bool)
    for s in range(NS):
        bits[s, :rng.randint(0, len(e))] = True
    bits |= rng.rand(NS, n_pad) < 0.02
    seed_lin = np.packbits(bits.reshape(NS, -1, 32)[:, :, ::-1], axis=-1,
                           bitorder="big").view(">u4").astype(np.uint32)
    domain = [0, 1] if name == "mutex" else [NIL, 0, 1, 2, 3]
    seed_st = rng.choice(np.array(domain, np.int32), size=(NS, S))
    seed_ok = np.ones(NS, bool)
    seed_ok[1] = seed_ok[-1] = False

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return spec, [t(seed_lin.reshape(NS, -1).view(np.int32)), t(seed_st),
                  t(seed_ok), t(inv), t(ret), t(fop), t(args), t(rets)]


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("n_ops,R", [(700, 256), (5000, 1024)])
def test_kernel_equals_plain(dev, name, n_ops, R):
    spec, xs = _inputs(name, n_ops, 8, 11 + n_ops, dev)
    before = rollout.launches
    j_k, st_k = rollout.run(spec.step, *xs, R)
    torch.cuda.synchronize()
    assert rollout.launches == before + 1
    j_p, st_p = rollout.plain(spec.step, *xs, R)
    assert torch.equal(j_k, j_p) and torch.equal(st_k, st_p)
    assert (j_k[~xs[2]] == -1).all() and (j_k >= 0).any()


def test_wrapper_refuses_bad_inputs(dev):
    spec, xs = _inputs("cas-register", 300, 4, 5, dev)
    bad = [(0, xs[0].to(torch.int64)),                 # dtype
           (3, xs[3].cpu()),                            # device
           (6, xs[6].t().contiguous().t()),             # contiguity
           (4, xs[4][:-1])]                             # shape
    for i, x in bad:
        ys = list(xs)
        ys[i] = x
        with pytest.raises((TypeError, ValueError)):
            rollout.run(spec.step, *ys, 16)
    multi = models.multi_register_spec(["x"]).step
    with pytest.raises(ValueError, match="refuses"):
        rollout.run(multi, *xs, 16)


@pytest.mark.parametrize("name", SPECS)
def test_device_search_equals_cpu_search(dev, name):
    """The search is deterministic on the card (scatter winners follow
    lane order), so verdicts, iterations and explored counts equal the
    CPU run's, and the kernel was launched."""
    spec = models.model_spec(name)
    rng = random.Random(45100)
    for trial in range(4):
        hist = simulate.random_history(rng, name, 6, 220, 0.05)
        if trial % 2:
            hist = simulate.corrupt(rng, hist)
            for o in hist:
                if o["type"] == "ok" and o["f"] == "read" \
                        and isinstance(o.get("value"), int):
                    o["value"] = o["value"] % 4
        e, st = spec.encode(hist)
        before = rollout.launches
        got = torch_wgl.check_encoded(spec, e, st)       # device=None: CUDA
        want = torch_wgl.check_encoded(spec, e, st, device="cpu",
                                       rollout_kernel="kernel")
        for k in ("valid", "iterations", "configs_explored", "engine",
                  "table_load", "table_insert_failures"):
            assert got.get(k) == want.get(k), (trial, k)
        if got.get("engine") == "jax-wgl" and got.get("iterations"):
            assert rollout.launches > before
