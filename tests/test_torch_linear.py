"""The port's just-in-time linearization (jepsen_tpu_torch/checker/linear.py)
against the JAX package's (jepsen_tpu/checker/linear.py): the same
seeded histories give equal result dicts -- verdict, model steps, the
violating op and the witness fields. Tolerance: equality."""

import random

import pytest

from jepsen_tpu import models as jm
from jepsen_tpu import simulate as jsim
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import checkers, linear


def _pair(name, seed, corrupt):
    rng = random.Random(seed)
    hist = jsim.random_history(rng, name, n_procs=4, n_ops=24,
                               crash_p=0.08)
    if corrupt:
        hist = jsim.corrupt(rng, hist)
    return hist


@pytest.mark.parametrize("name", ["register", "cas-register", "mutex",
                                  "fifo-queue"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_linear_matches_jax(name, corrupt):
    seen = set()
    # crashed queue ops stay open, which makes the sweep slow: fewer seeds
    for seed in range(2 if name == "fifo-queue" else 8):
        hist = _pair(name, seed, corrupt)
        e, st = jm.model_spec(name).encode(hist)
        te, tst = tm.model_spec(name).encode(hist)
        want = jlinear.check_encoded(jm.model_spec(name), e, st)
        got = linear.check_encoded(tm.model_spec(name), te, tst)
        assert got == want, (name, seed)
        seen.add(got["valid"])
    assert seen & {True, False}


def test_budgets_match_jax():
    hist = _pair("cas-register", 3, False)
    e, st = jm.cas_register_spec.encode(hist)
    te, tst = tm.cas_register_spec.encode(hist)
    for kw in ({"max_configs": 2}, {"max_steps": 5}):
        want = jlinear.check_encoded(jm.cas_register_spec, e, st, **kw)
        got = linear.check_encoded(tm.cas_register_spec, te, tst, **kw)
        assert got == want and got["valid"] == "unknown"


def test_linear_through_the_checker():
    hist = _pair("register", 1, True)
    want = jlinear.check_history(jm.register_spec, hist)
    got = checkers.linearizable({"model": "register",
                                 "algorithm": "linear"}).check({}, hist)
    assert got["valid"] == want["valid"] and got["valid?"] == got["valid"]
    assert got.get("op") == want.get("op")
