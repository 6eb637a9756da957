"""The port's device search (jepsen_tpu_torch/checker/torch_wgl.py) held
against the JAX engine (jepsen_tpu/checker/jax_wgl.py), both on the CPU:
equal verdicts and iteration counts on the canned and seeded histories of
tests/test_jax_wgl.py, clean certificates for every port witness, the
table diagnostics and the checker entry point (the 220-op rollout trials
and the carried-carry step are in test_torch_wgl_rollout.py). Every
comparison is on integers: tolerance zero."""

import random

import pytest
import torch

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.analysis import certify
from jepsen_tpu.checker import jax_wgl
from jepsen_tpu.simulate import corrupt, random_history
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import checkers, torch_wgl, wgl

H = jh.parse_history_edn_like
SPECS = ["register", "cas-register", "mutex"]
VC_ERRORS = {"VC001", "VC002", "VC003", "VC004", "VC005"}

# the register/cas/mutex canned histories of tests/test_jax_wgl.py
CANNED = [
    ("register", [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                  ("invoke", 0, "read", None), ("ok", 0, "read", 1)]),
    ("register", [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                  ("invoke", 0, "read", None), ("ok", 0, "read", 2)]),
    ("register", [("invoke", 0, "write", 1), ("invoke", 1, "write", 2),
                  ("ok", 0, "write", 1), ("ok", 1, "write", 2),
                  ("invoke", 2, "read", None), ("ok", 2, "read", 1),
                  ("invoke", 2, "read", None), ("ok", 2, "read", 1)]),
    ("register", [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                  ("invoke", 0, "write", 2), ("ok", 0, "write", 2),
                  ("invoke", 1, "read", None), ("ok", 1, "read", 1)]),
    ("register", [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                  ("invoke", 1, "write", 2), ("info", 1, "write", 2),
                  ("invoke", 2, "read", None), ("ok", 2, "read", 2)]),
    ("register", [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
                  ("invoke", 1, "write", 2), ("info", 1, "write", 2),
                  ("invoke", 2, "read", None), ("ok", 2, "read", 1)]),
    ("cas-register", [("invoke", 0, "write", 0), ("ok", 0, "write", 0),
                      ("invoke", 1, "cas", (0, 1)), ("ok", 1, "cas", (0, 1)),
                      ("invoke", 2, "cas", (1, 2)), ("ok", 2, "cas", (1, 2)),
                      ("invoke", 0, "read", None), ("ok", 0, "read", 2)]),
    ("mutex", [("invoke", 0, "acquire", None), ("ok", 0, "acquire", None),
               ("invoke", 1, "acquire", None), ("ok", 1, "acquire", None)]),
]


def _port(name, hist, **kw):
    return torch_wgl.check_history(tm.model_spec(name), hist, device="cpu",
                                   **kw)


def _certify_clean(name, hist, result):
    """certify_with_diagnostics finds no VC001-VC005 in a port result."""
    _, diags = certify.certify_with_diagnostics(
        jm.model_spec(name), jh.client_ops(jh.ensure_indexed(hist)),
        result, samples=0)
    bad = [d for d in diags if d.code in VC_ERRORS]
    assert not bad, [d.message for d in bad]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_search(got, want):
    assert got["valid"] == want["valid"]
    for k in ("iterations", "configs_explored", "engine", "table_load",
              "table_insert_failures"):
        assert got.get(k) == want.get(k), k


@pytest.mark.parametrize("i", range(len(CANNED)))
def test_canned_histories(i):
    name, rows = CANNED[i]
    hist = H(rows)
    got = _port(name, hist)
    _same_search(got, jax_wgl.check_history(jm.model_spec(name), hist))
    if got["valid"] is False:
        assert "op" in got
    _certify_clean(name, hist, got)


@pytest.mark.parametrize("name", SPECS)
def test_differential_random(name):
    """test_jax_wgl.py's seeded trials: same verdict as the JAX engine
    (and the oracle), same iterations, and clean certificates."""
    rng = random.Random(45100)
    for trial in range(12):
        hist = random_history(rng, name, 4, 14, 0.1)
        if trial % 2:
            hist = corrupt(rng, hist)
        got = _port(name, hist)
        _same_search(got, jax_wgl.check_history(jm.model_spec(name), hist))
        assert got["valid"] == wgl.check_history(tm.model_spec(name),
                                                 hist)["valid"]
        _certify_clean(name, hist, got)


def test_table_diagnostics_match_reference():
    """table_load / table_insert_failures are present and equal to the
    JAX engine's, on a roomy table and on a saturated 1024-slot one."""
    import dataclasses
    rng = random.Random(3)
    hist = corrupt(rng, random_history(rng, "cas-register", 8, 120, 0.05))
    jspec = dataclasses.replace(jm.cas_register_spec, fast_check=None)
    e, st = jspec.encode(hist)
    te, tst = tm.cas_register_spec.encode(hist)
    for size in (None, 1024):
        want = jax_wgl.check_encoded(jspec, e, st, table_size=size)
        got = torch_wgl.check_encoded(tm.cas_register_spec, te, tst,
                                      table_size=size, device="cpu")
        assert 0.0 <= got["table_load"] <= 1.0
        assert got["table_insert_failures"] >= 0
        _same_search(got, want)
    assert got["table_insert_failures"] > 0


def test_linearizable_checker():
    hist = H(CANNED[1][1])
    for algo in ("wgl", "linear", "jax-wgl"):
        r = checkers.linearizable(
            {"model": "register", "algorithm": algo,
             "engine_opts": {"device": "cpu"} if algo == "jax-wgl"
             else None}).check({}, hist)
        assert r["valid"] is False and r["valid?"] is False
        assert r["op"]["value"] == 2
    r = checkers.linearizable({"model": "cas-register",
                               "engine_opts": {"device": "cpu"},
                               "init-ops": [{"f": "write", "value": 0}]}) \
        .check({}, H([("invoke", 0, "cas", (0, 1)),
                      ("ok", 0, "cas", (0, 1))]))
    assert r["valid"] is True
    # "competition" is the default gate now, as in the JAX package
    r = checkers.linearizable({"model": "register",
                               "engine_opts": {"device": "cpu"}}) \
        .check({}, H(CANNED[1][1]))
    assert r["valid"] is False and r["engine"] in ("wgl", "linear",
                                                    "jax-wgl")
    checkers.join_racers()
