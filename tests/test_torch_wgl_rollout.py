"""The port's device search against the JAX engine, both on the CPU, where
the reference is deterministic: exact iteration counts on the 220-op
greedy-rollout trials of test_fused_pallas_rollout_matches_scan (scan
path against jax_wgl's scan, kernel path against jax_wgl's Pallas kernel
in interpret mode), and one search iteration from a JAX carry carried
across with carry_from_numpy matching the JAX iteration. Every
comparison is on integers: tolerance zero."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.analysis import certify
from jepsen_tpu.checker import jax_wgl
from jepsen_tpu.simulate import corrupt, random_history
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import torch_wgl

VC_ERRORS = {"VC001", "VC002", "VC003", "VC004", "VC005"}


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


def _certify_clean(name, hist, result):
    _, diags = certify.certify_with_diagnostics(
        jm.model_spec(name), jh.client_ops(jh.ensure_indexed(hist)),
        result, samples=0)
    bad = [d for d in diags if d.code in VC_ERRORS]
    assert not bad, [d.message for d in bad]


def _rollout_trials(name):
    """The 220-op histories of test_fused_pallas_rollout_matches_scan."""
    rng = random.Random(45100)
    for trial in range(6):
        hist = random_history(rng, name, 6, 220, 0.05)
        if trial % 2:
            hist = corrupt(rng, hist)
            for o in hist:
                if o["type"] == "ok" and o["f"] == "read" \
                        and isinstance(o.get("value"), int):
                    o["value"] = o["value"] % 4
        yield trial, hist


@pytest.mark.parametrize("name", ["cas-register", "mutex"])
def test_rollout_trials_iterations_match(name):
    """Exact iteration counts on the 220-op rollout trials: the scan path
    against jax_wgl's scan, and the kernel path (its plain version on the
    CPU) against jax_wgl's Pallas kernel in interpret mode."""
    jspec, tspec = jm.model_spec(name), tm.model_spec(name)
    engaged = 0
    for trial, hist in _rollout_trials(name):
        e, st = jspec.encode(hist)
        te, tst = tspec.encode(hist)
        n_pad = jax_wgl._bucket(len(e), 64)
        depth = 0 if n_pad <= 64 else min(1024, n_pad)
        _same_search(
            torch_wgl.check_encoded(tspec, te, tst, rollout_kernel="scan",
                                    device="cpu"),
            jax_wgl.check_encoded(jspec, e, st, rollout_kernel="scan"))
        got = torch_wgl.check_encoded(tspec, te, tst, device="cpu",
                                      rollout_kernel="kernel",
                                      rollout_depth=depth)
        _same_search(got, jax_wgl.check_encoded(
            jspec, e, st, rollout_kernel="pallas", rollout_depth=depth))
        _certify_clean(name, hist, got)
        engaged += got.get("engine") == "jax-wgl"
    assert engaged, "no trial reached the search engine"


def _carried_search(mode):
    """A cas-register search a few iterations in, as the JAX engine holds
    it, plus what both packages need to run one more iteration."""
    jspec, tspec = jm.cas_register_spec, tm.cas_register_spec
    hist = dict(_rollout_trials("cas-register"))[1]
    e, st = jspec.encode(hist)
    kind, prep = jax_wgl._prepare_search(jspec, e, st)
    assert kind == "search"
    (_, inv32, ret32, fop, args, rets, ok_words, init_state, n_pad, C, A,
     S) = prep
    B, W, O, T = jax_wgl._plan_sizes(n_pad, S, C)
    j_init, j_run = jax_wgl._build_search(
        jspec.step, 1, n_pad, B, S, C, A, W, O, T,
        rollout_kernel="pallas" if mode == "kernel" else "scan")
    jconsts = (jnp.asarray(inv32[None]), jnp.asarray(ret32[None]),
               jnp.asarray(fop[None]), jnp.asarray(args[None]),
               jnp.asarray(rets[None]), jnp.asarray(ok_words[None]),
               jnp.zeros(1, jnp.uint32))
    carry = j_run(j_init(jnp.asarray(init_state[None])), *jconsts,
                  jnp.int32(3))
    before = [np.asarray(x) for x in jax.device_get(carry)]
    after = [np.asarray(x) for x in jax.device_get(
        j_run(carry, *jconsts, jnp.int32(4)))]
    _, body, _ = torch_wgl._build_search(
        tspec.step, 1, n_pad, B, S, C, A, W, O, T, rollout_kernel=mode,
        device="cpu")
    tconsts = torch_wgl.make_consts(inv32, ret32, fop, args, rets,
                                    ok_words, "cpu")
    return before, after, body, tconsts, O


@pytest.mark.parametrize("mode", ["scan", "kernel"])
def test_body_step_from_carried_carry(mode):
    before, after, body, consts, O = _carried_search(mode)
    assert int(before[torch_wgl.IDX_STATUS][0]) == torch_wgl.RUNNING
    carry = torch_wgl.carry_from_numpy(before, "cpu")
    for a, b in zip(torch_wgl.carry_to_numpy(carry), before):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = torch_wgl.carry_to_numpy(body(carry, consts))
    for idx in (torch_wgl.IDX_STATUS, torch_wgl.IDX_TOP,
                torch_wgl.IDX_EXPLORED, torch_wgl.IDX_ITS,
                torch_wgl.IDX_BEST_DEPTH, torch_wgl.IDX_DROPPED,
                torch_wgl.IDX_TFAIL, torch_wgl.IDX_IT):
        assert np.array_equal(got[idx], after[idx]), idx
    # the live stack slots as multisets, the table's entries as sets
    top = int(after[torch_wgl.IDX_TOP][0])
    live = np.arange(top) % O

    def rows(c):
        return sorted(map(bytes, np.concatenate(
            [c[torch_wgl.IDX_BUF_LIN][0][live].view(np.uint8),
             c[torch_wgl.IDX_BUF_STATE][0][live].view(np.uint8),
             c[torch_wgl.IDX_BUF_FP][0][live].view(np.uint8)], axis=1)))
    assert rows(got) == rows(after)

    def pairs(c):
        tab = c[torch_wgl.IDX_TAB][0]
        return set(map(tuple, tab[(tab != 0).any(axis=1)].tolist()))
    assert pairs(got) == pairs(after)
    # the scatter winners follow XLA's serial order, so the arrays are
    # in fact equal, slot for slot
    for idx in range(torch_wgl.N_CARRY):
        assert np.array_equal(got[idx], after[idx]), idx
