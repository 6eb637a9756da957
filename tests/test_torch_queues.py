"""The port's queue models (jepsen_tpu_torch/models/queues.py) against the
JAX package's (jepsen_tpu/models/queues.py), both on the CPU: the steps
batched component first under torch, and one configuration at a time
under numpy, equal the JAX steps under jnp on random states (empty, full,
all-NIL and in between); the host analyses (encode, fast checks, plan,
hint, prune) give equal outputs on seeded histories; single-key device
searches give equal verdicts and iterations with the fast check on and
off; and the rollout kernel's gate refuses both queue steps, so their
searches take the scan path, as in the JAX package. Every comparison is
on integers: tolerance zero."""

import dataclasses
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
from jepsen_tpu.history import NIL
from jepsen_tpu.models import queues as jq
from jepsen_tpu.simulate import corrupt, random_history
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import checkers, rollout, torch_wgl, wgl
from jepsen_tpu_torch.models import queues as tq
from jepsen_tpu_torch.xp import NP, TORCH

QUEUES = ["fifo-queue", "unordered-queue"]
VC_ERRORS = {"VC001", "VC002", "VC003", "VC004", "VC005"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _states(name, rng, n, C):
    """n canonical queue states of C slots: empty, full, all-NIL and
    random fills, values drawn from a small range so dequeues match."""
    out = []
    for i in range(n):
        fill = (0, C, 0, rng.randint(0, C + 1))[i % 4]
        vals = rng.randint(0, 6, size=fill).astype(np.int32)
        if name == "fifo-queue":
            st = np.full(C + 1, NIL, np.int32)
            st[0] = fill
            st[1:1 + fill] = vals
        else:
            st = np.sort(np.concatenate(
                [np.full(C - fill, NIL, np.int32), vals]))
        out.append(st)
    return np.stack(out)


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("name", QUEUES)
def test_steps_equal_jax(name, C):
    jspec, tspec = jm.model_spec(name), tm.model_spec(name)
    rng = np.random.RandomState(C + len(name))
    N = 400
    st = _states(name, rng, N, C)
    f = rng.randint(0, 2, size=N).astype(np.int32)
    vals = np.array([NIL, 0, 1, 2, 3, 4, 5], np.int32)
    a = vals[rng.randint(0, 7, size=(N, 1))]
    r = vals[rng.randint(0, 7, size=(N, 1))]
    want_st, want_ok = (np.asarray(x) for x in jax.jit(jax.vmap(
        lambda s, f_, a_, r_: jspec.step(s, f_, a_, r_, jnp)))(
            st, f, a, r))
    # component first: state (S, N), f (N,), args/ret (A, N)
    st2, ok = tspec.step(torch.from_numpy(st.T.copy()), torch.from_numpy(f),
                         torch.from_numpy(a.T.copy()),
                         torch.from_numpy(r.T.copy()), TORCH)
    assert st2.dtype == torch.int32
    assert np.array_equal(st2.numpy().T, want_st.astype(np.int32))
    assert np.array_equal(ok.numpy(), want_ok)
    # a (S, K, W, 1) state plane against (K, W, C) op planes, as the
    # search's body broadcasts them
    K, Wd, Cd = 4, 10, 10
    st4 = torch.from_numpy(st.T.copy()).reshape(-1, K, Wd, Cd)[..., :1]
    f4 = torch.from_numpy(f).reshape(K, Wd, Cd)
    a4 = torch.from_numpy(a.T.copy()).reshape(1, K, Wd, Cd)
    r4 = torch.from_numpy(r.T.copy()).reshape(1, K, Wd, Cd)
    s4, ok4 = tspec.step(st4, f4, a4, r4, TORCH)
    rows = np.repeat(np.arange(0, N, Cd), Cd)
    want4_st, want4_ok = (np.asarray(x) for x in jax.jit(jax.vmap(
        lambda s, f_, a_, r_: jspec.step(s, f_, a_, r_, jnp)))(
            st[rows], f, a, r))
    assert np.array_equal(s4.reshape(st.shape[1], N).numpy().T,
                          want4_st.astype(np.int32))
    assert np.array_equal(ok4.reshape(N).numpy(), want4_ok)
    # the host face, one configuration at a time
    for i in range(0, N, 3):
        s_np, ok_np = tspec.step(st[i], f[i], a[i], r[i], NP)
        assert bool(ok_np) == bool(want_ok[i]), i
        assert np.array_equal(np.asarray(s_np, np.int32), want_st[i]), i


def test_argmax_of_an_all_false_plane_is_zero():
    """The unordered enqueue onto a full buffer: no empty slot, argmax
    gives 0 as jnp.argmax does, and the step refuses."""
    full = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    assert TORCH.argmax(full == NIL).tolist() == [0, 0]
    assert NP.argmax(np.array([False, False])) == 0
    st, ok = tq._unordered_step(full, torch.zeros(2, dtype=torch.int32),
                                torch.full((1, 2), 9, dtype=torch.int32),
                                torch.full((1, 2), NIL, dtype=torch.int32),
                                TORCH)
    assert ok.tolist() == [False, False]


def _histories(name, seed, trials=8, n_ops=60, procs=5, crash_p=0.15):
    rng = random.Random(seed)
    for trial in range(trials):
        hist = random_history(rng, name, procs, n_ops, crash_p)
        if trial % 2:
            hist = corrupt(rng, hist)
        yield hist


def _enc_equal(a, b):
    (ea, sa), (eb, sb) = a, b
    for field in ("invoke_idx", "return_idx", "f", "args", "ret", "is_ok",
                  "process"):
        x, y = getattr(ea, field), getattr(eb, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert sa.dtype == sb.dtype and np.array_equal(sa, sb)


@pytest.mark.parametrize("name", QUEUES)
def test_host_analyses_equal_jax(name):
    jspec, tspec = jm.model_spec(name), tm.model_spec(name)
    for hist in _histories(name, 45100, trials=12, n_ops=120):
        je, tenc = jspec.encode(hist), tspec.encode(hist)
        _enc_equal(je, tenc)
        e = tenc[0]
        inv32, ret32, _ = torch_wgl._encode_arrays(e)
        if name == "fifo-queue":
            assert tq._fifo_fast_check(e, inv32, ret32) == \
                jq._fifo_fast_check(e, inv32, ret32)
            assert tq._fifo_plan(e, inv32, ret32, want_plan=True) == \
                jq._fifo_plan(e, inv32, ret32, want_plan=True)
            assert np.array_equal(tq._fifo_hint(e, inv32, ret32),
                                  jq._fifo_hint(e, inv32, ret32))
            assert np.array_equal(tq._fifo_hint_legacy(e, inv32, ret32),
                                  jq._fifo_hint_legacy(e, inv32, ret32))
        else:
            assert tq._unordered_fast_check(e, inv32, ret32) == \
                jq._unordered_fast_check(e, inv32, ret32)
        assert tq._per_value_scan(e, inv32, ret32) == \
            jq._per_value_scan(e, inv32, ret32)
        kt, kj = (tq._queue_prune(e, inv32, ret32),
                  jq._queue_prune(e, inv32, ret32))
        assert (kt is None) == (kj is None)
        assert kt is None or np.array_equal(kt, kj)
        st = tenc[1]
        assert np.array_equal(tspec.pad_state(st, 2 * len(st)),
                              jspec.pad_state(st, 2 * len(st)))
        assert tspec.decode_state(st) == jspec.decode_state(st)


@pytest.mark.parametrize("name", QUEUES)
def test_oracles_equal_jax(name):
    ops = [{"f": "enqueue", "value": 1}, {"f": "enqueue", "value": 2},
           {"f": "dequeue", "value": 2}, {"f": "dequeue", "value": 1},
           {"f": "dequeue", "value": 1}, {"f": "dequeue", "value": None}]
    a, b = jm.model_spec(name).make_oracle(), tm.model_spec(name).make_oracle()
    for op in ops:
        a2, b2 = a.step(op), b.step(op)
        assert jm.is_inconsistent(a2) == tm.is_inconsistent(b2), op
        if not tm.is_inconsistent(b2):
            a, b = a2, b2
        assert repr(a) == repr(b)


def _same_search(got, want):
    assert got["valid"] == want["valid"]
    for k in ("iterations", "configs_explored", "engine", "table_load",
              "table_insert_failures", "pattern"):
        assert got.get(k) == want.get(k), k


def _certify_clean(jspec, hist, result):
    _, diags = certify.certify_with_diagnostics(
        jspec, jh.client_ops(jh.ensure_indexed(hist)), result, samples=0)
    bad = [d for d in diags if d.code in VC_ERRORS]
    assert not bad, [d.message for d in bad]


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("name", QUEUES)
def test_check_encoded_equal_jax(name, fast):
    """Single-key searches: equal verdicts, iterations and explored
    counts with the fast check on and off (off, the device search with
    pad_state decides), the port's verdict equal to its CPU oracle's,
    and every port witness certified clean by the JAX package."""
    jspec, tspec = jm.model_spec(name), tm.model_spec(name)
    if not fast:
        jspec = dataclasses.replace(jspec, fast_check=None)
        tspec = dataclasses.replace(tspec, fast_check=None)
    searched = 0
    for i, hist in enumerate(_histories(name, 7, trials=6, n_ops=24,
                                        procs=4)):
        e, st = jspec.encode(hist)
        te, tst = tspec.encode(hist)
        got = torch_wgl.check_encoded(tspec, te, tst, device="cpu")
        _same_search(got, jax_wgl.check_encoded(jspec, e, st))
        assert got["valid"] == wgl.check_encoded(tspec, te, tst)["valid"]
        _certify_clean(jspec, hist, got)
        searched += got.get("engine") == "jax-wgl"
    assert searched or fast, "no trial reached the device search"


def test_check_encoded_with_rollout_equal_jax():
    """A fifo-queue history long enough for the greedy rollout (n > 64),
    fast check off: the scan rollout over the padded queue state, equal
    to the JAX engine's."""
    jspec = dataclasses.replace(jm.fifo_queue_spec, fast_check=None)
    tspec = dataclasses.replace(tm.fifo_queue_spec, fast_check=None)
    hist = random_history(random.Random(11), "fifo-queue", 4, 80, 0.05)
    e, st = jspec.encode(hist)
    te, tst = tspec.encode(hist)
    assert len(e) > 64
    got = torch_wgl.check_encoded(tspec, te, tst, device="cpu")
    _same_search(got, jax_wgl.check_encoded(jspec, e, st))
    assert got["valid"] is True and got["engine"] == "jax-wgl"


@pytest.mark.parametrize("name", QUEUES)
def test_linearizable_checker(name):
    """checkers.linearizable resolves the queue models, fast check on."""
    for hist in _histories(name, 3, trials=4, n_ops=150, procs=6,
                           crash_p=0.02):
        got = checkers.linearizable(
            {"model": name, "engine_opts": {"device": "cpu"}}).check({}, hist)
        want = jax_wgl.check_history(jm.model_spec(name), hist)
        assert got["valid"] == want["valid"]
        assert got["valid?"] == got["valid"]


@pytest.mark.parametrize("name", QUEUES)
def test_rollout_gate_refuses_queue_steps(name):
    """No rollout kernel for the queue steps: the gate refuses them at
    any shape, "auto" keeps the scan path and "kernel" raises."""
    spec = tm.model_spec(name)
    for S in (1, 2, 64):
        assert rollout.gate(spec.step, 8, 1024, 8192, 256, S, 1) is None
    with pytest.raises(ValueError, match="gate refuses"):
        torch_wgl._build_search(spec.step, 1, 128, 4, 2, 4, 1, 8, 1024,
                                1024, rollout_kernel="kernel", device="cpu")
