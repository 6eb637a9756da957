"""The port's key batch (jepsen_tpu_torch/parallel/keyshard.py) against the
JAX package's (jepsen_tpu/parallel/keyshard.py), both on the CPU.

* The batched search at K=4 (three live keys salted 1-3 and one dummy
  key salted 0, sharing one claim array and one dedup table): after 1
  and after 3 iterations every carry array equals the JAX engine's, with
  no rollout (n <= 64) and with the scan rollout (n > 64); a compaction
  of that carry equals ``jnp.take`` on the JAX carry, and one more
  iteration of the compacted, widened batch matches too.
* ``check_batch_histories`` with ``chunk_iters=1`` (one iteration per
  chunk, so compaction points do not depend on the clock): per-key
  verdicts, iterations, explored counts and compactions equal the JAX
  package's for every model family, the verdicts equal the CPU oracle's,
  and every invalid key's witness certifies clean.

Every comparison is on integers: tolerance zero."""

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
from jepsen_tpu.parallel import check_batch_histories as jax_batch
from jepsen_tpu.parallel import keyshard as jks
from jepsen_tpu.simulate import corrupt, random_history
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import torch_wgl, wgl
from jepsen_tpu_torch.parallel import check_batch_encoded, \
    check_batch_histories

VC_ERRORS = {"VC001", "VC002", "VC003", "VC004", "VC005"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(name, fast=True):
    """The JAX and port specs of one model; queues with ``fast=False``
    lose their fast check, so the device search (with pad_state)
    decides."""
    js, ts = jm.model_spec(name), tm.model_spec(name)
    if not fast:
        js = dataclasses.replace(js, fast_check=None)
        ts = dataclasses.replace(ts, fast_check=None)
    return js, ts


def _histories(name="cas-register", n_keys=6, corrupt_every=3, n_ops=12,
               procs=4, crash_p=0.1, seed=45100):
    """test_keyshard.py's _histories, for any model and size."""
    rng = random.Random(seed)
    out = []
    for k in range(n_keys):
        hist = random_history(rng, name, procs, n_ops, crash_p)
        if k % corrupt_every == corrupt_every - 1:
            hist = corrupt(rng, hist)
        out.append(hist)
    return out


# ---------------------------------------------------------------------------
# the batched search at K=4, carry for carry

def _batch_inputs(jspec, hists):
    """The reference batch's padded per-key columns for three live keys
    plus one dummy key, and the shape bundle (as check_batch_encoded
    sizes it, with the stack and table kept small)."""
    pairs = [jspec.encode(h) for h in hists]
    encs = []
    for e, _ in pairs:
        inv32, ret32, okw = jax_wgl._encode_arrays(e)
        inv32, ret32 = jax_wgl._apply_prune(jspec, e, inv32, ret32)
        encs.append((inv32, ret32, okw))
    n_pad = jax_wgl._bucket(max(len(e) for e, _ in pairs), 64)
    A = jspec.arg_width
    S = max(len(st) for _, st in pairs)
    if jspec.pad_state is not None:
        S = jax_wgl._bucket(S, 2)
    C = 4
    for inv32, ret32, _ in encs:
        C = max(C, jax_wgl.max_point_concurrency(
            inv32, np.where(ret32 == jax_wgl.INF32, jh.INF_TIME,
                            ret32.astype(np.int64))))
    C = min(jax_wgl._bucket(C, 4), n_pad)
    B, W, _, _ = jax_wgl._plan_sizes(n_pad, S, C)
    cols = [jks._pad_key(e, st, jspec, n_pad, S, A, enc)
            for (e, st), enc in zip(pairs, encs)]
    cols.append(jks._dummy_key(n_pad, S, A))
    return cols, [1, 2, 3, 0], (n_pad, B, S, C, A, min(W, 32), 4096, 1 << 14)


def _jax_carry(carry):
    return [np.asarray(x) for x in jax.device_get(carry)]


def _same_carry(port_carry, want, what):
    got = torch_wgl.carry_to_numpy(port_carry)
    assert len(got) == len(want) == torch_wgl.N_CARRY
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        assert np.array_equal(a, b), (what, i)


@pytest.mark.parametrize("n_ops", [12, 90])
@pytest.mark.parametrize("name", ["cas-register", "fifo-queue"])
def test_batched_steps_at_four_keys(name, n_ops):
    jspec, tspec = _specs(name, fast=False)
    cols, salts, (n, B, S, C, A, W, O, T) = _batch_inputs(
        jspec, _histories(name, n_keys=3, n_ops=n_ops, corrupt_every=2))
    R = 0 if n <= 64 else min(256, n)
    assert (R > 0) == (n_ops > 64)
    j_init, j_run = jax_wgl._build_search(jspec.step, 4, n, B, S, C, A, W,
                                          O, T, 1, R=R, NS=1,
                                          rollout_kernel="scan")
    jconsts = tuple(jnp.asarray(np.stack([c[i] for c in cols]))
                    for i in range(6)) + (jnp.asarray(np.asarray(salts,
                                                                 np.uint32)),)
    states = np.stack([c[6] for c in cols])
    t_init, _, t_run = torch_wgl._build_search(
        tspec.step, 4, n, B, S, C, A, W, O, T, R=R, NS=1,
        rollout_kernel="scan", device="cpu")
    tconsts = torch_wgl.make_batch_consts([c[:6] for c in cols], salts,
                                          "cpu")
    jc = j_init(jnp.asarray(states))
    tc = t_init(states)
    _same_carry(tc, _jax_carry(jc), "init")
    for bound in (1, 3):
        jc = j_run(jc, *jconsts, jnp.int32(bound))
        want = _jax_carry(jc)
        tc = t_run(tc, tconsts, bound)
        _same_carry(tc, want, f"after {bound}")
    status = want[torch_wgl.IDX_STATUS]
    assert status[3] != torch_wgl.RUNNING or \
        want[torch_wgl.IDX_TOP][3] == 0, "the dummy key finishes at once"
    assert (status[:3] == torch_wgl.RUNNING).any(), "a live key still runs"

    # compaction: keep rows 2 and 0 (a repeated row pads, as the batch
    # pads with a finished row), then one more iteration at K=2 and a
    # wider frontier
    sel = [2, 0]
    tc, tconsts = torch_wgl.compact(tc, tconsts, torch.tensor(sel))
    want = [np.take(x, sel, axis=0) if i in jax_wgl.KEYED else x
            for i, x in enumerate(want)]
    _same_carry(tc, want, "compacted")
    W2 = 2 * W
    _, j_run2 = jax_wgl._build_search(jspec.step, 2, n, B, S, C, A, W2, O,
                                      T, 1, R=R, NS=1,
                                      rollout_kernel="scan")
    jconsts2 = tuple(jnp.take(c, jnp.asarray(sel), axis=0)
                     for c in jconsts)
    jc = j_run2(tuple(jnp.asarray(x) for x in want), *jconsts2,
                jnp.int32(4))
    _, _, t_run2 = torch_wgl._build_search(
        tspec.step, 2, n, B, S, C, A, W2, O, T, R=R, NS=1,
        rollout_kernel="scan", device="cpu")
    _same_carry(t_run2(tc, tconsts, 4), _jax_carry(jc), "after compaction")


def test_keyed_matches_reference():
    assert torch_wgl.KEYED == jax_wgl.KEYED


def test_batch_consts():
    """Stacked per-key columns, the uint32 salts as int64 and each key's
    ok-op count (0 for a dummy key)."""
    okw = np.array([0xFFFFFFFF, 5], np.uint32)
    col = (np.arange(64, dtype=np.int32),) * 3 + (
        np.zeros((64, 1), np.int32),) * 2 + (okw,)
    dummy = jks._dummy_key(64, 1, 1)
    consts = torch_wgl.make_batch_consts([col, dummy[:6]], [np.uint32(7), 0],
                                         "cpu")
    assert [tuple(c.shape) for c in consts] == [
        (2, 64), (2, 64), (2, 64), (2, 64, 1), (2, 64, 1), (2, 2), (2,),
        (2,)]
    assert consts[5][0].tolist() == [-1, 5]
    assert consts[6].tolist() == [7, 0] and consts[6].dtype == torch.int64
    assert consts[7].tolist() == [34, 0]


# ---------------------------------------------------------------------------
# the whole batch against the JAX package's

_KEYS = ("valid", "iterations", "configs_explored", "compactions", "engine",
         "table_load", "table_insert_failures")


def _certify_clean(jspec, hist, result):
    _, diags = certify.certify_with_diagnostics(
        jspec, jh.client_ops(jh.ensure_indexed(hist)), result, samples=0)
    bad = [d for d in diags if d.code in VC_ERRORS]
    assert not bad, [d.message for d in bad]


def _same_batch(jspec, tspec, hists, **kw):
    want = jax_batch(jspec, hists, **kw)
    got = check_batch_histories(tspec, hists, device="cpu", **kw)
    assert len(got) == len(want) == len(hists)
    for k, (g, w) in enumerate(zip(got, want)):
        for field in _KEYS:
            assert g.get(field) == w.get(field), (k, field)
        assert g["valid"] == wgl.check_history(tspec, hists[k])["valid"], k
        if g["valid"] is False:
            _certify_clean(jspec, hists[k], g)
    return got


BATCH_MODELS = [("cas-register", True), ("mutex", True),
                ("fifo-queue", False), ("unordered-queue", False),
                ("unordered-queue", True)]


@pytest.mark.parametrize("name,fast", BATCH_MODELS)
def test_batch_matches_jax(name, fast):
    """test_keyshard.py's six 12-op keys (no rollout at n <= 64)."""
    jspec, tspec = _specs(name, fast)
    got = _same_batch(jspec, tspec, _histories(name), chunk_iters=1)
    if not fast or name in ("cas-register", "mutex"):
        assert any(r.get("engine") == "jax-wgl" for r in got)


#: (ops, crash_p) per key: encoded n > 64 (mutex fails half its ops),
#: small enough for a quick CPU run
_ROLLOUT_SIZES = {"cas-register": (90, 0.05), "mutex": (150, 0.05),
                  "fifo-queue": (70, 0.0), "unordered-queue": (70, 0.0)}


@pytest.mark.parametrize("name,fast", BATCH_MODELS[:4])
def test_batch_with_rollout_matches_jax(name, fast):
    """Keys long enough for the batch's scan rollout (n > 64)."""
    jspec, tspec = _specs(name, fast)
    n_ops, crash_p = _ROLLOUT_SIZES[name]
    hists = _histories(name, n_keys=4, n_ops=n_ops, corrupt_every=2,
                       crash_p=crash_p)
    got = _same_batch(jspec, tspec, hists, chunk_iters=1)
    assert max(len(jspec.encode(h)[0]) for h in hists) > 64
    assert any(r.get("engine") == "jax-wgl" for r in got)


def test_batch_straggler_compacts():
    """Fast keys harvest and the batch compacts while a deep straggler
    keeps running (test_keyshard.py's straggler case at a CPU size)."""
    jspec, tspec = _specs("cas-register")
    rng = random.Random(45100)
    hists = [random_history(rng, "cas-register", 3, 8, 0.1)
             for _ in range(7)]
    hists.append(random_history(rng, "cas-register", 6, 60, 0.3))
    got = _same_batch(jspec, tspec, hists, chunk_iters=1)
    assert got[-1]["compactions"] >= 1


def test_batch_empty_and_trivial_keys():
    jspec, tspec = _specs("cas-register")
    hists = [[], _histories(n_keys=1)[0]]
    got = _same_batch(jspec, tspec, hists, chunk_iters=1)
    assert got[0] == {"valid": True, "configs_explored": 0}
    assert got[1]["valid"] in (True, False)
    assert check_batch_histories(tspec, [], device="cpu") == []


def test_batch_default_chunking_matches_oracle():
    """The default adaptive chunking (compaction points set by the
    clock): verdicts equal the CPU oracle's, owners are counted."""
    _, tspec = _specs("cas-register")
    hists = _histories(n_keys=5)
    got = check_batch_histories(tspec, hists, device="cpu",
                                owners=["a", "b", "a", "c", "a"])
    for k, hist in enumerate(hists):
        assert got[k]["valid"] == wgl.check_history(tspec, hist)["valid"]
        if got[k].get("engine") == "jax-wgl":
            assert got[k]["batch_owners"] == len(
                {o for o, r in zip("abaca", got)
                 if r.get("engine") == "jax-wgl"})


def test_batch_refuses_what_is_not_ported(monkeypatch, tmp_path):
    _, tspec = _specs("cas-register")
    pairs = [tspec.encode(h) for h in _histories(n_keys=2)]
    # the mesh batch is ported (tests/test_torch_keyshard_mesh.py): a
    # mesh that is not a torch DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        check_batch_encoded(tspec, pairs, mesh=object(), device="cpu")
    # checkpoint/resume is ported now (tests/test_torch_checkpoint.py): a
    # decided batch leaves no snapshot behind
    ck = tmp_path / "x.npz"
    got = check_batch_encoded(tspec, pairs, checkpoint=str(ck), device="cpu")
    assert all(r["valid"] in (True, False) for r in got)
    assert not ck.exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_batch_encoded(tspec, pairs)
