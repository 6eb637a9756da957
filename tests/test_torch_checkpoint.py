"""Checkpoint and resume in the port (``torch_wgl.check_encoded`` and
``parallel.check_batch_encoded`` with ``checkpoint=``), on the CPU:

* the eight cases of tests/test_checkpoint.py, on the port: resume after
  a timeout, a foreign snapshot ignored, a snapshot kept when the budget
  runs out, another check's snapshot left alone, the fingerprint
  covering the initial state; for the batch, resume after a timeout with
  harvested keys, a foreign snapshot ignored, a budget-exhausted
  snapshot resumed under a larger budget;
* the snapshot format is the JAX package's: a snapshot the JAX engine
  wrote after one iteration holds the carry the port computes in one
  iteration, array for array, and resumes in the port to the JAX
  engine's verdict and iteration count; a snapshot the port wrote
  resumes in the JAX engine to the same.

Tolerance zero: carries compare bit for bit, results on integers."""

import os
import random

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.checker import jax_wgl
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import simulate
from jepsen_tpu_torch.checker import torch_wgl
from jepsen_tpu_torch.parallel import check_batch_encoded

SPEC = tm.cas_register_spec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU search runs small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clamped(rng, hist):
    """Corrupt a history with its bad read kept in the written range, so
    no fast path decides it and the search must run."""
    hist = simulate.corrupt(rng, hist)
    for o in hist:
        if o["type"] == "ok" and o["f"] == "read" \
                and o.get("value") is not None:
            o["value"] = o["value"] % 4
    return hist


def _port(e, st, **kw):
    return torch_wgl.check_encoded(SPEC, e, st, device="cpu", **kw)


def test_checkpoint_resume(tmp_path):
    rng = random.Random(45100)
    e, st = SPEC.encode(simulate.random_history(rng, "cas-register", 6,
                                                120, 0.05))
    ck = str(tmp_path / "frontier.npz")
    want = _port(e, st)
    r1 = _port(e, st, chunk_iters=1, timeout_s=0, checkpoint=ck)
    assert r1["valid"] == "unknown" and r1["error"] == "timeout"
    assert r1["checkpoint"] == ck and os.path.exists(ck)
    r2 = _port(e, st, chunk_iters=1, checkpoint=ck)
    assert (r2["valid"], r2["iterations"]) \
        == (want["valid"], want["iterations"])
    assert r2["iterations"] >= r1["iterations"]
    assert not os.path.exists(ck)


def test_checkpoint_fingerprint_mismatch_ignored(tmp_path):
    rng = random.Random(45100)
    e1, st1 = SPEC.encode(simulate.random_history(rng, "cas-register", 4,
                                                  40, 0.0))
    e2, st2 = SPEC.encode(simulate.random_history(rng, "cas-register", 4,
                                                  40, 0.0))
    ck = str(tmp_path / "frontier.npz")
    _port(e1, st1, chunk_iters=1, timeout_s=0, checkpoint=ck)
    assert os.path.exists(ck)
    assert _port(e2, st2, checkpoint=ck)["valid"] in (True, False)


def test_checkpoint_kept_on_budget_exhaustion(tmp_path, cross):
    e, st = cross["port"]
    ck = str(tmp_path / "frontier.npz")
    r1 = _port(e, st, chunk_iters=1, max_configs=1, checkpoint=ck)
    assert r1["valid"] == "unknown" and r1.get("checkpoint") == ck
    assert os.path.exists(ck)
    assert _port(e, st, checkpoint=ck)["valid"] \
        == cross["port_want"]["valid"]
    assert not os.path.exists(ck)


def test_checkpoint_of_other_check_preserved(tmp_path):
    rng = random.Random(4)
    h1 = _clamped(rng, simulate.random_history(rng, "cas-register", 6, 60,
                                               0.05))
    h2 = simulate.random_history(rng, "cas-register", 4, 40, 0.0)
    (e1, st1), (e2, st2) = SPEC.encode(h1), SPEC.encode(h2)
    ck = str(tmp_path / "frontier.npz")
    _port(e1, st1, chunk_iters=1, timeout_s=0, checkpoint=ck)
    before = open(ck, "rb").read()
    assert _port(e2, st2, checkpoint=ck)["valid"] in (True, False)
    assert open(ck, "rb").read() == before
    assert _port(e1, st1, checkpoint=ck)["valid"] in (True, False)


def test_checkpoint_fingerprint_covers_init_state(tmp_path):
    rng = random.Random(4)
    e, st = SPEC.encode(simulate.random_history(rng, "cas-register", 4, 40,
                                                0.0))
    ck = str(tmp_path / "frontier.npz")
    _port(e, st, chunk_iters=1, timeout_s=0, checkpoint=ck)
    st2 = np.asarray(st).copy()
    st2[0] = st2[0] + 1
    r = _port(e, st2)
    r2 = _port(e, st2, checkpoint=str(tmp_path / "other.npz"))
    assert r2["valid"] == r["valid"]
    # the stale snapshot was not consumed by the other initial state
    assert _port(e, st2, checkpoint=ck)["valid"] == r["valid"]
    assert os.path.exists(ck)


def _batch_pairs(seed, n_keys, procs=6, ops=80):
    rng = random.Random(seed)
    pairs = []
    for k in range(n_keys):
        hist = simulate.random_history(rng, "cas-register", procs, ops, 0.05)
        pairs.append(SPEC.encode(_clamped(rng, hist) if k % 2 else hist))
    return pairs


@pytest.fixture(scope="module")
def batch4():
    """Four keys, two of them corrupted, and their uninterrupted batch
    run at one iteration per chunk (it compacts once)."""
    pairs = _batch_pairs(7, 4)
    return pairs, check_batch_encoded(SPEC, pairs, chunk_iters=1,
                                      device="cpu")


def test_batch_checkpoint_resume(tmp_path, batch4):
    """A timed-out batch leaves a snapshot with the alive map and the
    harvested keys; a rerun resumes and decides as an uncheckpointed
    run, and removes the spent snapshot."""
    pairs, want = batch4
    ck = str(tmp_path / "batch.npz")
    r1 = check_batch_encoded(SPEC, pairs, timeout_s=0, chunk_iters=16,
                             checkpoint=ck, checkpoint_every_s=0,
                             device="cpu")
    assert os.path.exists(ck) and any(r["valid"] == "unknown" for r in r1)
    with np.load(ck) as data:
        assert {"alive", "hkeys", "it"} <= set(data.files)
    r2 = check_batch_encoded(SPEC, pairs, chunk_iters=16, checkpoint=ck,
                             device="cpu")
    assert [r["valid"] for r in r2] == [r["valid"] for r in want]
    assert not os.path.exists(ck)


def test_batch_checkpoint_resumes_after_compaction(tmp_path, batch4):
    """A snapshot taken after a compaction (a narrower batch with the
    harvested keys' verdicts) resumes to the verdicts and iteration
    counts of an uninterrupted run at the same chunk length."""
    pairs, want = batch4
    ck = str(tmp_path / "batch.npz")
    assert max(r.get("compactions", 0) for r in want) >= 1
    budget = 6000   # about 5 iterations: after the compaction at the 1st
    r1 = check_batch_encoded(SPEC, pairs, chunk_iters=1, checkpoint=ck,
                             max_configs=budget, device="cpu")
    with np.load(ck) as data:
        resumed_width = len(data["alive"])
    r2 = check_batch_encoded(SPEC, pairs, chunk_iters=1, checkpoint=ck,
                             device="cpu")
    fields = ("valid", "iterations", "configs_explored")
    assert [[r.get(f) for f in fields] for r in r2] \
        == [[r.get(f) for f in fields] for r in want]
    assert any(r["valid"] == "unknown" for r in r1)
    assert resumed_width < len(pairs) and not os.path.exists(ck)


def test_batch_checkpoint_foreign_snapshot_ignored(tmp_path):
    rng = random.Random(9)
    p1 = [SPEC.encode(simulate.random_history(rng, "cas-register", 4, 60,
                                              0.05))]
    p2 = [SPEC.encode(simulate.random_history(rng, "cas-register", 4, 60,
                                              0.05))]
    ck = str(tmp_path / "batch.npz")
    check_batch_encoded(SPEC, p1, timeout_s=0, chunk_iters=1,
                        checkpoint=ck, device="cpu")
    r = check_batch_encoded(SPEC, p2, checkpoint=ck, device="cpu")
    assert r[0]["valid"] in (True, False, "unknown")


def test_batch_checkpoint_survives_budget_change(tmp_path):
    rng = random.Random(11)
    pairs = [SPEC.encode(_clamped(rng, simulate.random_history(
        rng, "cas-register", 6, 80, 0.05)))]
    ck = str(tmp_path / "batch.npz")
    r1 = check_batch_encoded(SPEC, pairs, max_configs=64, chunk_iters=1,
                             checkpoint=ck, device="cpu")
    assert r1[0]["valid"] == "unknown" and os.path.exists(ck)
    r2 = check_batch_encoded(SPEC, pairs, checkpoint=ck, device="cpu")
    assert r2[0]["valid"] in (True, False)
    assert not os.path.exists(ck)


@pytest.fixture(scope="module")
def cross():
    """A corrupted history the search needs several iterations for,
    encoded for both packages, with each engine's uninterrupted run at
    one iteration per chunk."""
    rng = random.Random(2)
    hist = _clamped(rng, simulate.random_history(rng, "cas-register", 6,
                                                 120, 0.05))
    (je, jst), (e, st) = jm.cas_register_spec.encode(hist), \
        SPEC.encode(hist)
    return {"jax": (je, jst), "port": (e, st),
            "jax_want": jax_wgl.check_encoded(jm.cas_register_spec, je,
                                              jst, chunk_iters=1),
            "port_want": _port(e, st, chunk_iters=1)}


def test_jax_snapshot_resumes_in_port(tmp_path, cross):
    (je, jst), (e, st) = cross["jax"], cross["port"]
    want = cross["jax_want"]
    ck = str(tmp_path / "jax.npz")
    r1 = jax_wgl.check_encoded(jm.cas_register_spec, je, jst,
                               chunk_iters=1, max_configs=1, checkpoint=ck)
    assert r1["valid"] == "unknown" and r1["iterations"] == 1
    assert want["iterations"] > 1
    # the JAX snapshot holds the carry the port computes in 1 iteration
    one = torch_wgl.check_encoded(SPEC, e, st, chunk_iters=1,
                                  max_configs=1, device="cpu",
                                  checkpoint=str(tmp_path / "port.npz"))
    assert one["iterations"] == 1
    with np.load(ck) as a, np.load(tmp_path / "port.npz") as b:
        assert a.files == b.files
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert np.array_equal(a[name], b[name]), name
    got = _port(e, st, chunk_iters=1, checkpoint=ck)
    assert (got["valid"], got["iterations"], got["configs_explored"]) \
        == (want["valid"], want["iterations"], want["configs_explored"])
    assert not os.path.exists(ck)      # the fingerprint matched: spent


def test_port_snapshot_resumes_in_jax(tmp_path, cross):
    (je, jst), (e, st) = cross["jax"], cross["port"]
    want = cross["port_want"]
    assert (want["valid"], want["iterations"]) \
        == (cross["jax_want"]["valid"], cross["jax_want"]["iterations"])
    ck = str(tmp_path / "port.npz")
    r1 = _port(e, st, chunk_iters=1, max_configs=1, checkpoint=ck)
    assert r1["valid"] == "unknown" and os.path.exists(ck)
    got = jax_wgl.check_encoded(jm.cas_register_spec, je, jst,
                                chunk_iters=1, checkpoint=ck)
    assert (got["valid"], got["iterations"], got["configs_explored"]) \
        == (want["valid"], want["iterations"], want["configs_explored"])
    assert not os.path.exists(ck)
