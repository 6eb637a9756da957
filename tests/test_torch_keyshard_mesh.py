"""The port's mesh key batch (``check_batch_encoded(mesh=...)``,
jepsen_tpu_torch/parallel/keyshard.py) against the JAX package's mesh
batch, at world sizes 2 and 4: the mesh cases of
``tests/test_keyshard.py`` with their seeds.

The port runs SPMD on D gloo ranks (``torch_mesh_worker.spawn``, one
spawn per world size for every job); the JAX batch runs here over the
first D of conftest's virtual CPU devices.

* five keys (not divisible by the mesh) for cas-register, mutex and
  fifo-queue with ``fast_check=None``, and 16 keys with one deep
  straggler: at ``chunk_iters=1`` (compaction points do not follow the
  clock) every key's result equals the JAX mesh batch's -- verdict,
  iterations, explored counts, compactions, table diagnostics, witness
  -- every rank returns the same results, the verdicts equal the CPU
  oracle's and every invalid key's witness certifies clean;
* checkpoint/resume under the mesh in both directions: a snapshot the
  JAX mesh batch wrote on a timeout resumes in the port's, and one the
  port wrote resumes in the JAX package's, each ending at the
  uninterrupted run's verdicts with the spent snapshot removed;
* the ``independent`` checker with ``linearizable(jax-wgl, mesh)``
  batches every key over the mesh, equal to the JAX package's;
* under a bound registry, rank 0 reports the JAX mesh batch's series
  and events (the plan, heartbeats with keys alive and running and
  compactions, the summary) and every other rank nothing.

Tolerance zero."""

import dataclasses
import os
import random

import numpy as np
import pytest

import jax

from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import models
from jepsen_tpu.analysis import certify
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu.checker import core as jcc
from jepsen_tpu.checker import wgl
from jepsen_tpu.parallel import check_batch_encoded

from test_jax_wgl import _corrupt, _random_history
import torch_mesh_worker as worker

VC_ERRORS = {"VC001", "VC002", "VC003", "VC004", "VC005"}

SIZES = (2, 4)

MODELS = ("cas-register", "mutex", "fifo-queue")


def _plain(hist):
    return [dict(o) for o in hist]


def _spec(model):
    spec = models.model_spec(model)
    return dataclasses.replace(spec, fast_check=None) \
        if model == "fifo-queue" else spec


def _five_keys(model):
    """test_batch_sharded_over_mesh(_models)'s five 12-op keys."""
    rng = random.Random(45100)
    hists = []
    for k in range(5):
        hist = _random_history(rng, model, n_procs=4, n_ops=12)
        if k % 3 == 2:
            hist = _corrupt(rng, hist)
        hists.append(hist)
    return hists


def _straggler_keys(small_ops=8, straggler_ops=120):
    """test_batch_mesh_compaction_with_straggler's 16 keys (its sizes by
    default: the rollout decides its straggler in one iteration, so at
    ``chunk_iters=1`` nothing compacts; 40-op keys and an 80-op straggler
    compact under both mesh sizes)."""
    rng = random.Random(45100)
    hists = [_random_history(rng, "cas-register", n_procs=3,
                             n_ops=small_ops) for _ in range(15)]
    hists.append(_random_history(rng, "cas-register", n_procs=6,
                                 n_ops=straggler_ops, crash_p=0.3))
    return hists


def _checkpoint_keys():
    """test_batch_checkpoint_resume_under_mesh's six keys."""
    rng = random.Random(7)
    hists = []
    for k in range(6):
        hist = _random_history(rng, "cas-register", n_procs=8, n_ops=150,
                               crash_p=0.05)
        if k % 2 == 1:
            hist = _corrupt(rng, hist)
            for o in hist:
                if o["type"] == "ok" and o["f"] == "read" \
                        and o.get("value") is not None:
                    o["value"] = o["value"] % 4
        hists.append(hist)
    return hists


def _keyed(hists, tuple_=jind.tuple_):
    """One keyed history: key k's ops carry [k v] tuples (``tuple_``;
    plain lists for the ranks, which build the port's), key after key."""
    out = []
    for k, hist in enumerate(hists):
        for o in hist:
            out.append({**dict(o), "value": tuple_(k, o.get("value")),
                        "index": len(out)})
    return out


def _jax_mesh(D):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:D]), ("search",))


CASES = [(m, _five_keys(m)) for m in MODELS] \
    + [("cas-register", _straggler_keys()),
       ("cas-register", _straggler_keys(40, 80))]
#: the outputs of the jobs after CASES
RESUMED, WRITTEN, KEYED, OBS = range(len(CASES), len(CASES) + 4)


def _jobs(D, tmp):
    jobs = [("batch", {"model": m, "hists": _plain_all(h),
                       "fast_check": m != "fifo-queue", "chunk_iters": 1})
            for m, h in CASES]
    ck = _checkpoint_keys()
    jobs += [
        # resume the JAX package's snapshot
        ("batch", {"model": "cas-register", "hists": _plain_all(ck),
                   "chunk_iters": 16,
                   "checkpoint": os.path.join(tmp, "from-jax.npz")}),
        # write one for the JAX package to resume
        ("batch", {"model": "cas-register", "hists": _plain_all(ck),
                   "timeout_s": 0, "chunk_iters": 16,
                   "checkpoint": os.path.join(tmp, "from-port.npz"),
                   "checkpoint_every_s": 0}),
        ("check", {"model": "cas-register", "independent": True,
                   "hist": _keyed(_five_keys("cas-register"),
                                  lambda k, v: [k, v]),
                   "chunk_iters": 1}),
        ("obs", {"job": "batch", "model": "cas-register",
                 "hists": _plain_all(CASES[4][1]), "chunk_iters": 1})]
    return jobs


def _plain_all(hists):
    return [_plain(h) for h in hists]


def _unclocked(x):
    """``x`` without its clock readings (the planner's ``plan_s``)."""
    if isinstance(x, dict):
        return {k: _unclocked(v) for k, v in x.items() if k != "plan_s"}
    if isinstance(x, (list, tuple)):
        return type(x)(_unclocked(v) for v in x)
    return x


@pytest.fixture(scope="module", params=SIZES)
def ranks(request, tmp_path_factory):
    """(D, the JAX package's interrupted run's results, rank 0's outputs,
    the scratch directory, every rank's outputs) for one world size."""
    D = request.param
    tmp = str(tmp_path_factory.mktemp(f"meshbatch{D}"))
    spec = models.cas_register_spec
    pairs = [spec.encode(h) for h in _checkpoint_keys()]
    interrupted = check_batch_encoded(
        spec, pairs, mesh=_jax_mesh(D), timeout_s=0, chunk_iters=16,
        checkpoint=os.path.join(tmp, "from-jax.npz"),
        checkpoint_every_s=0)
    assert os.path.exists(os.path.join(tmp, "from-jax.npz"))
    outs = worker.spawn(tmp, D, _jobs(D, tmp))
    for r in range(1, D):
        assert _unclocked(outs[r][:OBS]) == _unclocked(outs[0][:OBS]), r
        assert outs[r][OBS][0] == outs[0][OBS][0], r
    return D, interrupted, outs[0], tmp, outs


def _same(D, model, hists, got):
    spec = _spec(model)
    want = check_batch_encoded(spec, [spec.encode(h) for h in hists],
                               mesh=_jax_mesh(D), chunk_iters=1)
    assert len(got) == len(want) == len(hists)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, (model, k)
        assert g["valid"] == wgl.check_history(spec, hists[k])["valid"], k
        if g["valid"] is False and g.get("engine") == "jax-wgl":
            _, diags = certify.certify_with_diagnostics(
                spec, jh.client_ops(jh.ensure_indexed(hists[k])), g,
                samples=0)
            assert not [d for d in diags if d.code in VC_ERRORS], k
    return got


@pytest.mark.parametrize("model", MODELS)
def test_batch_sharded_over_mesh_models(ranks, model):
    """Five keys, deliberately not divisible by the mesh size, per model
    family (fifo-queue without its fast check, so the padded-state
    search decides)."""
    D, _, outs, _, _ = ranks
    got = _same(D, *CASES[MODELS.index(model)], outs[MODELS.index(model)])
    assert any(r.get("engine") == "jax-wgl" for r in got)


@pytest.mark.parametrize("case", [3, 4])
def test_batch_mesh_compaction_with_straggler(ranks, case):
    """Fast keys harvest and the batch compacts (resharding the keyed
    rows over the ranks) while a deep straggler keeps running."""
    D, _, outs, _, _ = ranks
    got = _same(D, *CASES[case], outs[case])
    if case == 4:
        assert got[-1]["compactions"] >= 1


def test_batch_checkpoint_resume_under_mesh_both_engines(ranks):
    D, interrupted, outs, tmp, _ = ranks
    spec = models.cas_register_spec
    pairs = [spec.encode(h) for h in _checkpoint_keys()]
    want = check_batch_encoded(spec, pairs, mesh=_jax_mesh(D))
    assert any(r["valid"] == "unknown" for r in interrupted)
    resumed, written = outs[RESUMED], outs[WRITTEN]
    assert [r["valid"] for r in resumed] == [r["valid"] for r in want]
    assert not os.path.exists(os.path.join(tmp, "from-jax.npz"))
    assert any(r["valid"] == "unknown" for r in written)
    ck = os.path.join(tmp, "from-port.npz")
    assert os.path.exists(ck), "snapshot written on timeout"
    again = check_batch_encoded(spec, pairs, mesh=_jax_mesh(D),
                                chunk_iters=16, checkpoint=ck)
    assert [r["valid"] for r in again] == [r["valid"] for r in want]
    assert not os.path.exists(ck), "spent snapshot removed"


def test_independent_checker_over_mesh(ranks):
    """``independent.checker(linearizable(jax-wgl, mesh))`` sends every
    key through the mesh batch: per-key results equal the JAX
    package's."""
    D, _, outs, _, _ = ranks
    got, cert = outs[KEYED]
    lin = jck.linearizable({"model": "cas-register",
                            "algorithm": "jax-wgl",
                            "engine_opts": {"mesh": _jax_mesh(D),
                                            "chunk_iters": 1}})
    want = jcc.check(jind.checker(lin), {},
                     _keyed(_five_keys("cas-register")))
    assert got["valid"] == want["valid"]
    assert got["failures"] == want["failures"]
    assert set(got["results"]) == set(want["results"])
    for k, w in want["results"].items():
        assert _unclocked(got["results"][k]) == _unclocked(w), k
    assert cert is not None and not [
        d for d in cert["diagnostics"] if d["code"] in VC_ERRORS]


def test_mesh_batch_obs_equals_jax_on_rank_0(ranks):
    from jepsen_tpu import obs as jobs
    D, _, _, _, every = ranks
    got, snap, events = every[0][OBS]
    spec = _spec("cas-register")
    test = {}
    with jobs.run_scope(test):
        want = check_batch_encoded(
            spec, [spec.encode(hh) for hh in CASES[4][1]],
            mesh=_jax_mesh(D), chunk_iters=1)
    assert got == want
    jsnap = test["obs"]["registry"].snapshot()
    assert worker.obs_series(snap) == worker.obs_series(jsnap)
    instants, spans = worker.obs_events(events)
    assert (instants, spans) == worker.obs_events(
        test["obs"]["tracer"].events())
    hb = [x for x in instants if x[0] == "wgl.heartbeat.jax-wgl-batch"]
    assert hb and max(x[2]["compactions"] for x in hb) >= 1
    for r in range(1, D):
        _, snap_r, events_r = every[r][OBS]
        assert worker.obs_series(snap_r) == {}
        assert worker.obs_events(events_r) == ([], set())
