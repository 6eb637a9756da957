"""The port's sharded single search (jepsen_tpu_torch/parallel/
searchshard.py) against the JAX package's (jepsen_tpu/parallel/
searchshard.py), at world sizes 2 and 4.

The port runs SPMD: ``torch_mesh_worker.spawn`` starts D gloo ranks over
a ``FileStore``, each with a 1-D "cpu" ``DeviceMesh``, and every job of a
world size rides one spawn. The JAX engine runs here, over the first D of
conftest's virtual CPU devices. The cases are ``tests/test_searchshard.py``'s
five, with its seeds:

* verdicts, ``configs_explored``, ``iterations``, ``shard_explored``,
  table diagnostics and witnesses equal the JAX engine's on every
  history, every rank returns the same result, the verdicts equal the
  CPU oracle's, and every witness certifies with no VC001-VC005;
* seed 11's exhaustion-sized history spreads work beyond rank 0 through
  the steal ring, and at D=2 the carry after iterations 1 and 3 equals
  the JAX sharded carry (the chunk built as ``searchshard.py:99-107``
  builds it);
* the public gate (``linearizable`` with ``engine_opts["mesh"]`` under
  ``core.check``), ``timeout_s=0`` (unknown/timeout on every rank), and
  the refusals: a 2-D mesh, a device the mesh does not name, a mesh
  under another algorithm;
* under a bound registry at ``chunk_iters=1``, rank 0 reports the JAX
  sharded engine's series and events (heartbeats with ``shard_tops``,
  the plan, the summary with ``shard_explored``, ``wgl.phase_s`` by
  phase) and every other rank reports nothing.

Every comparison is on integers and dicts: tolerance zero."""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jepsen_tpu import history as jh
from jepsen_tpu import models
from jepsen_tpu.analysis import certify
from jepsen_tpu.checker import jax_wgl, wgl
from jepsen_tpu.parallel import check_encoded_sharded
from jepsen_tpu.parallel import keyshard as jks
from jepsen_tpu.simulate import corrupt, random_history

import torch_mesh_worker as worker

VC_ERRORS = {"VC001", "VC002", "VC003", "VC004", "VC005"}

SIZES = (2, 4)


def _inrange(hist):
    for o in hist:
        if o["type"] == "ok" and o["f"] == "read" \
                and isinstance(o.get("value"), int):
            o["value"] = o["value"] % 4
    return hist


def _matches_histories():
    """test_sharded_matches_single_device_verdicts's six trials."""
    rng = random.Random(45100)
    out = []
    for trial in range(6):
        hist = random_history(rng, "cas-register", n_procs=6, n_ops=160,
                              crash_p=0.05)
        if trial % 2:
            hist = _inrange(corrupt(rng, hist))
        out.append(hist)
    return out


def _steal_history():
    """The steal and timeout tests' seed: hundreds of iterations."""
    rng = random.Random(11)
    return _inrange(corrupt(rng, random_history(
        rng, "cas-register", n_procs=10, n_ops=300, crash_p=0.1)))


def _model_histories():
    """test_sharded_mutex_and_register's four histories."""
    rng = random.Random(7)
    out = []
    for name in ("mutex", "register"):
        for trial in range(2):
            hist = random_history(rng, name, n_procs=6, n_ops=120,
                                  crash_p=0.05)
            if trial:
                hist = _inrange(corrupt(rng, hist))
            out.append((name, hist))
    return out


_INV, _OK = jh.invoke_op, jh.ok_op
GOOD = [_INV(0, "write", 1), _OK(0, "write", 1),
        _INV(1, "read"), _OK(1, "read", 1)]
BAD = [_INV(0, "write", 1), _OK(0, "write", 1),
       _INV(1, "read"), _OK(1, "read", 2),
       _INV(0, "write", 2), _OK(0, "write", 2)]

CASES = ([("cas-register", h) for h in _matches_histories()]
         + _model_histories() + [("cas-register", _steal_history())])
STEAL = len(CASES) - 1


def _plain(hist):
    """Plain dicts: the ranks import nothing of the JAX package."""
    return [dict(o) for o in hist]


def _obs_budget(D):
    """``max_configs`` stopping the steal history's sharded search after
    OBS_ITERS iterations on D ranks."""
    spec = models.cas_register_spec
    prep = jax_wgl._prepare_search(spec, *spec.encode(CASES[STEAL][1]))[1]
    W = jax_wgl._plan_sizes(prep[8], prep[11], prep[9])[1]
    return OBS_ITERS * W * D


#: iterations of the bound (obs) run
OBS_ITERS = 4


def _jobs(D):
    jobs = [("sharded", {"model": m, "hist": _plain(h)}) for m, h in CASES]
    steal = _plain(CASES[STEAL][1])
    jobs += [("check", {"model": "cas-register", "hist": _plain(GOOD)}),
             ("check", {"model": "cas-register", "hist": _plain(BAD)}),
             ("sharded", {"model": "cas-register", "hist": steal,
                          "timeout_s": 0, "chunk_iters": 1}),
             ("refusals", {}),
             ("obs", {"job": "sharded", "model": "cas-register",
                      "hist": steal, "chunk_iters": 1,
                      "max_configs": _obs_budget(D)})]
    if D == 2:
        jobs.append(("carries", {"model": "cas-register", "hist": steal,
                                 "bounds": (1, 3)}))
    return jobs


@pytest.fixture(scope="module", params=SIZES)
def ranks(request, tmp_path_factory):
    """(D, every rank's job outputs) for one world size; every rank must
    return the same outputs (the carries are each rank's own)."""
    D = request.param
    outs = worker.spawn(tmp_path_factory.mktemp(f"mesh{D}"), D, _jobs(D))
    n_same = len(CASES) + 4
    for r in range(1, D):
        assert outs[r][:n_same] == outs[0][:n_same], r
    return D, outs


def _jax_mesh(D):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:D]), ("search",))


def _certify_clean(spec, hist, result):
    _, diags = certify.certify_with_diagnostics(
        spec, jh.client_ops(jh.ensure_indexed(hist)), result, samples=0)
    bad = [d for d in diags if d.code in VC_ERRORS]
    assert not bad, [d.message for d in bad]


def _same(D, model, hist, got):
    spec = models.model_spec(model)
    e, st = spec.encode(hist)
    want = check_encoded_sharded(spec, e, st, _jax_mesh(D))
    assert got == want
    assert got["valid"] == wgl.check_encoded(spec, e, st)["valid"]
    if got.get("engine") == "jax-wgl-sharded":
        _certify_clean(spec, hist, got)
    return want


def test_sharded_matches_single_device_verdicts(ranks):
    D, outs = ranks
    decided_invalid = 0
    for i in range(6):
        got = outs[0][i]
        _same(D, *CASES[i], got)
        if got["valid"] is False:
            decided_invalid += 1
            assert got["configs"], i
    assert decided_invalid, "no exhaustion proof exercised"


def test_sharded_steal_spreads_work(ranks):
    D, outs = ranks
    got = outs[0][STEAL]
    assert got["iterations"] > 100, "history too easy to exercise sharding"
    _same(D, *CASES[STEAL], got)
    assert got["engine"] == "jax-wgl-sharded" and got["shards"] == D
    busy = [x for x in got["shard_explored"] if x > 0]
    assert len(busy) == D, got["shard_explored"]


def test_sharded_mutex_and_register(ranks):
    D, outs = ranks
    for i in range(6, STEAL):
        _same(D, *CASES[i], outs[0][i])


def test_sharded_via_linearizable_checker(ranks):
    """``core.check`` of ``linearizable(jax-wgl, mesh)`` runs the
    sharded search unplanned; its certificate is clean."""
    D, outs = ranks
    (good, gcert), (bad, bcert) = outs[0][len(CASES):len(CASES) + 2]
    assert good["valid"] is True and bad["valid"] is False
    for r, cert, hist in ((good, gcert, GOOD), (bad, bcert, BAD)):
        assert cert["verdict"] is r["valid"]
        assert not [d for d in cert["diagnostics"]
                    if d["code"] in VC_ERRORS]
        jr = dict(r)
        jr.pop("valid?")
        spec = models.cas_register_spec
        e, st = spec.encode(jh.client_ops(jh.ensure_indexed(
            [dict(o) for o in hist])))
        want = check_encoded_sharded(spec, e, st, _jax_mesh(D))
        assert {k: v for k, v in jr.items() if k in want} == want


def test_sharded_timeout_returns_unknown(ranks):
    _, outs = ranks
    r = outs[0][len(CASES) + 2]
    assert r["valid"] == "unknown" and r["error"] == "timeout"
    assert r["engine"] == "jax-wgl-sharded"


def test_mesh_refusals(ranks):
    """A 2-D mesh (the reference silently takes its first axis), a
    device the mesh does not name, and a mesh under "competition" are
    refused with ValueError."""
    _, outs = ranks
    two_d, two_d_batch, device, algorithm = outs[0][len(CASES) + 3]
    for err in (two_d, two_d_batch):
        assert err[0] == "ValueError" and "1-D" in err[1], err
    assert device[0] == "ValueError" and "disagrees" in device[1]
    assert algorithm[0] == "ValueError" and "jax-wgl" in algorithm[1]


@pytest.mark.parametrize("ranks", [2], indirect=True)
def test_sharded_carry_equals_jax_after_1_and_3(ranks):
    """At D=2 the port's carry after iterations 1 and 3 (every rank's,
    concatenated) equals the JAX sharded carry, array for array."""
    D, outs = ranks
    per_rank = [o[-1] for o in outs]
    spec = models.cas_register_spec
    e, st = spec.encode(CASES[STEAL][1])
    (_, inv32, ret32, fop, args, rets, ok_words, st, n_pad, C, A,
     S) = jax_wgl._prepare_search(spec, e, st)[1]
    B, W, O, T = jax_wgl._plan_sizes(n_pad, S, C)
    mesh = _jax_mesh(D)
    # searchshard.py:99-107
    _, run_local = jax_wgl._build_search(
        spec.step, 1, n_pad, B, S, C, A, W, O, T, 1,
        rollout_kernel="scan", axis_name="search", axis_size=D, steal=16)
    carry_specs, const_specs = jks._shard_specs(mesh)
    run_b = jax.jit(jks.shard_map_compat(
        run_local.__wrapped__, mesh, (carry_specs,) + const_specs,
        carry_specs), donate_argnums=(0,))
    init_carry, _ = jax_wgl._build_search(
        spec.step, D, n_pad, B, S, C, A, W, O, T, D, rollout_kernel="scan")
    carry = [np.asarray(x) for x in jax.device_get(init_carry(
        jnp.asarray(np.tile(st[None], (D, 1)))))]
    top0 = np.zeros(D, np.int32)
    top0[0] = 1
    carry[jax_wgl.IDX_TOP] = top0
    from jax.sharding import NamedSharding, PartitionSpec as P
    shd = NamedSharding(mesh, P("search"))
    carry = tuple(jax.device_put(x, shd) for x in carry)
    consts = tuple(
        jax.device_put(jnp.asarray(np.tile(col[None], (D,) + (1,) *
                                           col.ndim)), shd)
        for col in (inv32, ret32, fop, args, rets, ok_words)) + (
        jax.device_put(jnp.zeros(D, jnp.uint32), shd),)
    for step, bound in enumerate((1, 3)):
        carry = run_b(carry, *consts, jnp.int32(bound))
        want = [np.asarray(x) for x in jax.device_get(carry)]
        got = worker.concat_carries([c[step] for c in per_rank])
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, (bound, i)
            assert np.array_equal(g, w), (bound, i)


def test_sharded_obs_equals_jax_on_rank_0(ranks):
    from jepsen_tpu import obs as jobs
    D, outs = ranks
    got, snap, events = outs[0][len(CASES) + 4]
    spec = models.cas_register_spec
    e, st = spec.encode(CASES[STEAL][1])
    test = {}
    with jobs.run_scope(test):
        want = check_encoded_sharded(spec, e, st, _jax_mesh(D),
                                     chunk_iters=1,
                                     max_configs=_obs_budget(D))
    assert got == want
    assert got["iterations"] == OBS_ITERS
    assert (got["valid"], got["error"]) == ("unknown",
                                            "max-configs-exceeded")
    jsnap = test["obs"]["registry"].snapshot()
    assert worker.obs_series(snap) == worker.obs_series(jsnap)
    instants, spans = worker.obs_events(events)
    assert (instants, spans) == worker.obs_events(
        test["obs"]["tracer"].events())
    hb = [x for x in instants if x[0] == "wgl.heartbeat.jax-wgl-sharded"]
    assert hb and all(len(x[2]["shard_tops"]) == D for x in hb)
    for r in range(1, D):
        _, snap_r, events_r = outs[r][len(CASES) + 4]
        assert worker.obs_series(snap_r) == {}
        assert worker.obs_events(events_r) == ([], set())
