"""The port on a CUDA card: the rollout kernel against its plain version
(on real histories, and on the adversarial cases of rollout_cases.py
under every launch plan), the wrapper's checks, the device search
against the same search on the CPU, the key batch (cas-register and
the queue models) and a single-key queue check against the same on the
CPU, and the two incremental monitors card against CPU: the streaming
fold (solo and lane-batched, every carry array), ``StreamCheck``, the
closures (bf16 on the card, float32 on the CPU) and the txn checkers;
the default gate ("competition") and a checkpoint resumed on the card
and on the CPU; under a bound obs registry, the main histories and a key
batch make the launches they make unbound (and with ``phases?`` off),
the phase plane's synchronize runs only while phases are on, and the
compile phase is armed only when the kernel's library is not yet
loaded; the multi-device search at world size 1 over NCCL (the sharded
single search and the mesh key batch equal to the flat ones, verdicts,
iterations and rollout launches included; a 2-D mesh refused). Every
test is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). This file imports neither JAX nor the JAX
package, so it runs where they are absent too:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance: equality (all integers)."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import models, parallel, simulate
from jepsen_tpu_torch.checker import (checkers, rollout, rollout_cases,
                                      torch_wgl)
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


@pytest.fixture(scope="module")
def adversarial():
    """name -> (case, plain outputs at R = 1024 on the card), filled on
    first use."""
    return {c.name: [c, None] for c in rollout_cases.adversarial()}


PLANS = ("default", "columns via L2", "state in global")


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("name", rollout_cases.NAMES)
def test_kernel_equals_plain_adversarial(dev, adversarial, monkeypatch, name,
                                         plan):
    """Every adversarial case under every launch plan (a smaller
    shared-memory budget forces the plans that read columns through
    L1/L2 or keep the chains' state in global scratch)."""
    c, want = adversarial[name]
    R = 1024
    xs = c.tensors(dev)
    if want is None:
        want = adversarial[name][1] = rollout.plain(c.step, *xs, R)
    n = len(c.invoke)
    sb = rollout.state_bytes(c.seed_lin.shape[1])
    budget = {"columns via L2": 24 * n + sb,
              "state in global": sb - 16}.get(plan, rollout.SMEM_BUDGET)
    monkeypatch.setattr(rollout, "SMEM_BUDGET",
                        min(budget, rollout.SMEM_BUDGET))
    before = rollout.launches
    j, st = rollout.run(c.step, *xs, R)
    torch.cuda.synchronize()
    assert rollout.launches == before + 1
    assert torch.equal(j, want[0]) and torch.equal(st, want[1])


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


_BATCH_FIELDS = ("valid", "iterations", "configs_explored", "compactions",
                 "engine", "table_load", "table_insert_failures")


@pytest.mark.parametrize("name,n_ops", [("cas-register", 100),
                                        ("fifo-queue", 60),
                                        ("unordered-queue", 60)])
def test_batch_equals_cpu_batch(dev, name, n_ops):
    """A short key batch on the card, every 4th key corrupted (queues
    without their fast check, so the search with pad_state decides):
    one iteration per chunk, so compaction points do not depend on the
    clock, and the per-key results equal the CPU run's. The batch rolls
    on the scan path: the rollout kernel is not launched."""
    import dataclasses
    spec = models.model_spec(name)
    if name != "cas-register":
        spec = dataclasses.replace(spec, fast_check=None)
    rng = random.Random(45100)
    hists = []
    for k in range(12):
        hist = simulate.random_history(rng, name, 6, n_ops, 0.05)
        hists.append(simulate.corrupt(rng, hist) if k % 4 == 3 else hist)
    before = rollout.launches
    got = parallel.check_batch_histories(spec, hists, chunk_iters=1)
    want = parallel.check_batch_histories(spec, hists, chunk_iters=1,
                                          device="cpu")
    assert rollout.launches == before
    for k, (g, w) in enumerate(zip(got, want)):
        for field in _BATCH_FIELDS:
            assert g.get(field) == w.get(field), (k, field)
    assert any(g.get("engine") == "jax-wgl" for g in got)


@pytest.mark.parametrize("name", ["fifo-queue", "unordered-queue"])
def test_queue_check_equals_cpu(dev, name):
    """checkers.linearizable on a 150-op queue history, fast check on,
    and the device search alone (fast check off), card against CPU."""
    import dataclasses
    hist = simulate.random_history(random.Random(7), name, 6, 150, 0.02)
    lin = checkers.linearizable({"model": name})
    assert lin.check({}, hist)["valid"] is True
    spec = dataclasses.replace(models.model_spec(name), fast_check=None)
    e, st = spec.encode(hist)
    got = torch_wgl.check_encoded(spec, e, st)
    want = torch_wgl.check_encoded(spec, e, st, device="cpu")
    for k in ("valid", "iterations", "configs_explored", "engine"):
        assert got.get(k) == want.get(k), k


def _fold_job(name, seed, corrupt, dev):
    """The whole-history fold job of one seeded 200-op history on
    ``dev``."""
    from jepsen_tpu_torch.checker import streamlin
    spec = models.model_spec(name)
    rng = random.Random(seed)
    hist = simulate.random_history(rng, name, 8, 200, 0.02)
    if corrupt:
        hist = simulate.corrupt(rng, hist)
    e, init = spec.encode(hist)
    job = streamlin.history_job(spec, e, init, device=dev)
    job.C = 16           # one shape for every key: one lane batch
    return job


def _same_fold(got, want):
    for k in ("status", "viol_slot", "passes", "steps", "n_live"):
        assert got[k] == want[k], k
    for k in ("lin", "st", "live", "open_w"):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("name", SPECS)
def test_fold_equals_cpu_fold(dev, name):
    """The streaming fold of 200-op keys on the card, solo and as one
    lane batch of four, equals the same folds on the CPU array for
    array (the sort-based dedup and the scatters are deterministic)."""
    from jepsen_tpu_torch.checker import streamlin
    jobs = [(_fold_job(name, s, s % 2 == 1, dev),
             _fold_job(name, s, s % 2 == 1, "cpu")) for s in range(4)]
    for g, c in jobs:
        _same_fold(streamlin.solo_fold(g), streamlin.solo_fold(c))
    got = streamlin.batch_fold([g for g, _ in jobs])
    want = streamlin.batch_fold([c for _, c in jobs])
    for g, w in zip(got, want):
        _same_fold(g, w)


def test_stream_check_equals_cpu(dev):
    """StreamCheck fed a corrupted cas-register key op by op, checked
    every 8 completions, on the card and on the CPU: equal verdicts and
    fold counters at every check."""
    from jepsen_tpu_torch.monitor import StreamCheck
    rng = random.Random(3)
    hist = simulate.corrupt(rng, simulate.random_history(
        rng, "cas-register", 8, 120, 0.02))
    spec = models.cas_register_spec
    sc, cc = StreamCheck(spec), StreamCheck(spec, device="cpu")
    n = 0
    for i, op in enumerate(hist):
        if sc.offer(op, i) & cc.offer(op, i):
            n += 1
            if n % 8 == 0:
                assert sc.check()["valid"] == cc.check()["valid"]
                assert sc.stream_summary()["fold_cells"] \
                    == cc.stream_summary()["fold_cells"]
    assert sc.check()["valid"] == cc.check()["valid"]


@pytest.mark.parametrize("n", [300, 2048])
def test_closure_equals_cpu(dev, n):
    """Transitive closures and a batched probe by float32 squarings on
    the card equal the CPU's bit for bit; the incremental frontier takes
    the same passes."""
    from jepsen_tpu_torch import cycle
    rng = np.random.default_rng(n)
    adj = rng.random((n, n)) < 2.0 / n
    np.fill_diagonal(adj, False)
    assert np.array_equal(cycle.transitive_closure(adj),
                          cycle.transitive_closure(adj, device="cpu"))
    dag = np.triu(adj, 1)
    assert cycle.batch_closure_probe([adj, dag]) \
        == cycle.batch_closure_probe([adj, dag], device="cpu")
    inc, cinc = cycle.IncrementalClosure(), \
        cycle.IncrementalClosure(device="cpu")
    for m in (n // 3, n // 2, n):
        p0 = cycle.closure_passes()
        inc.update(dag[:m, :m])
        p1 = cycle.closure_passes()
        cinc.update(dag[:m, :m])
        assert p1 - p0 == cycle.closure_passes() - p1
        assert np.array_equal(inc.closure(), cinc.closure())


def test_txn_checks_equal_cpu(dev):
    """append and wr checks of seeded histories of 300 txns, valid and
    with an injected G1c cycle, and TxnCheck at chunk 64: card == CPU."""
    from jepsen_tpu_torch.cycle import append, wr
    from jepsen_tpu_torch.monitor import TxnCheck
    for g1c in (None, (80, 160)):
        hist = simulate.txn_append_history(300, 3, g1c=g1c)
        assert append.check(hist) == append.check(hist, device="cpu")
        core, ccore = TxnCheck(), TxnCheck(device="cpu")
        for i, op in enumerate(hist):
            core.offer(op)
            ccore.offer(op)
            if (i + 1) % 64 == 0 or i == len(hist) - 1:
                assert core.check() == ccore.check()
    hist = simulate.txn_wr_history(random.Random(5), 300, 32)
    assert wr.check(hist) == wr.check(hist, device="cpu")


@pytest.mark.parametrize("name", SPECS)
def test_competition_on_card(dev, name):
    """The default gate ("competition") on the card decides as the CPU
    oracle does, and its device racer launches the rollout kernel."""
    from jepsen_tpu_torch.checker import wgl
    hist = simulate.random_history(random.Random(9), name, 8, 500, 0.05)
    rollout.launches = 0
    r = checkers.linearizable({"model": name}).check({}, hist)
    races = checkers.join_racers()
    spec = models.model_spec(name)
    want = wgl.check_encoded(spec, *spec.encode(hist))
    assert r["valid"] == want["valid"]
    assert races[0]["winner"] == r["engine"]
    # the device racer runs at least one chunk before it sees the cancel
    assert rollout.launches > 0


def test_checkpoint_resume_on_card(dev, tmp_path):
    """A search stopped by its budget and resumed from its snapshot on the
    card ends as an uninterrupted run: same verdict and iterations; the
    snapshot resumes on the CPU to the same."""
    spec = models.cas_register_spec
    hist = simulate.random_history(random.Random(45100), "cas-register", 64,
                                   10_000, 0.05)
    e, st = spec.encode(hist)
    want = torch_wgl.check_encoded(spec, e, st, chunk_iters=1)
    assert want["iterations"] > 1
    prep = torch_wgl._prepare_search(spec, e, st)[1]
    W = torch_wgl._plan_sizes(prep[8], prep[11], prep[9])[1]
    for i, where in enumerate(("cuda", "cpu")):
        ck = str(tmp_path / f"frontier{i}.npz")
        r1 = torch_wgl.check_encoded(spec, e, st, chunk_iters=1,
                                     max_configs=W, checkpoint=ck)
        assert r1["valid"] == "unknown" and r1["iterations"] == 1
        r2 = torch_wgl.check_encoded(spec, e, st, chunk_iters=1,
                                     checkpoint=ck, device=where)
        assert (r2["valid"], r2["iterations"]) \
            == (want["valid"], want["iterations"])


MAIN = (("cas-register", 0.05), ("mutex", 0.02))


@pytest.mark.parametrize("name,crash_p", MAIN)
def test_obs_bound_search_launches_what_the_unbound_one_does(dev, name,
                                                             crash_p,
                                                             monkeypatch):
    """The main-path histories (10k ops, 64 processes) unbound, bound,
    and bound with ``phases?`` off: the same verdict, iterations and
    rollout kernel launches; the phase plane synchronizes the card once
    per chunk plus once for the initial carry, and only with phases on."""
    from jepsen_tpu_torch import obs
    hist = simulate.random_history(random.Random(45100), name, 64, 10_000,
                                   crash_p)
    spec = models.model_spec(name)
    e, st = spec.encode(hist)
    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (synced.append(d), real(d)))
    got = {}
    for mode, test in (("unbound", None), ("bound", {}),
                       ("phases_off", {"phases?": False})):
        rollout.launches = 0
        synced.clear()
        scope = obs.run_scope(dict(test)) if test is not None \
            else obs.bind(None, None)
        with scope:
            r = torch_wgl.check_encoded(spec, e, st)
            chunks = (obs.registry().counter_value("wgl.chunks",
                                                   engine="jax-wgl")
                      if obs.registry() is not None else None)
        got[mode] = (r["valid"], r["iterations"], rollout.launches,
                     len(synced), chunks)
    assert got["unbound"][0] is True and got["unbound"][2] > 0
    for mode in ("bound", "phases_off"):
        assert got[mode][:3] == got["unbound"][:3], got
    assert got["unbound"][3] == got["phases_off"][3] == 0
    assert got["bound"][3] == got["bound"][4] + 1, got


def test_obs_bound_batch_launches_what_the_unbound_one_does(dev):
    """One iteration of a 16-key batch under the profiler: as many
    kernels bound with ``phases?`` off as unbound."""
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.profile_main import profile_call
    spec = models.cas_register_spec
    pairs = [spec.encode(hh) for hh in simulate.bench_histories(16)[0]]
    parallel.check_batch_encoded(spec, pairs, max_configs=1)     # warm-up

    def kernels():
        _, _, ev = profile_call(lambda: parallel.check_batch_encoded(
            spec, pairs, max_configs=1), host_ops=False)
        return sum(x[3] for x in ev)

    unbound = kernels()
    with obs.run_scope({"phases?": False}):
        bound = kernels()
    assert unbound > 0 and bound == unbound


def test_obs_compile_phase_armed_only_before_the_library_loads(
        dev, monkeypatch):
    """The first dispatch of a search whose rollout library was not yet
    loaded is the ``compile`` phase; with the library loaded, none is."""
    from jepsen_tpu_torch import _build, obs
    spec = models.cas_register_spec
    hist = simulate.random_history(random.Random(3), "cas-register", 16,
                                   2_000, 0.05)
    e, st = spec.encode(hist)
    torch_wgl.check_encoded(spec, e, st)            # loads the library
    names = {}
    for loaded in (True, False):
        monkeypatch.setattr(_build, "loaded", lambda name, v=loaded: v)
        test = {}
        with obs.run_scope(test):
            torch_wgl.check_encoded(spec, e, st)
        names[loaded] = [x["name"] for x in test["obs"]["tracer"].events()
                         if x["name"] == "wgl.phase.compile"]
    assert names[True] == [] and names[False] == ["wgl.phase.compile"]


@pytest.fixture(scope="module")
def cuda_mesh():
    """A 1-D "cuda" DeviceMesh over a world of one NCCL rank (a
    ``HashStore``, no TCP port), torn down after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NCCL mesh runs on the card "
                    "(tests/test_torch_searchshard.py runs gloo ranks on "
                    "the CPU)")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=card)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("search",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", SPECS)
def test_sharded_search_at_world_size_one_equals_flat(cuda_mesh, name):
    """One rank of the sharded search is the flat search plus its
    collectives: the same verdict, iterations, explored configs, table
    diagnostics and witness, and the same rollout kernel launches."""
    spec = models.model_spec(name)
    hist = simulate.random_history(random.Random(7), name, 8, 400, 0.05)
    e, st = spec.encode(hist)
    rollout.launches = 0
    flat = torch_wgl.check_encoded(spec, e, st)
    n_flat = rollout.launches
    rollout.launches = 0
    torch_wgl.collective_calls = 0
    got = parallel.check_encoded_sharded(spec, e, st, cuda_mesh)
    assert rollout.launches == n_flat > 0
    assert torch_wgl.collective_calls >= 2 * got["iterations"]
    assert got["engine"] == "jax-wgl-sharded" and got["shards"] == 1
    assert got["shard_explored"] == [got["configs_explored"]]
    for k in ("valid", "iterations", "configs_explored", "table_load",
              "table_insert_failures", "op", "configs"):
        assert got.get(k) == flat.get(k), k
    if "witness" in flat:
        assert {**got["witness"], "engine": "jax-wgl"} == flat["witness"]


def test_mesh_batch_at_world_size_one_equals_batch(cuda_mesh):
    spec = models.cas_register_spec
    rng = random.Random(45100)
    hists = [simulate.random_history(rng, "cas-register", 4, 90, 0.05)
             for _ in range(6)]
    pairs = [spec.encode(hh) for hh in hists]
    rollout.launches = 0
    want = parallel.check_batch_encoded(spec, pairs, chunk_iters=1)
    got = parallel.check_batch_encoded(spec, pairs, mesh=cuda_mesh,
                                       chunk_iters=1)
    assert got == want and rollout.launches == 0


def test_mesh_gate_and_refusals_on_card(cuda_mesh):
    """``linearizable(jax-wgl, {"mesh": mesh})`` under ``core.check``
    decides and certifies on the card; a 2-D mesh and a device the mesh
    does not name are refused."""
    from torch.distributed.device_mesh import init_device_mesh
    from jepsen_tpu_torch.checker import core
    hist = simulate.random_history(random.Random(3), "cas-register", 6, 200,
                                   0.05)
    test = {}
    r = core.check(checkers.linearizable(
        {"model": "cas-register", "algorithm": "jax-wgl",
         "engine_opts": {"mesh": cuda_mesh}}), test, hist)
    assert r["engine"] == "jax-wgl-sharded" and r["valid"] is True
    assert test["certificate"]["verdict"] is True
    assert not test["analysis"]["certify"]["counts"]["error"]
    spec = models.cas_register_spec
    e, st = spec.encode(hist)
    with pytest.raises(ValueError, match="1-D"):
        parallel.check_encoded_sharded(
            spec, e, st, init_device_mesh("cuda", (1, 1),
                                          mesh_dim_names=("a", "b")))
    with pytest.raises(ValueError, match="disagrees"):
        parallel.check_encoded_sharded(spec, e, st, cuda_mesh,
                                       device="cpu")
