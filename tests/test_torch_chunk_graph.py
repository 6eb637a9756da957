"""The search chunk as graph replays (jepsen_tpu_torch/checker/chunk_graph.py)
against the eager loop and the JAX engine, on the CPU.

A CUDA graph is captured and replayed only on a card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ``graph`` phase
run it there). Here a stub graph stands in for it: its "capture" records
the captured step without running it and each "replay" runs the step,
so ``torch_wgl.run_chunk``'s graph path (the eager first iteration, the
capture in place on the carry, the copy-back, the flag read after each
replay, the lease and the cache) runs with ``"cpu"`` added to
``chunk_graph.DEVICES``.

* (a) At every chunk boundary the replayed search's carry equals the
  eager ``run_chunk``'s and ``jax_wgl``'s ``run_chunk``'s, compared
  through ``carry_to_numpy``: cas-register, register and mutex on the
  kernel path (``rollout.plain``; the reference's Pallas kernel in
  interpret mode), valid and invalid; the fifo and unordered queues in a
  four-key batch on the scan path, through a compaction and a carry
  restored from numpy; ``check_encoded`` and ``check_batch_encoded``
  give the eager results.
* (b) ``body`` past the verdict leaves every carry array unchanged
  (``it`` is guarded).
* (c) The captured step reads nothing back to the host: ``Tensor.item``,
  ``tolist``, ``__bool__``, ``cpu`` and ``numpy`` raise while it
  replays, on the kernel path and on the scan path (whose CPU-only early
  exit a graph never takes).
* (d) ``rollout.launches`` gets a graph's captured launches per replay
  and nothing at capture.
* (e) The cache: its key, one owner per graph, byte-bounded LRU
  eviction, a graph over the bound freed when its search ends.
* ``profile_main.host_launches`` on hand-made events: a graph launch is
  one call, a capture's recorded calls are counted apart, and the
  interval holding a capture is left out of the per-replay mean.

Tolerance zero: every comparison is on integers."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jepsen_tpu import models as jm
from jepsen_tpu.checker import jax_wgl
from jepsen_tpu.parallel import keyshard as jks
from jepsen_tpu.simulate import corrupt, random_history
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import chunk_graph, rollout, torch_wgl
from jepsen_tpu_torch.parallel import check_batch_encoded
from jepsen_tpu_torch.profile_main import CAPTURED, host_launches


class StubGraph:
    """A graph without a card: ``capture`` keeps the step, ``replay``
    runs it. A replay runs no Python on a card, so the rollout wrapper's
    count of the step's Python is dropped (``counting_captured``)."""

    def __init__(self, device):
        self.fn = None
        self.nodes = 0
        self.pool_bytes = 0
        self.closed = False

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        with rollout.counting_captured():
            self.fn()

    def close(self):
        self.closed = True
        self.fn = None


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def stub(monkeypatch):
    """The graph path on the CPU through ``StubGraph``, with an empty
    cache and counters from 0. Yields a switch: ``stub(False)`` runs
    the eager loop, ``stub(True)`` the graph path. A search built while
    the graph path is on reads every rollout step, as a replay does (the
    CPU's early exit is decided when a search is built), so the build
    cache starts empty."""
    monkeypatch.setattr(chunk_graph, "GRAPH", StubGraph)
    for name in ("captures", "hits", "replays", "evictions"):
        monkeypatch.setattr(chunk_graph, name, 0)
    chunk_graph.clear()
    torch_wgl._build_search.cache_clear()

    def graphs(on):
        monkeypatch.setattr(chunk_graph, "DEVICES",
                            ("cuda", "cpu") if on else ("cuda",))

    graphs(True)
    yield graphs
    chunk_graph.clear()
    torch_wgl._build_search.cache_clear()


def _same(got_carry, want, what):
    got = torch_wgl.carry_to_numpy(got_carry)
    assert len(got) == len(want) == torch_wgl.N_CARRY
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        assert np.array_equal(a, b), (what, i)


def _jax(carry):
    return [np.asarray(x) for x in jax.device_get(carry)]


#: seeds whose 220-op history the search decides valid in several
#: iterations, and whose corrupted one it decides invalid
VALID_SEEDS = {"cas-register": 45102, "register": 45102, "mutex": 45100}
INVALID_SEEDS = {"cas-register": 45103, "register": 45102}
#: the rollout's (R, NS) per model: the mutex's default chains decide
#: its valid histories in one iteration, shallow ones take several
ROLLOUT = {"mutex": (16, 2)}


def _trial(name, invalid):
    """A 220-op history of 6 processes (the rollout trials' shape). The
    invalid register ones are corrupted with reads kept in range, so the
    search, not a fast path, decides them; the invalid mutex one is a
    crash-free history with two acquires appended one after the other."""
    if not invalid:
        return random_history(random.Random(VALID_SEEDS[name]), name, 6,
                              220, 0.05)
    if name == "mutex":
        hist = random_history(random.Random(45101), name, 6, 220, 0.0)
        for p in (100, 101):
            hist += [{"type": t, "process": p, "f": "acquire",
                      "value": None, "index": len(hist) + i}
                     for i, t in enumerate(("invoke", "ok"))]
        return hist
    rng = random.Random(INVALID_SEEDS[name])
    hist = corrupt(rng, random_history(rng, name, 6, 220, 0.05))
    for o in hist:
        if o["type"] == "ok" and o["f"] == "read" \
                and isinstance(o.get("value"), int):
            o["value"] = o["value"] % 4
    return hist


def _single(name, invalid, kernel=True):
    """Both packages' builds of one key's search: (jax init, jax run,
    jax consts, torch build, torch consts, init state)."""
    jspec, tspec = jm.model_spec(name), tm.model_spec(name)
    e, st = jspec.encode(_trial(name, invalid))
    kind, prep = jax_wgl._prepare_search(jspec, e, st)
    assert kind == "search"
    (_, inv32, ret32, fop, args, rets, ok_words, init_state, n_pad, C, A,
     S) = prep
    B, W, O, T = jax_wgl._plan_sizes(n_pad, S, C)
    R, NS = ROLLOUT.get(name, (None, None))
    j_init, j_run = jax_wgl._build_search(
        jspec.step, 1, n_pad, B, S, C, A, W, O, T, R=R, NS=NS,
        rollout_kernel="pallas" if kernel else "scan")
    jconsts = (jnp.asarray(inv32[None]), jnp.asarray(ret32[None]),
               jnp.asarray(fop[None]), jnp.asarray(args[None]),
               jnp.asarray(rets[None]), jnp.asarray(ok_words[None]),
               jnp.zeros(1, jnp.uint32))
    build = torch_wgl._build_search(
        tspec.step, 1, n_pad, B, S, C, A, W, O, T, R=R, NS=NS,
        rollout_kernel="kernel" if kernel else "scan", device="cpu")
    tconsts = torch_wgl.make_consts(inv32, ret32, fop, args, rets,
                                    ok_words, "cpu")
    return j_init, j_run, jconsts, build, tconsts, init_state


def _running(want):
    return bool(((want[torch_wgl.IDX_STATUS] == torch_wgl.RUNNING)
                 & (want[torch_wgl.IDX_TOP] > 0)).any())


# ---------------------------------------------------------------------------
# (a) replay == eager == reference, at every chunk boundary

@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("name", ["cas-register", "register", "mutex"])
def test_replay_equals_eager_and_reference_on_the_kernel_path(
        stub, name, invalid):
    j_init, j_run, jconsts, (init, _, run), tconsts, st0 = _single(
        name, invalid)
    jc = j_init(jnp.asarray(st0[None]))
    eager = init(st0[None])
    graph = init(st0[None])
    boundaries = 0
    with chunk_graph.Lease() as lease:
        for bound in (1, 2, 3, 5, 8, 13, 21, 34, 55, 89):
            jc = j_run(jc, *jconsts, jnp.int32(bound))
            want = _jax(jc)
            stub(False)
            eager = run(eager, tconsts, bound)
            stub(True)
            graph = run(graph, tconsts, bound, lease)
            _same(eager, want, f"eager at {bound}")
            _same(graph, want, f"graph at {bound}")
            boundaries += 1
            if not _running(want):
                break
    assert not _running(want), "the search outran the bounds"
    assert want[torch_wgl.IDX_STATUS][0] == (
        torch_wgl.RUNNING if invalid else torch_wgl.VALID)
    # one eager iteration, then one capture for all the others
    assert chunk_graph.captures == (want[torch_wgl.IDX_IT][0] > 1)
    assert chunk_graph.replays == want[torch_wgl.IDX_IT][0] - 1
    assert boundaries >= 2


def _batch(name):
    """Both packages' four-key batch of a queue model (three live keys,
    one corrupted, and a dummy key), fast check off, on the scan
    rollout."""
    jspec = dataclasses.replace(jm.model_spec(name), fast_check=None)
    tspec = dataclasses.replace(tm.model_spec(name), fast_check=None)
    rng = random.Random(7)
    hists = [random_history(rng, name, 4, 90, 0.02) for _ in range(3)]
    hists[1] = corrupt(rng, hists[1])
    pairs = [jspec.encode(h) for h in hists]
    encs = [jks._encode_arrays(e) for e, _ in pairs]
    n_pad = jax_wgl._bucket(max(len(e) for e, _ in pairs), 64)
    S = max(int(np.asarray(st).shape[0]) for _, st in pairs)
    S = jax_wgl._bucket(S, 2)
    A = max(int(e.args.shape[1]) for e, _ in pairs)
    C = max(jax_wgl.max_point_concurrency(
        enc[0], np.where(enc[1] == jax_wgl.INF32, jax_wgl.INF_TIME,
                         enc[1].astype(np.int64))) for enc in encs)
    C = min(jax_wgl._bucket(C, 4), n_pad)
    B, W, _, _ = jax_wgl._plan_sizes(n_pad, S, C)
    cols = [jks._pad_key(e, st, jspec, n_pad, S, A, enc)
            for (e, st), enc in zip(pairs, encs)]
    cols.append(jks._dummy_key(n_pad, S, A))
    return (jspec, tspec, cols, [1, 2, 3, 0],
            (n_pad, B, S, C, A, min(W, 32), 4096, 1 << 14))


@pytest.mark.parametrize("name", ["fifo-queue", "unordered-queue"])
def test_batch_replay_equals_eager_and_reference_through_compaction(
        stub, name):
    jspec, tspec, cols, salts, (n, B, S, C, A, W, O, T) = _batch(name)
    R = min(256, n)
    jconsts = tuple(jnp.asarray(np.stack([c[i] for c in cols]))
                    for i in range(6)) + (
        jnp.asarray(np.asarray(salts, np.uint32)),)
    tconsts = torch_wgl.make_batch_consts([c[:6] for c in cols], salts,
                                          "cpu")
    states = np.stack([c[6] for c in cols])
    j_init, j_run = jax_wgl._build_search(jspec.step, 4, n, B, S, C, A, W,
                                          O, T, 1, R=R, NS=1,
                                          rollout_kernel="scan")
    t_init, _, t_run = torch_wgl._build_search(
        tspec.step, 4, n, B, S, C, A, W, O, T, R=R, NS=1,
        rollout_kernel="scan", device="cpu")
    jc = j_init(jnp.asarray(states))
    eager = t_init(states)
    graph = t_init(states)
    with chunk_graph.Lease() as lease:
        for bound in (1, 2, 4):
            jc = j_run(jc, *jconsts, jnp.int32(bound))
            want = _jax(jc)
            stub(False)
            eager = t_run(eager, tconsts, bound)
            stub(True)
            graph = t_run(graph, tconsts, bound, lease)
            _same(eager, want, f"eager at {bound}")
            _same(graph, want, f"graph at {bound}")
        assert chunk_graph.captures == 1
        # a carry restored from numpy (a resume) is copied into the
        # graph's static tensors, and the search goes on from it
        restored = torch_wgl.carry_from_numpy(want, "cpu")
        jc = j_run(jc, *jconsts, jnp.int32(5))
        graph = t_run(restored, tconsts, 5, lease)
        assert graph is lease.entry.carry and graph is not restored
        want = _jax(jc)
        _same(graph, want, "graph after a restore")
        stub(False)
        eager = t_run(eager, tconsts, 5)
        _same(eager, want, "eager at 5")

        # compaction to rows 1 (still running) and 0 at a wider
        # frontier: a new width, so a graph of its own after one eager
        # iteration of that width
        sel = [1, 0]
        eager, e_consts = torch_wgl.compact(eager, tconsts,
                                            torch.tensor(sel))
        graph, g_consts = torch_wgl.compact(graph, tconsts,
                                            torch.tensor(sel))
        want = [np.take(x, sel, axis=0) if i in jax_wgl.KEYED else x
                for i, x in enumerate(want)]
        _same(graph, want, "compacted")
        W2 = 2 * W
        _, j_run2 = jax_wgl._build_search(jspec.step, 2, n, B, S, C, A, W2,
                                          O, T, 1, R=R, NS=1,
                                          rollout_kernel="scan")
        jconsts2 = tuple(jnp.take(c, jnp.asarray(sel), axis=0)
                         for c in jconsts)
        _, _, t_run2 = torch_wgl._build_search(
            tspec.step, 2, n, B, S, C, A, W2, O, T, R=R, NS=1,
            rollout_kernel="scan", device="cpu")
        jc = tuple(jnp.asarray(x) for x in want)
        for bound in (6, 7, 9):
            if not _running(want):
                break
            jc = j_run2(jc, *jconsts2, jnp.int32(bound))
            want = _jax(jc)
            stub(False)
            eager = t_run2(eager, e_consts, bound)
            stub(True)
            graph = t_run2(graph, g_consts, bound, lease)
            _same(eager, want, f"eager at {bound}")
            _same(graph, want, f"graph at {bound}")
        # the new width's first iteration ran eagerly, its later ones
        # in a graph of their own
        wide = int(want[torch_wgl.IDX_IT][0]) - 5 > 1
        assert chunk_graph.captures == 1 + wide
    # every graph went back to the cache
    assert chunk_graph.stats()["cached"] == 1 + wide


def test_check_encoded_on_the_graph_path_equals_eager(stub):
    spec = tm.cas_register_spec
    for invalid in (False, True):
        e, st = spec.encode(_trial("cas-register", invalid))
        stub(False)
        want = torch_wgl.check_encoded(spec, e, st, device="cpu",
                                       chunk_iters=2)
        stub(True)
        got = torch_wgl.check_encoded(spec, e, st, device="cpu",
                                      chunk_iters=2)
        assert got == want
    # the second search of the shape took the first one's graph
    assert chunk_graph.captures == 1 and chunk_graph.hits >= 1


@pytest.mark.parametrize("name", ["fifo-queue", "unordered-queue"])
def test_check_batch_encoded_on_the_graph_path_equals_eager(stub, name):
    spec = dataclasses.replace(tm.model_spec(name), fast_check=None)
    rng = random.Random(11)
    hists = [random_history(rng, name, 4, 60, 0.02) for _ in range(4)]
    hists[3] = corrupt(rng, hists[3])
    pairs = [spec.encode(h) for h in hists]
    stub(False)
    want = check_batch_encoded(spec, pairs, chunk_iters=1, device="cpu")
    stub(True)
    got = check_batch_encoded(spec, pairs, chunk_iters=1, device="cpu")
    assert got == want
    assert max(r.get("compactions", 0) for r in got) >= 1
    assert chunk_graph.captures >= 1


@pytest.mark.parametrize("name", ["fifo-queue", "unordered-queue"])
def test_a_search_that_takes_a_compacted_searchs_old_graph_leaves_it_alone(
        stub, name):
    """``compact`` passes the table and the counters through as they
    are, so a compacted carry would share them with the graph of the
    width it leaves. That graph goes back to the cache, where another
    search of the old width takes it and loads its own carry into it:
    the compacted search must not see those writes."""
    _, tspec, cols, salts, (n, B, S, C, A, W, O, T) = _batch(name)
    R = min(256, n)
    consts = torch_wgl.make_batch_consts([c[:6] for c in cols], salts,
                                         "cpu")
    states = np.stack([c[6] for c in cols])
    init, _, run = torch_wgl._build_search(
        tspec.step, 4, n, B, S, C, A, W, O, T, R=R, NS=1,
        rollout_kernel="scan", device="cpu")
    _, _, run2 = torch_wgl._build_search(
        tspec.step, 2, n, B, S, C, A, 2 * W, O, T, R=R, NS=1,
        rollout_kernel="scan", device="cpu")
    sel = torch.tensor([1, 0])
    stub(False)
    eager, e_consts = torch_wgl.compact(run(init(states), consts, 3),
                                        consts, sel)
    eager = run2(eager, e_consts, 4)
    assert _running(torch_wgl.carry_to_numpy(eager))
    want = torch_wgl.carry_to_numpy(run2(eager, e_consts, 64))
    stub(True)
    with chunk_graph.Lease() as first:
        graph, g_consts = torch_wgl.compact(run(init(states), consts, 3,
                                                first), consts, sel)
        # the new width's first iteration: the width-4 graph is idle now
        graph = run2(graph, g_consts, 4, first)
        with chunk_graph.Lease() as second:
            run(init(states), consts, 3, second)
            assert chunk_graph.hits == 1, "the width-4 graph was not taken"
        graph = run2(graph, g_consts, 64, first)
        _same(graph, want, "the compacted search")


def test_lease_clones_what_a_carry_shares_with_the_graph_it_leaves(stub):
    old = _stub_entry(0, key="old")
    lease = chunk_graph.Lease()
    lease.entry = old
    shared, own = old.carry[0], torch.arange(3)
    entry, carry = lease.holds("new", (shared, own), ())
    assert entry is None and lease.entry is None
    assert carry[1] is own
    assert carry[0] is not shared and torch.equal(carry[0], shared)
    assert (carry[0].untyped_storage().data_ptr()
            != shared.untyped_storage().data_ptr())
    assert chunk_graph.stats()["cached"] == 1


@pytest.mark.parametrize("bound", [None, 0])
def test_two_threads_batch_through_compactions(stub, bound):
    """Two key batches of one shape in two threads at once, through
    their compactions, with the cache's own bound and with a bound of 0
    (every graph freed as its search lets it go, beside the other
    thread's captures): each equals the eager loop's results."""
    import contextlib
    import threading
    spec = dataclasses.replace(tm.model_spec("fifo-queue"),
                               fast_check=None)
    rng = random.Random(11)
    hists = [random_history(rng, "fifo-queue", 4, 60, 0.02)
             for _ in range(4)]
    hists[3] = corrupt(rng, hists[3])
    pairs = [spec.encode(h) for h in hists]
    stub(False)
    want = check_batch_encoded(spec, pairs, chunk_iters=1, device="cpu")
    assert max(r.get("compactions", 0) for r in want) >= 1
    stub(True)
    got, errors = {}, []
    barrier = threading.Barrier(2, timeout=60)

    def search(i):
        try:
            barrier.wait()
            got[i] = check_batch_encoded(spec, pairs, chunk_iters=1,
                                         device="cpu")
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    with (contextlib.nullcontext() if bound is None
          else chunk_graph.bounded(bound)):
        threads = [threading.Thread(target=search, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors, errors
    assert got[0] == want and got[1] == want
    if bound == 0:
        assert chunk_graph.stats()["cached"] == 0
        assert chunk_graph.evictions == chunk_graph.captures


# ---------------------------------------------------------------------------
# (b) past the verdict, body changes nothing

@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("invalid", [False, True])
def test_body_past_the_verdict_is_a_no_op(stub, invalid, kernel):
    stub(False)
    *_, (init, body, run), consts, st0 = _single("cas-register", invalid,
                                                 kernel)
    carry = run(init(st0[None]), consts, 10_000)
    done = torch_wgl.carry_to_numpy(carry)
    assert not _running(done)
    for _ in range(2):
        carry = body(carry, consts)
        _same(carry, done, "past the verdict")


def test_batch_body_past_the_verdict_is_a_no_op(stub):
    """Built for the graph path, where the scan rollout reads all of its
    steps (no CPU early exit), as a replay does."""
    _, tspec, cols, salts, (n, B, S, C, A, W, O, T) = _batch("fifo-queue")
    init, body, run = torch_wgl._build_search(
        tspec.step, 4, n, B, S, C, A, W, O, T, R=min(256, n), NS=1,
        rollout_kernel="scan", device="cpu")
    consts = torch_wgl.make_batch_consts([c[:6] for c in cols], salts,
                                         "cpu")
    with chunk_graph.Lease() as lease:
        carry = run(init(np.stack([c[6] for c in cols])), consts, 10_000,
                    lease)
        done = torch_wgl.carry_to_numpy(carry)
        assert not _running(done)
        _same(body(carry, consts), done, "past the verdict")


# ---------------------------------------------------------------------------
# (c) the captured step makes no host read

class NoHostReads(StubGraph):
    """A stub whose replays raise on any read back to the host."""

    def replay(self):
        def refuse(*a, **k):
            raise AssertionError("a host read inside the captured step")
        saved = {name: getattr(torch.Tensor, name)
                 for name in ("item", "tolist", "__bool__", "cpu",
                              "numpy")}
        try:
            for name in saved:
                setattr(torch.Tensor, name, refuse)
            super().replay()
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)
        self.replays = getattr(self, "replays", 0) + 1


@pytest.mark.parametrize("kernel", [True, False])
def test_captured_step_makes_no_host_read(stub, monkeypatch, kernel):
    monkeypatch.setattr(chunk_graph, "GRAPH", NoHostReads)
    *_, (init, _, run), consts, st0 = _single("cas-register", False,
                                              kernel)
    with chunk_graph.Lease() as lease:
        carry = run(init(st0[None]), consts, 4, lease)
        assert lease.entry is not None, "no graph was captured"
        # the first iteration eager, the next three replayed
        assert lease.entry.graph.replays == 3
        assert int(carry[torch_wgl.IDX_IT][0]) == 4


def test_batch_captured_step_makes_no_host_read(stub, monkeypatch):
    """The scan rollout of a batch, whose chains die within R steps: the
    eager CPU loop would stop reading them there; a graph never does."""
    monkeypatch.setattr(chunk_graph, "GRAPH", NoHostReads)
    _, tspec, cols, salts, (n, B, S, C, A, W, O, T) = _batch(
        "unordered-queue")
    init, _, run = torch_wgl._build_search(
        tspec.step, 4, n, B, S, C, A, W, O, T, R=min(256, n), NS=1,
        rollout_kernel="scan", device="cpu")
    consts = torch_wgl.make_batch_consts([c[:6] for c in cols], salts,
                                         "cpu")
    with chunk_graph.Lease() as lease:
        run(init(np.stack([c[6] for c in cols])), consts, 3, lease)
        assert lease.entry.graph.replays == 2


# ---------------------------------------------------------------------------
# (d) the launch counter

class RecordingStub(StubGraph):
    """A stub whose capture runs the step's Python once, as a real
    capture does (recording its launches, not running them on a card;
    here the CPU work runs too)."""

    def capture(self, fn):
        self.fn = fn
        fn()


def _stub_entry(k_launches, key="k", nbytes=0):
    """An entry over a one-tensor carry whose step 'launches' the
    rollout kernel ``k_launches`` times."""
    carry = (torch.zeros(4, dtype=torch.int64),)

    def body(c, consts):
        for _ in range(k_launches):
            rollout._note_launch()
        return (c[0] + 1,)

    entry = chunk_graph.Entry(key, body, lambda c: c[0][:1] < 3, carry,
                              (torch.zeros(nbytes // 8, dtype=torch.int64),),
                              torch.device("cpu"))
    return entry


def test_launch_counter_adds_captured_launches_per_replay(stub,
                                                          monkeypatch):
    monkeypatch.setattr(rollout, "launches", 0)
    monkeypatch.setattr(chunk_graph, "GRAPH", RecordingStub)
    entry = _stub_entry(3)
    assert rollout.launches == 0, "a capture adds nothing to the count"
    assert entry.launches == 3, "the capture's own count"
    assert entry.carry[0].tolist() == [1] * 4
    flags = [entry.replay() for _ in range(4)]
    assert rollout.launches == 12
    assert flags == [True, False, False, False]
    assert entry.carry[0].tolist() == [5] * 4
    # outside a capture the wrapper's count is the process's again
    rollout._note_launch()
    assert rollout.launches == 13
    with rollout.counting_captured() as n:
        rollout._note_launch()
    assert n == [1] and rollout.launches == 13


# ---------------------------------------------------------------------------
# (e) the cache

def test_graph_key_names_the_shape_the_rollout_and_the_device():
    step = tm.cas_register_spec.step
    args = (step, 1, 128, 4, 1, 4, 2, 8, 1024, 1024)

    def key(*a, **k):
        return torch_wgl._build_search(*a, device="cpu", **k)[2].graph_key

    assert key(*args) == key(*args)
    assert key(*args) != key(step, 2, *args[2:])            # K
    assert key(*args) != key(*args[:7], 16, *args[8:])      # W
    assert key(*args) != key(tm.mutex_spec.step, *args[1:])  # the step
    assert key(*args, rollout_kernel="kernel") != key(
        *args, rollout_kernel="scan")                       # the rollout
    assert key(*args)[-1] == "cpu"


def test_one_owner_per_graph(stub):
    a, b, c = (chunk_graph.Lease() for _ in range(3))
    first = _stub_entry(0)
    a.entry = first
    # a graph held by a search is no other search's: b finds none
    assert b.holds("k", first.carry, first.consts)[0] is None
    second = b.entry = _stub_entry(0)
    a.release()
    b.release()
    assert chunk_graph.stats()["cached"] == 2
    # the most recently released graph of the key comes back first
    got, carry = c.holds("k", (torch.full((4,), 7),),
                         (torch.zeros(0, dtype=torch.int64),))
    assert got is second and carry is got.carry
    assert got.carry[0].tolist() == [7] * 4, "the carry is copied in"
    assert chunk_graph.hits == 1
    assert c.holds("other", got.carry, got.consts)[0] is None
    assert c.entry is None, "a lease holds one shape at a time"
    assert chunk_graph.stats()["cached"] == 2


def test_cache_is_bounded_by_bytes_least_recent_first(stub, monkeypatch):
    monkeypatch.setattr(chunk_graph, "CACHE_BYTES", 1000)
    entries = [_stub_entry(0, key=i, nbytes=400) for i in range(3)]
    graphs = [e.graph for e in entries]
    assert all(e.nbytes == 432 for e in entries)
    for e in entries:
        lease = chunk_graph.Lease()
        lease.entry = e
        lease.release()
    # three of 432 bytes do not fit 1000: the first released went
    assert chunk_graph.evictions == 1 and graphs[0].closed
    assert chunk_graph.stats()["cached"] == 2
    assert chunk_graph.stats()["cached_bytes"] == 864
    assert chunk_graph.Lease().holds(0, entries[0].carry,
                                     entries[0].consts)[0] is None
    # a graph larger than the bound is freed when its search ends
    big = _stub_entry(0, key="big", nbytes=2000)
    big_graph = big.graph
    with chunk_graph.Lease() as lease:
        lease.entry = big
    assert big_graph.closed and chunk_graph.evictions == 2
    assert chunk_graph.stats()["cached"] == 2


def test_the_bound_under_a_budget_is_what_the_slots_leave(stub):
    assert chunk_graph.budget_bound(64 << 30, 943, 72_812_796) == (
        (64 << 30) - 943 * 72_812_796)
    assert chunk_graph.budget_bound(1 << 30, 20, 72_812_796) == 0
    assert chunk_graph.budget_bound(1 << 40, 1, 1) == chunk_graph.CACHE_BYTES
    entries = [_stub_entry(0, key=i, nbytes=400) for i in range(2)]
    for e in entries:
        lease = chunk_graph.Lease()
        lease.entry = e
        lease.release()
    saved = chunk_graph.CACHE_BYTES
    with chunk_graph.bounded(500):
        # what no longer fits is evicted at once, least recent first
        assert chunk_graph.CACHE_BYTES == 500
        assert chunk_graph.stats()["cached"] == 1
        assert entries[0].graph is None and entries[1].graph is not None
    assert chunk_graph.CACHE_BYTES == saved


def test_a_campaign_under_a_budget_bounds_the_graph_cache():
    from jepsen_tpu_torch import cli
    plan = {"hbm": {"budget_bytes": 1 << 30,
                    "per_cell_peak_bytes": 100 << 20}}
    saved = chunk_graph.CACHE_BYTES
    with cli.graph_cache_bound(plan, 4):
        assert chunk_graph.CACHE_BYTES == (1 << 30) - 4 * (100 << 20)
    assert chunk_graph.CACHE_BYTES == saved
    for p, slots in ((None, 4), ({"hbm": {"budget_bytes": None}}, 4),
                     (plan, None)):
        with cli.graph_cache_bound(p, slots):
            assert chunk_graph.CACHE_BYTES == saved


# ---------------------------------------------------------------------------
# the profile's count of the host's launch calls

def test_host_launches_count_a_graph_launch_as_one():
    def call(t, name="cudaLaunchKernel"):
        return (t, t + 1.0, name, False)

    ev = ([call(0), call(1)]                      # the eager iteration
          + [call(2 + i, "cudaLaunchKernel" + CAPTURED) for i in range(5)]
          + [call(10, "cudaGraphLaunch"), (11, 20, "k", True)]
          + [call(30, "cudaGraphLaunch"), call(31), call(32)]
          + [call(40, "cudaGraphLaunch"), call(50, "cudaGraphLaunch")]
          # a new width: its eager iteration and capture, then replays
          + [call(51), call(52, "cudaLaunchKernel" + CAPTURED)]
          + [call(60, "cudaGraphLaunch"), call(70, "cudaGraphLaunch")]
          + [call(80, "cudaMemcpyAsync")])
    got = host_launches(ev, 11)
    assert got["host_launches"] == 11 and got["graph_launches"] == 6
    assert got["captured_launch_calls"] == 6
    assert got["host_launches_per_iteration"] == 1.0
    # intervals 10-30 (1), 30-40 (3), 40-50 (1), 60-70 (1); 50-60 holds
    # a capture
    assert got["host_launches_per_replayed_iteration"] == 6 / 4
