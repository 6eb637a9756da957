"""The port's ``core.run`` end to end against an in-memory "cluster":
dummy remote + atom DB/client. The JAX package's cases
(``tests/test_core.py``, after the reference's
jepsen/test/jepsen/core_test.clj:62-222) run against
``jepsen_tpu_torch``; the last two hold the histories the port records
against the JAX package's ``checkers.linearizable`` (equal verdicts)."""

import collections
import itertools
import random
import time

import pytest

from jepsen_tpu.checker import checkers as jcheckers
from jepsen_tpu_torch import checker as jchecker
from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import core
from jepsen_tpu_torch import db as jdb
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import os as jos
from jepsen_tpu_torch import store
from jepsen_tpu_torch import tests as tst
from jepsen_tpu_torch.checker import checkers
from jepsen_tpu_torch.tests import Atom


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))


def dummy_test(**kw):
    t = tst.noop_test()
    t["ssh"] = {"dummy?": True}
    t.update(kw)
    return t


class TrackingClient(jclient.Client):
    """Tracks open connections in a shared set (core_test.clj:22-40)."""

    def __init__(self, conns, uid_counter=None, uid=None):
        self.conns = conns
        self.uid_counter = uid_counter or Atom(0)
        self.uid = uid

    def open(self, test, node):
        uid = self.uid_counter.swap(lambda x: x + 1)
        self.conns.swap(lambda s: s | {uid})
        return TrackingClient(self.conns, self.uid_counter, uid)

    def invoke(self, test, op):
        out = dict(op)
        out["type"] = "ok"
        return out

    def close(self, test):
        self.conns.swap(lambda s: s - {self.uid})


def test_most_interesting_exception():
    """DB setup failures propagate the interesting exception, not a barrier
    error (core_test.clj:42-60)."""

    class BadDB(jdb.DB):
        def setup(self, test, node):
            if node == test["nodes"][2]:
                raise RuntimeError("hi")
            raise core.BarrierTimeout("oops")

    t = dummy_test(name="interesting-exception", db=BadDB())
    with pytest.raises(RuntimeError, match="^hi$"):
        core.run(t)


def test_basic_cas():
    """1000 ops at concurrency 10 through the full run lifecycle
    (core_test.clj:62-120)."""
    state = Atom(None)
    meta_log = Atom([])
    n = 1000
    rng = random.Random(45100)
    t = dummy_test(
        name="basic-cas",
        db=tst.atom_db(state),
        client=tst.atom_client(state, meta_log),
        concurrency=10,
        generator=gen.phases(
            # MUST be wrapped in clients: a bare map op fills in "some
            # free process" from the whole context, occasionally landing
            # on the NEMESIS thread, which rejects client ops -- seen as
            # a rare flake where reads[0] was a phase-2 read
            gen.clients({"f": "read"}),
            # barrier: the phase-1 read must *complete* before phase 2's
            # writes dispatch, or the first ok read may not see 0
            gen.synchronize(gen.clients(gen.limit(n, gen.reserve(
                5, gen.repeat({"f": "read"}),
                gen.mix([
                    lambda: {"f": "write", "value": rng.randint(0, 4)},
                    lambda: {"f": "cas",
                             "value": [rng.randint(0, 4),
                                       rng.randint(0, 4)]},
                ])))))),
    )
    test = core.run(t)
    hist = test["history"]

    # db teardown ran
    assert state.deref() == "done"

    # client lifecycle: n opens+setups first, then per-process open/close
    # churn, then n teardowns+closes (core_test.clj:101-110)
    log = meta_log.deref()
    nn = len(test["nodes"])
    setup = collections.Counter(log[:2 * nn])
    run_phase = collections.Counter(log[2 * nn:len(log) - 2 * nn])
    teardown = collections.Counter(log[len(log) - 2 * nn:])
    assert setup == {"open": nn, "setup": nn}
    assert run_phase["open"] == run_phase["close"]
    assert teardown == {"teardown": nn, "close": nn}

    assert test["results"]["valid"] is True

    oks = [o for o in hist if h.ok(o)]
    reads = [o for o in oks if o["f"] == "read"]
    # a crashed phase-1 worker would turn the barrier read into :info and
    # make reads[0] a phase-2 read; surface that case explicitly (seen
    # once as a bare "4 == 0" under full-suite load)
    infos = [o for o in hist if o["type"] == "info"]
    assert reads[0]["value"] == 0, (reads[0], infos[:3])

    assert len(hist) == 2 * (n + 1)
    assert {o["f"] for o in hist} == {"read", "write", "cas"}
    assert all(o.get("value") is None
               for o in hist if h.invoke(o) and o["f"] == "read")
    assert all(0 <= o["value"] <= 4 for o in reads)
    assert all(0 <= o["value"] <= 4
               for o in hist if o["f"] == "write")
    assert all(isinstance(o["value"], list) and len(o["value"]) == 2
               for o in hist if o["f"] == "cas")

    # indexes are monotone after analyze
    assert [o["index"] for o in hist] == list(range(len(hist)))


def test_store_layout_written():
    """run writes history + results + test.json + symlinks."""
    state = Atom(None)
    t = dummy_test(
        name="store-layout",
        db=tst.atom_db(state),
        client=tst.atom_client(state),
        concurrency=2,
        generator=gen.clients(gen.limit(10, gen.repeat({"f": "read"}))),
    )
    test = core.run(t)
    import json
    import os as stdos
    d = store.path(test)
    for f in ("history.txt", "history.jsonl", "results.json", "test.json",
              "jepsen.log"):
        assert stdos.path.exists(stdos.path.join(d, f)), f
    assert stdos.path.islink(stdos.path.join(store.base_dir, "latest"))
    assert stdos.path.islink(stdos.path.join(store.base_dir, "current"))
    with open(stdos.path.join(d, "results.json")) as fh:
        assert json.load(fh)["valid"] is True
    # loadable for offline re-analysis
    loaded = store.load(test["name"], test["start-time"])
    assert len(loaded["history"]) == len(test["history"])
    re_res = jchecker.check_safe(jchecker.unbridled_optimism(), loaded,
                                 loaded["history"])
    assert re_res["valid"] is True


def test_worker_recovery():
    """Workers consume exactly n ops even when every op crashes
    (core_test.clj:179-198)."""
    invocations = Atom(0)
    n = 12

    class CrashClient(jclient.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            invocations.swap(lambda x: x + 1)
            raise ZeroDivisionError("1/0")

    t = dummy_test(
        name="worker-recovery",
        client=CrashClient(),
        checker=jchecker.unbridled_optimism(),
        generator=gen.nemesis(None,
                              gen.limit(n, gen.repeat({"f": "read"}))),
    )
    core.run(t)
    assert invocations.deref() == n


def test_generator_recovery():
    """A generator exception propagates out of run and doesn't leak client
    connections, even with a synchronize barrier in the generator
    (core_test.clj:200-222)."""
    conns = Atom(frozenset())

    def boom(test, ctx):
        if list(ctx.free_threads) == [0]:
            raise ZeroDivisionError("1/0")
        return {"type": "invoke", "f": "meow"}

    t = dummy_test(
        name="generator-recovery",
        client=TrackingClient(conns),
        generator=gen.clients(gen.phases(
            gen.each_thread(gen.once(boom)),
            gen.once({"type": "invoke", "f": "done"}))),
    )
    with pytest.raises(Exception,
                       match="ZeroDivisionError|1/0|Divide|division"):
        core.run(t)
    assert conns.deref() == frozenset()


def test_worker_error_setup_teardown():
    """Errors in client setup are rethrown from run (core_test.clj
    worker-error-test)."""

    class BadSetup(jclient.Client):
        def open(self, test, node):
            return self

        def setup(self, test):
            raise RuntimeError("client setup broke")

        def invoke(self, test, op):
            out = dict(op)
            out["type"] = "ok"
            return out

    t = dummy_test(name="worker-error", client=BadSetup(),
                   generator=gen.clients(gen.limit(
                       2, gen.repeat({"f": "read"}))))
    with pytest.raises(RuntimeError, match="client setup broke"):
        core.run(t)


def test_os_db_lifecycle_order():
    """OS setup -> DB cycle (teardown, setup) -> run -> DB teardown -> OS
    teardown, across all nodes (core.clj:326-397 nesting)."""
    events = []

    class TOS(jos.OS):
        def setup(self, test, node):
            events.append(("os-setup", node))

        def teardown(self, test, node):
            events.append(("os-teardown", node))

    class TDB(jdb.DB):
        def setup(self, test, node):
            events.append(("db-setup", node))

        def teardown(self, test, node):
            events.append(("db-teardown", node))

    t = dummy_test(name="lifecycle", os=TOS(), db=TDB(),
                   nodes=["n1", "n2"], concurrency=2,
                   generator=gen.clients(gen.limit(
                       2, gen.repeat({"f": "read"}))))
    core.run(t)
    kinds = [k for k, _ in events]
    # per-phase grouping: os setup first, then db teardown+setup (cycle),
    # final db teardown, then os teardown
    assert kinds[:2] == ["os-setup"] * 2
    assert sorted(kinds[2:6]) == ["db-setup"] * 2 + ["db-teardown"] * 2
    assert kinds[2:4] == ["db-teardown"] * 2   # cycle tears down first
    assert kinds[6:8] == ["db-teardown"] * 2
    assert kinds[8:] == ["os-teardown"] * 2


def test_db_cycle_retries():
    """SetupFailed triggers teardown+setup retry up to 3 tries
    (db.clj:121-158)."""
    attempts = Atom(0)

    class FlakyDB(jdb.DB):
        def setup(self, test, node):
            if node == test["nodes"][0]:
                n = attempts.swap(lambda x: x + 1)
                if n < 3:
                    raise jdb.SetupFailed("not yet")

        def teardown(self, test, node):
            pass

    t = dummy_test(name="db-retry", db=FlakyDB(),
                   generator=gen.clients(gen.limit(
                       1, gen.repeat({"f": "read"}))))
    core.run(t)
    assert attempts.deref() == 3


def test_db_cycle_exhausts_retries():
    class AlwaysFail(jdb.DB):
        def setup(self, test, node):
            raise jdb.SetupFailed("nope")

    t = dummy_test(name="db-retry-fail", db=AlwaysFail(),
                   generator=None)
    with pytest.raises(jdb.SetupFailed):
        core.run(t)


def test_primary_setup():
    """Primary setup runs once, on the first node (db.clj:141-146)."""
    primaries = Atom([])

    class PDB(jdb.DB, jdb.Primary):
        def setup(self, test, node):
            pass

        def teardown(self, test, node):
            pass

        def primaries(self, test):
            return [test["nodes"][0]]

        def setup_primary(self, test, node):
            primaries.conj(node)

    t = dummy_test(name="primary", db=PDB(),
                   generator=gen.clients(gen.limit(
                       1, gen.repeat({"f": "read"}))))
    core.run(t)
    assert primaries.deref() == ["n1"]


def test_log_snarfing_dummy(tmp_path):
    """LogFiles are downloaded into the store dir per node
    (core.clj:102-136). With a dummy remote the download is logged but the
    store node dirs exist."""

    class LDB(jdb.DB, jdb.LogFiles):
        def setup(self, test, node):
            pass

        def teardown(self, test, node):
            pass

        def log_files(self, test, node):
            return ["/var/log/db.log"]

    t = dummy_test(name="snarf", db=LDB(),
                   generator=gen.clients(gen.limit(
                       1, gen.repeat({"f": "read"}))))
    test = core.run(t)
    cmds = [cmd for _, cmd in test.get("dummy-log", [])]
    # dummy remote "succeeds" at the exists? check, so a download per node
    assert any("download" in cmd for cmd in cmds
               if cmd and "download" in cmd) or \
        any("test -e" in cmd or "[ -e" in cmd or "ls" in cmd
            for cmd in cmds if cmd)


def test_synchronize_barrier():
    """synchronize blocks until all nodes arrive (core.clj:44-57)."""
    order = []

    class SyncDB(jdb.DB):
        def setup(self, test, node):
            order.append(("pre", node))
            core.synchronize(test)
            order.append(("post", node))

        def teardown(self, test, node):
            pass

    t = dummy_test(name="sync", db=SyncDB(), nodes=["n1", "n2", "n3"],
                   concurrency=3,
                   generator=gen.clients(gen.limit(
                       1, gen.repeat({"f": "read"}))))
    core.run(t)
    pres = [i for i, (k, _) in enumerate(order) if k == "pre"]
    posts = [i for i, (k, _) in enumerate(order) if k == "post"]
    assert max(pres) < min(posts)


# ---------------------------------------------------------------------------
# histories the port records, decided by both packages' checkers

class LostWriteClient(jclient.Client):
    """A register that drops the second write of every ``every`` yet
    answers ok (not the first: a read of the initial None is a wildcard
    to the model). Every op takes effect as it starts and then sleeps
    1 ms, so ops take effect in the order they return. Run it with one
    writer thread that pauses between writes (``gen.reserve``): a
    dropped write is then never concurrent with the write that set the
    value the reads after it return, so every dropped write is visible.
    The ops are staggered, so that few are in flight at once: the proof
    that a history is invalid exhausts the orders of the ops in flight
    before the violation."""

    def __init__(self, state, every, counter=None):
        self.state = state
        self.every = every
        self.counter = counter if counter is not None else Atom(0)

    def open(self, test, node):
        return LostWriteClient(self.state, self.every, self.counter)

    def invoke(self, test, op):
        out = dict(op, type="ok")
        if op["f"] == "read":
            out["value"] = self.state.deref()
        elif self.counter.swap(lambda x: x + 1) % self.every != 2:
            self.state.reset(op["value"])
        time.sleep(0.001)
        return out


def _register_run(name, client, n_ops, seed, db=None, init=None,
                  their_algorithm="jax-wgl"):
    """Run n_ops through the port's core.run with the port's
    linearizable checker ("jax-wgl") on the CPU, then decide the
    recorded history with the JAX package's checkers.linearizable."""
    rng = random.Random(seed)
    opts = {"model": "cas-register", "algorithm": "jax-wgl"}
    if init:
        opts["init-ops"] = init
    t = dummy_test(
        name=name, db=db, client=client, concurrency=10,
        **{"certify?": False},
        checker=checkers.linearizable(
            dict(opts, engine_opts={"device": "cpu"})),
        generator=gen.clients(gen.limit(n_ops, gen.mix([
            lambda: {"f": "read"},
            lambda: {"f": "write", "value": rng.randint(0, 4)},
            lambda: {"f": "cas",
                     "value": [rng.randint(0, 4), rng.randint(0, 4)]}]))))
    if isinstance(client, LostWriteClient):
        values = itertools.count(1)
        t["generator"] = gen.clients(gen.limit(n_ops, gen.stagger(
            0.002, gen.reserve(
                1, gen.cycle(gen.once(lambda: {"f": "write",
                                               "value": next(values)}),
                             gen.sleep(0.001)),
                gen.repeat({"f": "read"})))))
    test = core.run(t)
    theirs = jcheckers.linearizable(
        dict(opts, algorithm=their_algorithm)).check({}, test["history"], {})
    return test, theirs


def test_recorded_history_decides_the_same_under_jax():
    """A valid run's history: the port's verdict equals the JAX
    package's checkers.linearizable on it (exact)."""
    state = Atom(None)
    test, theirs = _register_run(
        "xcheck-valid", tst.atom_client(state), 300, 45100,
        db=tst.atom_db(state), init=[{"f": "write", "value": 0}])
    assert len(test["history"]) == 600
    assert test["results"]["valid"] is True
    assert "error" not in test["results"]
    assert theirs["valid"] == test["results"]["valid"]


def test_lost_write_history_is_invalid_under_both():
    """A client that loses 1 write in 3 yet answers ok: both packages
    decide the recorded history invalid (the JAX package's side with its
    CPU engine, "wgl": its device search compiles for seconds on the
    CPU)."""
    # unnamed: no store, so no linear.png render (test_torch_reports
    # covers the render)
    test, theirs = _register_run(None, LostWriteClient(Atom(None), 3), 150,
                                 45101, their_algorithm="wgl")
    writes = [o for o in test["history"]
              if o["f"] == "write" and o["type"] == "ok"]
    assert len(writes) >= 3
    assert test["results"]["valid"] is False
    assert theirs["valid"] is False


# ---------------------------------------------------------------------------
# branches that need modules not ported yet raise, naming the queue item

@pytest.mark.parametrize("knob,item", [
    # the capacity plan's oracle needs analysis.capplan
    ({"capacity_plan": {"cells": []}}, r"A\.11\(d5\)"),
])
def test_unported_branches_raise(knob, item):
    """A run driven by the campaign scheduler: the branches that need a
    later sub-slice raise before the run starts (nothing recorded)."""
    from jepsen_tpu_torch.campaign import scheduler
    state = Atom(None)
    t = dummy_test(name="unported", db=tst.atom_db(state),
                   client=tst.atom_client(state), concurrency=2,
                   generator=gen.clients(gen.limit(
                       4, gen.repeat({"f": "read"}))))
    with pytest.raises(NotImplementedError, match=item):
        scheduler.run_cells([{"id": "c", "test": t}],
                            campaign_id="unported", **knob)
    assert "history" not in t and store.campaigns() == []


def test_backend_failover_runs_the_cell_on_its_tier():
    """Per-cell backend failover (``fleet.backends``, ported with the
    fleet): with the gpu tier's probe down, the scheduler applies the
    cpu tier, runs the cell and journals the tier."""
    from jepsen_tpu_torch.campaign import scheduler
    from jepsen_tpu_torch.fleet import backends
    state = Atom(None)
    t = dummy_test(name="tiered", db=tst.atom_db(state),
                   client=tst.atom_client(state), concurrency=2,
                   generator=gen.clients(gen.limit(
                       4, gen.repeat({"f": "read"}))))
    f = backends.Failover(ladder=["gpu", "cpu"],
                          probe_fn=lambda tier, timeout_s=None:
                          None if tier == "cpu" else "down")
    rep = scheduler.run_cells([{"id": "c", "test": t}],
                              campaign_id="tiered", backends=f)
    assert rep["summary"]["outcomes"] == {"True": 1}
    assert [(r["backend"], r["outcome"]) for r in
            store.latest_campaign_records("tiered")] == [("cpu", True)]


def test_a_readable_trend_baseline_runs():
    """With ``obs.trend`` ported, a readable ``trend-baseline`` no longer
    raises: the run goes through, and PL022 compares fingerprints (a
    baseline from another environment warns)."""
    import json
    import os
    base = os.path.join(store.base_dir, "trend.jsonl")
    os.makedirs(store.base_dir, exist_ok=True)
    with open(base, "w") as f:
        f.write(json.dumps({"t": 0, "fingerprint": {"hostname": "elsewhere"},
                            "rungs": {}}) + "\n")
    state = Atom(None)
    t = dummy_test(name="trend", db=tst.atom_db(state),
                   client=tst.atom_client(state), concurrency=2,
                   generator=gen.clients(gen.limit(
                       4, gen.repeat({"f": "read"}))),
                   **{"trend-baseline": base})
    t = core.run(t)
    assert t["results"]["valid"] is True
    codes = [(d["code"], d["severity"])
             for d in t["analysis"]["plan"]["diagnostics"]]
    assert ("PL022", "warning") in codes
