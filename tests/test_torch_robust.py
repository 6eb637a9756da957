"""The port's fault-tolerant harness core (jepsen_tpu_torch/robust/):
the JAX package's cases (``tests/test_robust.py``) against the port:
wedged-worker watchdog, graceful abort + partial-history salvage, the
incremental store journal (kill -9 survivable), barrier reset across DB
retries, and the unified retry policy."""

import glob
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

import pytest

from jepsen_tpu_torch import client as jc
from jepsen_tpu_torch import analysis
from jepsen_tpu_torch import core
from jepsen_tpu_torch import db as jdb
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import interpreter, nemesis, obs, robust, store, util
from jepsen_tpu_torch import tests as tst
from jepsen_tpu_torch.control import remotes
from jepsen_tpu_torch.robust import AbortLatch, RetryPolicy
from jepsen_tpu_torch.tests import Atom


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))


@pytest.fixture(autouse=True)
def fast_cycle_policy(monkeypatch):
    monkeypatch.setattr(jdb, "CYCLE_RETRY_POLICY",
                        RetryPolicy(tries=jdb.CYCLE_TRIES, base_s=0.0,
                                    jitter=0.0))


def dummy_test(**kw):
    t = tst.noop_test()
    t["ssh"] = {"dummy?": True}
    t.update(kw)
    return t


NO_BACKOFF = RetryPolicy(tries=5, base_s=0.0, jitter=0.0)


# ---------------------------------------------------------------------------
# wedged-worker watchdog


class WedgingClient(jc.Client):
    """First invocation blocks on ``release`` forever; the rest are ok."""

    def __init__(self, release):
        self.release = release
        self._lock = threading.Lock()
        self._wedged = False

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        # harness bookkeeping must never reach the client
        assert "__op_serial__" not in op
        with self._lock:
            first = not self._wedged
            self._wedged = True
        if first:
            self.release.wait()
        out = dict(op)
        out["type"] = "ok"
        return out


def test_wedged_client_completes_as_info_and_run_finishes():
    """A client that blocks forever yields an :info harness-timeout op,
    the worker is replaced, and the run completes within its deadline."""
    release = threading.Event()
    n = 10
    test = {"concurrency": 2, "nodes": ["n1", "n2"],
            "client": WedgingClient(release), "nemesis": nemesis.noop,
            "op-timeout-ms": 300,
            "generator": gen.clients(
                gen.limit(n, gen.repeat({"f": "read"})))}
    t0 = time.monotonic()
    try:
        h = interpreter.run(test)
    finally:
        release.set()
    assert time.monotonic() - t0 < 30

    invokes = [o for o in h if o["type"] == "invoke"]
    oks = [o for o in h if o["type"] == "ok"]
    infos = [o for o in h if o["type"] == "info"]
    assert len(invokes) == n
    assert len(infos) == 1
    assert infos[0]["error"] == "harness-timeout"
    assert len(oks) == n - 1
    # the successor process took over the wedged worker's thread
    wedged_proc = infos[0]["process"]
    assert any(o["process"] != wedged_proc for o in invokes)
    # the serial bookkeeping never leaks into the history
    assert all("__op_serial__" not in o for o in h)


def test_watchdog_off_by_default():
    """No op-timeout-ms -> no watchdog thread (reference semantics)."""

    class QuickClient(jc.Client):
        def invoke(self, test, op):
            out = dict(op)
            out["type"] = "ok"
            return out

    test = {"concurrency": 2, "nodes": ["n1"], "client": QuickClient(),
            "nemesis": nemesis.noop,
            "generator": gen.clients(
                gen.limit(4, gen.repeat({"f": "read"})))}
    interpreter.run(test)
    assert not any(t.name == "jepsen watchdog"
                   for t in threading.enumerate())


# ---------------------------------------------------------------------------
# graceful abort: latch, hard time limit, drain write-off


class OkClient(jc.Client):
    def invoke(self, test, op):
        time.sleep(0.002)
        out = dict(op)
        out["type"] = "ok"
        return out


def test_hard_time_limit_aborts_and_returns_history():
    test = {"concurrency": 2, "nodes": ["n1"], "client": OkClient(),
            "nemesis": nemesis.noop, "time-limit-s": 0.5,
            "generator": gen.clients(gen.repeat({"f": "read"}))}
    t0 = time.monotonic()
    h = interpreter.run(test)
    assert time.monotonic() - t0 < 15
    assert test["aborted"] == "time-limit"
    assert len(h) > 0
    # well-formed prefix: every completion pairs with an invocation
    open_ = set()
    for o in h:
        if o["type"] == "invoke":
            assert o["process"] not in open_
            open_.add(o["process"])
        else:
            open_.discard(o["process"])


def test_abort_drain_writes_off_wedged_ops():
    """Ops still outstanding when the drain grace expires complete as
    :info harness-abort rather than dangling (or hanging the loop)."""
    release = threading.Event()

    class AlwaysWedged(jc.Client):
        def invoke(self, test, op):
            release.wait()
            out = dict(op)
            out["type"] = "ok"
            return out

    latch = AbortLatch()
    test = {"concurrency": 2, "nodes": ["n1"], "client": AlwaysWedged(),
            "nemesis": nemesis.noop, "abort": latch,
            "abort-grace-s": 0.3,
            "generator": gen.clients(gen.repeat({"f": "read"}))}
    timer = threading.Timer(0.3, latch.set, args=("test-abort",))
    timer.start()
    try:
        h = interpreter.run(test)
    finally:
        release.set()
        timer.cancel()
    assert test["aborted"] == "test-abort"
    aborted = [o for o in h if o.get("error") == "harness-abort"]
    assert aborted and all(o["type"] == "info" for o in aborted)


def test_sigint_salvages_partial_history():
    """A real SIGINT mid-run flips the abort latch: the run returns, the
    salvaged prefix is persisted, checked, and marked salvaged."""
    fired = threading.Event()

    class SigintAfter(jc.Client):
        def __init__(self, after):
            self.after = after
            self.count = Atom(0)

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            n = self.count.swap(lambda x: x + 1)
            if n == self.after and not fired.is_set():
                fired.set()
                os.kill(os.getpid(), signal.SIGINT)
            out = dict(op)
            out["type"] = "ok"
            return out

    t = dummy_test(name="sigint-salvage", concurrency=2,
                   nodes=["n1", "n2"],
                   client=SigintAfter(5),
                   generator=gen.clients(gen.repeat({"f": "read"})))
    t0 = time.monotonic()
    test = core.run(t)
    assert time.monotonic() - t0 < 60
    assert test["aborted"] == "SIGINT"
    assert test["results"]["salvaged"] is True
    assert test["results"]["abort-reason"] == "SIGINT"
    assert test["results"]["valid"] is True
    assert len(test["history"]) >= 5
    d = store.path(test)
    assert os.path.exists(os.path.join(d, "history.jsonl"))
    assert os.path.exists(os.path.join(d, "results.json"))
    # journal finalized away once the real history landed
    assert not os.path.exists(os.path.join(d, store.JOURNAL_FILE))
    with open(os.path.join(d, "results.json")) as f:
        assert json.load(f)["salvaged"] is True


def test_abort_latch_first_reason_wins():
    latch = AbortLatch()
    assert not latch.is_set()
    latch.set("SIGINT")
    latch.set("SIGTERM")
    assert latch.is_set()
    assert latch.reason == "SIGINT"
    assert latch.note_signal() == 1
    assert latch.note_signal() == 2


def test_exception_abort_salvages_history():
    """A nemesis/generator crash mid-run persists and checks the
    history-so-far before the exception propagates."""
    boom = Atom(0)

    def exploding(test, ctx):
        if boom.swap(lambda x: x + 1) > 6:
            raise RuntimeError("nemesis exploded")
        return {"f": "read"}

    t = dummy_test(name="crash-salvage", concurrency=2,
                   nodes=["n1", "n2"], client=OkClient(),
                   generator=gen.clients(exploding))
    with pytest.raises(Exception) as ei:
        core.run(t)
    assert "exploded" in str(ei.value) \
        or "exploded" in str(ei.value.__cause__)
    # salvage persisted history + results with salvaged marker
    runs = glob.glob(os.path.join(store.base_dir, "crash-salvage", "2*"))
    assert len(runs) == 1
    with open(os.path.join(runs[0], "results.json")) as f:
        results = json.load(f)
    assert results["salvaged"] is True
    with open(os.path.join(runs[0], "history.jsonl")) as f:
        hist = [json.loads(ln) for ln in f if ln.strip()]
    assert hist, "salvaged history should be non-empty"


# ---------------------------------------------------------------------------
# kill -9: the incremental journal survives


_KILL9_CHILD = """
import os, sys, time
sys.path.insert(0, sys.argv[2])
from jepsen_tpu_torch import client as jc, core, generator as gen, store
store.base_dir = sys.argv[1]

class SlowClient(jc.Client):
    def invoke(self, test, op):
        time.sleep(0.01)
        out = dict(op)
        out["type"] = "ok"
        return out

core.run({"name": "kill9", "nodes": ["n1"], "concurrency": 1,
          "ssh": {"dummy?": True}, "client": SlowClient(), "obs?": False,
          "generator": gen.clients(gen.repeat({"f": "read"}))})
"""


def test_kill9_leaves_readable_journal(tmp_path):
    base = str(tmp_path / "store")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JEPSEN_PYTEST_TIMEOUT_S="0")
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL9_CHILD, base, repo],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        pattern = os.path.join(base, "kill9", "*", store.JOURNAL_FILE)
        deadline = time.monotonic() + 60
        journal = None
        while time.monotonic() < deadline:
            hits = glob.glob(pattern)
            if hits and os.path.getsize(hits[0]) > 400:
                journal = hits[0]
                break
            time.sleep(0.05)
        assert journal, "child never journaled any ops"
    finally:
        if proc.poll() is None:
            proc.kill()   # SIGKILL: no teardown, no finalize
        proc.wait()

    # no history.jsonl was ever finalized -- only the journal survives
    run_dir = os.path.dirname(journal)
    assert not os.path.exists(os.path.join(run_dir, "history.jsonl"))
    with open(journal) as f:
        ops = [json.loads(ln) for ln in f if ln.strip()]
    assert len(ops) >= 2
    assert ops[0]["type"] == "invoke" and ops[0]["f"] == "read"
    # store.load_history falls back to the journal
    test_key = {"name": "kill9",
                "start-time": os.path.basename(run_dir)}
    old = store.base_dir
    store.base_dir = base
    try:
        hist = store.load_history(test_key)
    finally:
        store.base_dir = old
    assert len(hist) == len(ops)


def test_load_history_drops_torn_journal_line(tmp_path):
    t = {"name": "torn", "start-time": store.local_time()}
    p = store.make_path(t, store.JOURNAL_FILE)
    with open(p, "w") as f:
        f.write(json.dumps({"type": "invoke", "f": "read",
                            "process": 0}) + "\n")
        f.write(json.dumps({"type": "ok", "f": "read",
                            "process": 0}) + "\n")
        f.write('{"type": "invoke", "f": "re')  # killed mid-append
    hist = store.load_history(t)
    assert len(hist) == 2


# ---------------------------------------------------------------------------
# barrier poisoning across db.cycle retries


def test_barrier_reset_across_cycle_retries():
    """Attempt 1 breaks the setup barrier (one node fails setup, its
    sibling's synchronize times out); the retry must see a RESET
    barrier, not the permanently-poisoned one."""
    attempts = Atom(0)

    class BarrierBreakingDB(jdb.DB):
        def setup(self, test, node):
            if node == test["nodes"][0]:
                n = attempts.swap(lambda x: x + 1)
                if n == 1:
                    raise jdb.SetupFailed("first attempt fails")
                core.synchronize(test)
            else:
                # short timeout: attempt 1 times out here, POISONING the
                # barrier for every later wait until it is reset
                core.synchronize(test, timeout_s=0.5)

        def teardown(self, test, node):
            pass

    t = dummy_test(name="barrier-reset", db=BarrierBreakingDB(),
                   nodes=["n1", "n2"], concurrency=2,
                   generator=gen.clients(
                       gen.limit(2, gen.repeat({"f": "read"}))))
    test = core.run(t)
    assert attempts.deref() == 2
    assert test["results"]["valid"] is True


# ---------------------------------------------------------------------------
# unified retry policy


def test_backoff_geometric_growth_and_cap():
    p = RetryPolicy(tries=6, base_s=0.1, multiplier=2.0, jitter=0.0,
                    max_backoff_s=0.5)
    assert [round(p.backoff_s(i), 3) for i in range(5)] \
        == [0.1, 0.2, 0.4, 0.5, 0.5]


def test_backoff_jitter_bounds():
    p = RetryPolicy(base_s=1.0, jitter=0.25)
    rng = random.Random(7)
    for _ in range(200):
        assert 0.75 <= p.backoff_s(0, rng=rng) <= 1.25


def test_call_retries_on_result_predicate():
    calls = []

    def f():
        calls.append(1)
        return {"exit": 255} if len(calls) < 3 else {"exit": 0}

    out = NO_BACKOFF.call(f, retry_on_result=lambda r: r["exit"] != 0)
    assert out == {"exit": 0}
    assert len(calls) == 3


def test_call_exhaustion_returns_last_result():
    out = RetryPolicy(tries=3, base_s=0.0, jitter=0.0).call(
        lambda: {"exit": 255}, retry_on_result=lambda r: True)
    assert out == {"exit": 255}


def test_call_reraises_after_exhaustion():
    calls = []

    def f():
        calls.append(1)
        raise ValueError("still broken")

    with pytest.raises(ValueError, match="still broken"):
        RetryPolicy(tries=3, base_s=0.0, jitter=0.0).call(f)
    assert len(calls) == 3


def test_call_non_retryable_exception_propagates_immediately():
    calls = []

    def f():
        calls.append(1)
        raise ValueError("not retryable")

    with pytest.raises(ValueError):
        NO_BACKOFF.call(f, retry_on_exception=(KeyError,))
    assert len(calls) == 1


def test_call_respects_max_elapsed_budget():
    p = RetryPolicy(tries=1000, base_s=0.05, multiplier=1.0, jitter=0.0,
                    max_elapsed_s=0.12)
    calls = []

    def f():
        calls.append(1)
        raise ValueError("nope")

    t0 = time.monotonic()
    with pytest.raises(ValueError):
        p.call(f)
    assert time.monotonic() - t0 < 2
    assert len(calls) < 10


# ---------------------------------------------------------------------------
# RetryRemote: status-aware retry of subprocess transports


class FlakyRemote(remotes.DummyRemote):
    """Fails at the transport layer (result dicts, no exception) until
    ``failures`` runs out."""

    def __init__(self, failures, fail_result):
        super().__init__()
        self.failures = failures
        self.fail_result = fail_result
        self.calls = 0

    def connect(self, conn_spec):
        return self

    def execute(self, ctx, action):
        self.calls += 1
        if self.calls <= self.failures:
            return dict(action, **self.fail_result)
        return dict(action, out="", err="", exit=0)


@pytest.mark.parametrize("fail_result", [
    {"exit": 255, "err": "ssh: connect refused"},
    {"exit": -1, "err": "timeout"},
])
def test_retry_remote_retries_transport_result_dicts(fail_result):
    flaky = FlakyRemote(2, fail_result)
    rr = remotes.RetryRemote(flaky, policy=NO_BACKOFF).connect({})
    out = rr.execute({}, {"cmd": "true"})
    assert out["exit"] == 0
    assert flaky.calls == 3


def test_retry_remote_returns_last_failure_when_exhausted():
    flaky = FlakyRemote(99, {"exit": -1, "err": "timeout"})
    rr = remotes.RetryRemote(
        flaky, policy=RetryPolicy(tries=3, base_s=0.0, jitter=0.0)) \
        .connect({})
    out = rr.execute({}, {"cmd": "true"})
    assert out["exit"] == -1 and out["err"] == "timeout"
    assert flaky.calls == 3


def test_transport_failed_predicate():
    assert remotes.transport_failed({"exit": 255})
    assert remotes.transport_failed({"exit": -1, "err": "timeout"})
    assert not remotes.transport_failed({"exit": 0})
    assert not remotes.transport_failed({"exit": 1, "err": "boom"})
    assert not remotes.transport_failed({"exit": -1, "err": "other"})
    assert not remotes.transport_failed(None)


# ---------------------------------------------------------------------------
# timeout_call thread accounting


def test_timeout_call_names_and_counts_abandoned_threads():
    reg = obs.Registry()
    release = threading.Event()

    def wedge_me():
        release.wait()

    with obs.bind(None, reg):
        out = util.timeout_call(50, "fellback", wedge_me)
    try:
        assert out == "fellback"
        assert any(t.name == "jepsen abandoned wedge_me"
                   for t in threading.enumerate())
        assert reg.counter_value("robust.threads_abandoned",
                                 f="wedge_me") == 1
    finally:
        release.set()


def test_timeout_call_still_returns_and_raises():
    assert util.timeout_call(1000, None, lambda: 42) == 42
    with pytest.raises(ZeroDivisionError):
        util.timeout_call(1000, None, lambda: 1 // 0)


def test_nemesis_timeout_counts_in_metrics():
    reg = obs.Registry()
    release = threading.Event()

    class Wedge(nemesis.Nemesis):
        def invoke(self, test, op):
            release.wait()
            return dict(op, type="info")

    nem = nemesis.timeout(50, Wedge())
    with obs.bind(None, reg):
        out = nem.invoke({}, {"f": "blip", "process": "nemesis",
                              "type": "info"})
    try:
        assert out["value"] == "timeout"
        assert reg.counter_value("nemesis.timeouts", f="blip") == 1
        assert reg.counter_value("robust.threads_abandoned",
                                 f="invoke") == 1
    finally:
        release.set()


# ---------------------------------------------------------------------------
# planlint PL011


def _plan(**kw):
    t = dummy_test(generator=gen.clients(
        gen.limit(1, gen.repeat({"f": "read"}))))
    t.update(kw)
    return core.prepare_test(t)


def test_pl011_op_timeout_beyond_run_deadline():
    diags = analysis.lint_plan(_plan(**{"op-timeout-ms": 120000,
                                        "time-limit-s": 60}))
    assert "PL011" in [d.code for d in diags]


def test_pl011_non_positive_knobs():
    diags = analysis.lint_plan(_plan(**{"op-timeout-ms": -5}))
    assert "PL011" in [d.code for d in diags]
    diags = analysis.lint_plan(_plan(**{"abort-grace-s": 0}))
    assert "PL011" in [d.code for d in diags]


def test_pl011_consistent_knobs_clean():
    diags = analysis.lint_plan(_plan(**{"op-timeout-ms": 500,
                                        "time-limit-s": 60,
                                        "abort-grace-s": 5}))
    assert "PL011" not in [d.code for d in diags]
