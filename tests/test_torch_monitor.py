"""The port's streaming monitor inside a run (``jepsen_tpu_torch/monitor/
core.py``) against the JAX package's, on the CPU.

1. Both packages' ``Monitor``s are driven deterministically on the same
   seeded op streams: a chunk is offered, then ``_step`` runs on the
   caller's thread, at chunks 1, 8 and 64, on the engines ``jax-wgl``,
   ``linear``, ``wgl`` and ``streamlin``, valid and falsified, keyed and
   unkeyed. ``summary()`` must be equal field for field (tolerance:
   equality), leaving out the time fields (``time_to_first_verdict_s``,
   ``detection_latency_s``, the stream block's ``device_s``). The stream
   block carries the service coalescer's counters (``coalesced_folds``,
   ``batch_peak``) on both sides; with no coalescer configured they
   read 0 and 1 and must be equal too.
2. The JAX package's ``tests/test_monitor.py`` cases on the port, except
   the campaign ones (ROADMAP.md A.11(d)).
3. Small monitored ``core.run``s on the default device engine (a few
   hundred ops): a violation aborts with ``"monitor-violation"`` and is
   certified, a clean run stays clean, the ``skip-offline?`` handoff, an
   external abort; their recorded histories decided alike by the JAX
   package's checker.
4. The port's divergences: a monitor that cannot be built raises before
   the first op; an exception on the monitor thread aborts the run and is
   re-raised by ``stop``/``finalize``; ``offer`` never raises; the
   quiescent-cut carry stays contained, counted.
"""

import glob
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from jepsen_tpu import independent as jindependent
from jepsen_tpu import monitor as jmonitor
from jepsen_tpu.checker import checkers as jcheckers
from jepsen_tpu.models import base as jbase
from jepsen_tpu.robust import ChainedLatch as JChainedLatch
from jepsen_tpu_torch import analysis
from jepsen_tpu_torch import checker as cc
from jepsen_tpu_torch import client as jc
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch import interpreter, nemesis, store
from jepsen_tpu_torch import monitor as jmon
from jepsen_tpu_torch.checker import checkers as cks
from jepsen_tpu_torch.checker import torch_wgl, wgl
from jepsen_tpu_torch.models import base as mbase
from jepsen_tpu_torch.monitor import core as mcore
from jepsen_tpu_torch.monitor import engine as mengine
from jepsen_tpu_torch.monitor.stream import StreamEncoder
from jepsen_tpu_torch.robust import AbortLatch, ChainedLatch

from test_monitor import _history

CPU = {"device": "cpu"}
SPEC = mbase.model_spec("cas-register")
JSPEC = jbase.model_spec("cas-register")
ENGINES = ("jax-wgl", "linear", "wgl", "streamlin")
TIME_FIELDS = ("time_to_first_verdict_s", "detection_latency_s")


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU checks run small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feed(mon, hist):
    for op in hist:
        mon.offer(op)


# ---------------------------------------------------------------------------
# 1. summary parity with the JAX package's Monitor


def _keyed(tuple_, falsify=None):
    """Two keys' cas-register streams interleaved op by op (key "b"
    falsified at its ``falsify``-th read), each key on its own two
    processes, values wrapped by the package's ``tuple_``."""
    per_key = {k: _history(falsify if k == "b" else None) for k in "ab"}
    out = []
    for i in range(0, len(per_key["a"]), 2):
        for j, k in enumerate("ab"):
            for op in per_key[k][i:i + 2]:
                out.append(dict(op, process=op["process"] + 2 * j,
                                value=tuple_(k, op["value"])))
    return out


def _drive(mon, hist, chunk):
    """Offer the stream; every ``chunk`` completions run one ``_step``
    on this thread, and one more at the end (the final flush)."""
    done = 0
    for op in hist:
        mon.offer(op)
        if op["type"] != "invoke" and isinstance(op.get("process"), int):
            done += 1
            if done % chunk == 0:
                mon._step()
    mon._step()
    return mon.summary()


def _comparable(summary):
    out = {k: v for k, v in summary.items() if k not in TIME_FIELDS}
    if "stream" in out:
        out["stream"] = {k: v for k, v in out["stream"].items()
                         if k != "device_s"}
    return out


@pytest.mark.parametrize("keyed", [False, True], ids=["unkeyed", "keyed"])
@pytest.mark.parametrize("falsify", [None, 4], ids=["valid", "falsified"])
@pytest.mark.parametrize("chunk", [1, 8, 64])
@pytest.mark.parametrize("engine", ENGINES)
def test_summary_equals_jax(engine, chunk, falsify, keyed):
    if keyed:
        ours, theirs = (_keyed(independent.tuple_, falsify),
                        _keyed(jindependent.tuple_, falsify))
    else:
        ours = theirs = _history(falsify)
    latch, jlatch = ChainedLatch(), JChainedLatch()
    mon = mcore.Monitor(SPEC, latch, chunk=chunk, engine=engine,
                        engine_opts=CPU, keyed=keyed)
    jmon_ = jmonitor.Monitor(JSPEC, jlatch, chunk=chunk, engine=engine,
                             keyed=keyed)
    got, want = _drive(mon, ours, chunk), _drive(jmon_, theirs, chunk)
    if engine == "streamlin":
        assert set(want["stream"]) == set(got["stream"])
        assert got["stream"]["coalesced_folds"] == 0
        assert got["stream"]["batch_peak"] == 1
    assert _comparable(got) == _comparable(want)
    assert got["verdict"] is (falsify is None)
    assert latch.is_set() is jlatch.is_set() is (falsify is not None)
    assert latch.reason == jlatch.reason
    if falsify is not None:
        assert latch.reason == mcore.ABORT_REASON
        assert isinstance(got["detection_latency_s"], float)
        assert set(mon.evidence) == set(jmon_.evidence)


# ---------------------------------------------------------------------------
# 2. the JAX package's monitor cases, on the port


def test_stream_encoder_matches_offline_encoding():
    import numpy as np
    from jepsen_tpu_torch import history as h
    hist = _history()
    enc = StreamEncoder(SPEC)
    for i, op in enumerate(hist):
        enc.offer(op, i)
    e, st = enc.materialize()
    e2, st2 = SPEC.encode(h.index([h.Op(o) for o in hist]))
    assert len(e) == len(e2)
    assert (e.f == e2.f).all()
    assert (e.args == e2.args).all()
    assert (e.ret == e2.ret).all()
    assert (e.is_ok == e2.is_ok).all()
    assert (np.argsort(e.invoke_idx) == np.argsort(e2.invoke_idx)).all()
    assert (st == st2).all()


def test_stream_encoder_fail_drop_and_info_and_open():
    from jepsen_tpu_torch.history import INF_TIME
    enc = StreamEncoder(SPEC)
    ops = [
        {"type": "invoke", "process": 0, "f": "write", "value": 1},
        {"type": "ok", "process": 0, "f": "write", "value": 1},
        {"type": "invoke", "process": 1, "f": "cas", "value": [9, 9]},
        {"type": "fail", "process": 1, "f": "cas", "value": [9, 9]},
        {"type": "invoke", "process": 2, "f": "write", "value": 2},
        {"type": "info", "process": 2, "f": "write", "value": 2},
        {"type": "invoke", "process": 3, "f": "read", "value": None},
    ]
    for i, op in enumerate(ops):
        enc.offer(op, i)
    e, _ = enc.materialize()
    assert len(e) == 3
    assert e.n_ok == 1
    assert sorted(e.return_idx.tolist()) == [1, INF_TIME, INF_TIME]


def test_stream_encoder_init_ops():
    enc = StreamEncoder(SPEC, init_ops=[{"f": "write", "value": 0}])
    ops = [{"type": "invoke", "process": 0, "f": "read", "value": None},
           {"type": "ok", "process": 0, "f": "read", "value": 0}]
    for i, op in enumerate(ops):
        enc.offer(op, i)
    e, st = enc.materialize()
    assert wgl.check_encoded(SPEC, e, st)["valid"] is True


@pytest.mark.parametrize("chunk", [1, 8, 64])
@pytest.mark.parametrize("falsify", [None, 4])
def test_monitor_matches_offline_search(chunk, falsify):
    """The threaded monitor's verdict equals the offline device search's
    (``torch_wgl`` on the CPU) on the whole stream."""
    hist = _history(falsify_at=falsify)
    e, st = SPEC.encode([dict(o, index=i) for i, o in enumerate(hist)])
    offline = torch_wgl.check_encoded(SPEC, e, st, device="cpu")
    assert offline["valid"] in (True, False)
    latch = ChainedLatch()
    mon = mcore.Monitor(SPEC, latch, chunk=chunk, engine="wgl").start()
    _feed(mon, hist)
    mon.stop()
    s = mon.summary()
    assert s["verdict"] is offline["valid"], (s, offline)
    if offline["valid"] is False:
        assert latch.is_set()
        assert latch.reason == "monitor-violation"
        assert isinstance(s["detected_at_index"], int)
        assert s["detection_latency_s"] is not None
    else:
        assert not latch.is_set()


def test_monitor_device_engine_agrees():
    """The default engine, the port's device search (on the CPU here),
    on the monitor thread."""
    latch = ChainedLatch()
    mon = mcore.Monitor(SPEC, latch, chunk=8, engine="jax-wgl",
                        engine_opts=CPU).start()
    _feed(mon, _history(falsify_at=4))
    mon.stop()
    assert mon.summary()["verdict"] is False


def test_monitor_keyed_streams():
    t = independent.tuple_
    ops = []
    for k in ("a", "b"):
        ops += [
            {"type": "invoke", "process": 0, "f": "write",
             "value": t(k, 1)},
            {"type": "ok", "process": 0, "f": "write", "value": t(k, 1)},
            {"type": "invoke", "process": 1, "f": "read",
             "value": t(k, None)},
            {"type": "ok", "process": 1, "f": "read",
             "value": t(k, 1 if k == "a" else 42)},
        ]
    mon = mcore.Monitor(SPEC, ChainedLatch(), chunk=1, engine="wgl",
                        keyed=True).start()
    _feed(mon, ops)
    mon.stop()
    s = mon.summary()
    assert s["verdict"] is False
    assert s["key"] == "b"
    assert s["keys"] == 2


class StaleRegister(jc.Client):
    """Applies the first ``apply_n`` writes, silently drops the rest
    (acked-but-lost): reads then expose staleness. Each op takes
    ``delay_s``: with instant ops the endless runs below could outpace
    the monitor thread's wake-ups by thousands of ops."""

    def __init__(self, apply_n=3, delay_s=0.001):
        self.apply_n = apply_n
        self.delay_s = delay_s
        self.value = None
        self.n = 0
        self.invokes = 0
        self.lock = threading.Lock()

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        time.sleep(self.delay_s)
        out = dict(op)
        with self.lock:
            self.invokes += 1
            if op["f"] == "write":
                self.n += 1
                if self.n <= self.apply_n:
                    self.value = op["value"]
                out["type"] = "ok"
            else:
                out["type"] = "ok"
                out["value"] = self.value
        return out


def _wr_gen():
    import itertools
    c = itertools.count(1)

    def g(test, ctx):
        n = next(c)
        if n % 2:
            return {"type": "invoke", "f": "write", "value": n}
        return {"type": "invoke", "f": "read"}

    return g


def _violating_test(**kw):
    t = {"name": "monitor-abort", "nodes": ["n1"], "concurrency": 1,
         "ssh": {"dummy?": True}, "client": StaleRegister(),
         "monitor": {"chunk": 4, "engine": "wgl"},
         "time-limit-s": 60,
         "generator": gen.clients(_wr_gen()),
         "checker": cks.linearizable({"model": "cas-register",
                                      "algorithm": "wgl"})}
    t.update(kw)
    return t


def test_monitor_aborts_run_and_offline_reproduces():
    t0 = time.monotonic()
    test = core.run(_violating_test())
    assert time.monotonic() - t0 < 30   # the generator is endless
    assert test["aborted"] == "monitor-violation"
    r = test["results"]
    assert r["salvaged"] is True
    assert r["abort-reason"] == "monitor-violation"
    m = r["monitor"]
    assert m["verdict"] is False
    assert isinstance(m["detected_at_index"], int)
    assert m["detection_latency_s"] is not None
    assert r["valid"] is False
    d = store.path(test)
    hist = store.load_history({"name": test["name"],
                               "start-time": test["start-time"]})
    e, st = SPEC.encode(hist)
    assert wgl.check_encoded(SPEC, e, st)["valid"] is False
    with open(os.path.join(d, "monitor.json")) as f:
        assert json.load(f)["verdict"] is False
    with open(os.path.join(d, "test.json")) as f:
        tj = json.load(f)
    assert "monitor-verdict" not in tj
    assert tj.get("monitor") == {"chunk": 4, "engine": "wgl"}


def test_monitor_clean_run_stays_clean():
    test = core.run(_violating_test(
        client=StaleRegister(apply_n=10**9),
        generator=gen.clients(gen.limit(20, _wr_gen()))))
    assert not test.get("aborted")
    r = test["results"]
    assert r["valid"] is True
    assert r["monitor"]["verdict"] is True
    assert r["monitor"]["ops_consumed"] >= 20
    assert "salvaged" not in r


def test_monitor_skip_offline_handoff():
    test = core.run(_violating_test(
        monitor={"chunk": 4, "engine": "wgl", "skip-offline?": True}))
    r = test["results"]
    assert r["valid"] is False
    assert r["monitor-only"] is True
    assert r["monitor"]["verdict"] is False
    # the monitor-only False is certified from the parked evidence
    assert r["monitor-certification"]["confirmed"] is True
    assert r["monitor-certification"]["counts"].get("error", 0) == 0


def test_monitor_disables_without_linearizable_gate():
    test = core.run(_violating_test(
        checker=cc.unbridled_optimism(),
        generator=gen.clients(gen.limit(10, _wr_gen()))))
    assert not test.get("aborted")
    assert "monitor" not in test["results"]


def test_all_unknown_checks_degrade_verdict(monkeypatch):
    monkeypatch.setattr(
        mengine, "check_prefix",
        lambda *a, **kw: {"valid": "unknown", "error": "budget"})
    latch = ChainedLatch()
    mon = mcore.Monitor(SPEC, latch, chunk=1, engine="wgl").start()
    _feed(mon, _history())
    mon.stop()
    s = mon.summary()
    assert s["verdict"] == "unknown"
    assert s["unknown_checks"] > 0
    assert not latch.is_set()


def test_later_definite_check_covers_earlier_unknown(monkeypatch):
    real = mengine.check_prefix
    flaky = {"n": 0}

    def sometimes_unknown(*a, **kw):
        flaky["n"] += 1
        if flaky["n"] == 1:
            return {"valid": "unknown", "error": "budget"}
        return real(*a, **kw)

    monkeypatch.setattr(mengine, "check_prefix", sometimes_unknown)
    mon = mcore.Monitor(SPEC, ChainedLatch(), chunk=1, engine="wgl").start()
    hist = _history()
    _feed(mon, hist[:8])
    deadline = time.monotonic() + 10
    while mon.checks < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert mon.checks >= 1
    _feed(mon, hist[8:])
    mon.stop()
    s = mon.summary()
    assert s["verdict"] is True
    assert s["unknown_checks"] == 1


def test_external_abort_still_works_on_monitored_run():
    base = AbortLatch()
    timer = threading.Timer(0.5, base.set, args=("SIGINT",))
    timer.start()
    try:
        test = core.run(_violating_test(
            client=StaleRegister(apply_n=10**9), abort=base,
            name="mon-ext-abort"))
    finally:
        timer.cancel()
    assert test["aborted"] == "SIGINT"
    r = test["results"]
    assert r["salvaged"] is True
    assert r["abort-reason"] == "SIGINT"
    assert r["monitor"]["verdict"] is True


def test_chained_latch_parent_and_own():
    parent = AbortLatch()
    chained = ChainedLatch(parent)
    assert not chained.is_set()
    parent.set("SIGINT")
    assert chained.is_set()
    assert chained.reason == "SIGINT"
    chained.set("monitor-violation")
    assert chained.reason == "monitor-violation"
    assert not parent.is_set() or parent.reason == "SIGINT"


def test_chained_latch_does_not_leak_to_parent():
    parent = AbortLatch()
    chained = ChainedLatch(parent)
    chained.set("monitor-violation")
    assert chained.is_set()
    assert not parent.is_set()
    assert chained.wait(0.01)


def test_op_sinks_fan_out_with_journal():
    seen = []
    t = {"name": "tap", "start-time": store.local_time(),
         "concurrency": 2, "nodes": ["n1"],
         "client": StaleRegister(apply_n=10**9),
         "nemesis": nemesis.noop,
         "op-sinks": [seen.append],
         "generator": gen.clients(gen.limit(6, gen.repeat(
             {"f": "read"})))}
    t["journal"] = store.open_journal(t)
    h = interpreter.run(t)
    t["journal"].close()
    assert seen == h
    assert all("__op_serial__" not in o for o in seen)
    with open(store.path(t, store.JOURNAL_FILE)) as f:
        assert len(f.readlines()) == len(h)


def test_raising_sink_is_detached_not_fatal():
    calls = []

    def bad_sink(op):
        calls.append(op)
        raise RuntimeError("sink boom")

    t = {"concurrency": 1, "nodes": ["n1"],
         "client": StaleRegister(apply_n=10**9),
         "nemesis": nemesis.noop, "op-sinks": [bad_sink],
         "generator": gen.clients(gen.limit(4, gen.repeat(
             {"f": "read"})))}
    h = interpreter.run(t)
    assert len(h) == 8
    assert len(calls) == 1


_KILL9_CHILD = """
import sys, time
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
sys.path.insert(0, sys.argv[2])
from jepsen_tpu_torch import client as jc, core, generator as gen, store
from jepsen_tpu_torch.checker import checkers as cks
store.base_dir = sys.argv[1]

class SlowClient(jc.Client):
    def invoke(self, test, op):
        time.sleep(0.01)
        out = dict(op)
        out["type"] = "ok"
        out["value"] = None
        return out

core.run({"name": "kill9-mon", "nodes": ["n1"], "concurrency": 1,
          "ssh": {"dummy?": True}, "client": SlowClient(), "obs?": False,
          "monitor": {"chunk": 2, "engine": "wgl"},
          "checker": cks.linearizable({"model": "cas-register",
                                       "algorithm": "wgl"}),
          "generator": gen.clients(gen.repeat({"f": "read"}))})
"""


def test_kill9_monitored_run_salvageable(tmp_path):
    base = str(tmp_path / "store")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL9_CHILD, base, repo],
        env=dict(os.environ), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        pattern = os.path.join(base, "kill9-mon", "*", store.JOURNAL_FILE)
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
            proc.kill()
        proc.wait()
    run_dir = os.path.dirname(journal)
    assert not os.path.exists(os.path.join(run_dir, "history.jsonl"))
    assert not os.path.exists(os.path.join(run_dir, "monitor.json"))
    with open(journal) as f:
        ops = [json.loads(ln) for ln in f if ln.strip()]
    assert len(ops) >= 2
    e, st = SPEC.encode([dict(o, index=i) for i, o in enumerate(ops)])
    assert wgl.check_encoded(SPEC, e, st)["valid"] is True


def _plan(**kw):
    t = {"nodes": ["n1"], "concurrency": 1, "client": StaleRegister(),
         "generator": gen.clients(gen.limit(4, _wr_gen())),
         "checker": cks.linearizable({"model": "cas-register",
                                      "algorithm": "wgl"})}
    t.update(kw)
    return t


def _codes(diags, severity=None):
    return [d.code for d in diags
            if severity is None or d.severity == severity]


@pytest.mark.parametrize("chunk", [0, -3, 2.5])
def test_pl013_non_positive_chunk_is_error(chunk):
    diags = analysis.lint_plan(_plan(monitor={"chunk": chunk}))
    assert "PL013" in _codes(diags, "error")


@pytest.mark.parametrize("plan", [
    {"monitor-chunk": 8},
    {"monitor": True, "checker": cc.unbridled_optimism()},
    {"monitor": {"engine": "pallas"}},
    {"monitor": True, "op-timeout-ms": 500, "time-limit-s": 60},
], ids=["orphan-chunk", "no-engine", "unknown-engine", "op-timeout"])
def test_pl013_warns(plan):
    assert "PL013" in _codes(analysis.lint_plan(_plan(**plan)), "warning")


def test_pl013_clean_monitor_plan():
    diags = analysis.lint_plan(_plan(monitor={"chunk": 64,
                                              "engine": "jax-wgl"}))
    assert "PL013" not in _codes(diags)


def test_monitor_config_normalization():
    assert jmon.config({}) is None
    assert jmon.config({"monitor": True}) == {}
    assert jmon.config({"monitor": 16}) == {"chunk": 16}
    assert jmon.config({"monitor": {"chunk": 8}}) == {"chunk": 8}
    assert jmon.config({"monitor": True,
                        "monitor-chunk": 32}) == {"chunk": 32}


def test_find_linearizable_walks_wrappers():
    lin = cks.linearizable({"model": "cas-register"})
    comp = cc.compose({"workload": independent.checker(
        cc.compose({"linearizable": lin,
                    "ok": cc.unbridled_optimism()})),
        "ok": cc.unbridled_optimism()})
    got, keyed = jmon.find_linearizable(comp)
    assert got is lin
    assert keyed is True
    got, keyed = jmon.find_linearizable(lin)
    assert got is lin
    assert keyed is False
    got, keyed = jmon.find_linearizable(cc.unbridled_optimism())
    assert got is None


# ---------------------------------------------------------------------------
# 3. monitored runs on the default device engine, a few hundred ops


def _device_test(n_ops, apply_n, **kw):
    """A run whose monitor is the default (the gate's "jax-wgl" search,
    here on the CPU), ``n_ops`` client ops of 3 ms each: slow enough for
    the monitor to check many chunks while the run goes on."""
    return _violating_test(
        name=kw.pop("name", "monitor-device"), concurrency=3,
        client=StaleRegister(apply_n=apply_n, delay_s=0.003),
        monitor=kw.pop("monitor", {"chunk": 16}),
        generator=gen.clients(gen.limit(n_ops, _wr_gen())),
        checker=cks.linearizable({"model": "cas-register",
                                  "algorithm": "jax-wgl",
                                  "engine_opts": CPU}), **kw)


def _jax_verdict(hist):
    return jcheckers.linearizable({"model": "cas-register",
                                   "algorithm": "wgl"}).check(
        {}, hist, {})["valid"]


def test_device_monitored_run_aborts_and_certifies():
    # the limit outlasts the first check's warm-up (~1 s in a fresh
    # process); the monitor aborts long before it
    test = core.run(_device_test(3000, apply_n=40))
    r = test["results"]
    m = r["monitor"]
    assert m["engine"] == "jax-wgl" and m["verdict"] is False
    assert test["aborted"] == "monitor-violation"
    assert r["abort-reason"] == "monitor-violation" and r["salvaged"]
    client_ops = [o for o in test["history"]
                  if isinstance(o.get("process"), int)]
    assert len(client_ops) < 6000      # aborted before the limit
    assert r["valid"] is False and _jax_verdict(test["history"]) is False
    cert = r["monitor-certification"]
    assert cert["confirmed"] is True
    assert cert["counts"].get("error", 0) == 0
    summary = test["analysis"]["certify-monitor"]
    assert summary["engine"] == "jax-wgl"
    assert [c["engine"] for c in summary["checks"]
            if c["name"] == "cross-check"] == ["linear"]


def test_device_monitored_run_stays_clean():
    test = core.run(_device_test(300, apply_n=10**9))
    r = test["results"]
    assert not test.get("aborted") and "salvaged" not in r
    assert r["valid"] is True and r["monitor"]["verdict"] is True
    assert r["monitor"]["ops_consumed"] == 300
    assert r["monitor"]["checks"] >= 2
    assert _jax_verdict(test["history"]) is True
    assert "monitor-certification" not in r


def test_device_monitored_skip_offline_handoff():
    test = core.run(_device_test(
        3000, apply_n=40, monitor={"chunk": 16, "skip-offline?": True}))
    r = test["results"]
    assert r["valid"] is False and r["monitor-only"] is True
    assert r["monitor-certification"]["confirmed"] is True


def test_device_monitored_run_external_abort():
    base = AbortLatch()
    timer = threading.Timer(0.3, base.set, args=("SIGINT",))
    timer.start()
    try:
        test = core.run(_device_test(10**6, apply_n=10**9, abort=base,
                                     name="mon-device-ext"))
    finally:
        timer.cancel()
    r = test["results"]
    assert test["aborted"] == "SIGINT" and r["abort-reason"] == "SIGINT"
    assert r["monitor"]["verdict"] is True and r["valid"] is True


# ---------------------------------------------------------------------------
# 4. divergences: no catch-all hides a device or build error


@pytest.mark.parametrize("monitor,checker,exc", [
    # the default engine's device is CUDA: no card here
    ({"chunk": 4}, {"algorithm": "jax-wgl"}, RuntimeError),
    ({"chunk": 4, "engine": "streamlin"}, {"algorithm": "wgl"},
     RuntimeError),
    ({"chunk": 4, "engine": "pallas"}, {"algorithm": "wgl"}, ValueError),
], ids=["jax-wgl-no-card", "streamlin-no-card", "unknown-engine"])
def test_unbuildable_monitor_raises_before_the_first_op(monitor, checker,
                                                        exc):
    client = StaleRegister()
    with pytest.raises(exc):
        core.run(_violating_test(
            client=client, monitor=monitor,
            checker=cks.linearizable({"model": "cas-register",
                                      **checker})))
    assert client.invokes == 0


def test_thread_exception_is_reraised_by_stop(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("device boom")

    monkeypatch.setattr(mengine, "check_prefix", boom)
    latch = ChainedLatch()
    mon = mcore.Monitor(SPEC, latch, chunk=2, engine="wgl").start()
    _feed(mon, _history())
    with pytest.raises(RuntimeError, match="device boom"):
        mon.stop()
    mon.stop()                        # raised once; idempotent after
    assert latch.reason == mcore.ERROR_REASON
    s = mon.summary()
    assert s["verdict"] == "unknown" and "device boom" in s["error"]
    test = {}
    assert mcore.finalize(mon, test)["error"] == s["error"]


def test_thread_exception_aborts_run_and_salvages(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("device boom")

    monkeypatch.setattr(mengine, "check_prefix", boom)
    t = _violating_test(name="mon-error", client=StaleRegister(10**9))
    with pytest.raises(RuntimeError, match="device boom"):
        core.run(t)
    (run_dir,) = glob.glob(os.path.join(store.base_dir, "mon-error", "2*"))
    with open(os.path.join(run_dir, "results.json")) as f:
        r = json.load(f)
    assert r["salvaged"] is True
    assert r["abort-reason"] == mcore.ERROR_REASON
    assert r["valid"] is True          # the salvaged prefix, checked
    with open(os.path.join(run_dir, "monitor.json")) as f:
        assert "device boom" in json.load(f)["error"]


def test_finalize_parks_the_summary_then_reraises(monkeypatch):
    monkeypatch.setattr(mengine, "check_prefix",
                        lambda *a, **kw: 1 / 0)
    test = {"monitor": {"chunk": 1, "engine": "wgl"},
            "checker": cks.linearizable({"model": "cas-register",
                                         "algorithm": "wgl"})}
    mon = mcore.install(test)
    assert isinstance(test["abort"], ChainedLatch)
    _feed(mon, _history()[:4])
    with pytest.raises(ZeroDivisionError):
        mcore.finalize(mon, test)
    assert test["monitor-verdict"]["verdict"] == "unknown"
    assert mon.offer not in test["op-sinks"]


def test_offer_never_raises():
    mon = mcore.Monitor(SPEC, ChainedLatch(), chunk=1, engine="wgl")
    mon.offer(None)                   # not a dict: logged, not raised
    mon.offer({"type": "invoke", "process": 0, "f": "read"})
    assert mon._n_seen == 2


def test_quiescent_carry_failure_is_contained_and_counted(monkeypatch):
    from jepsen_tpu_torch.analysis import searchplan

    def broken(*a, **kw):
        raise IndexError("carry bug")

    monkeypatch.setattr(searchplan, "stream_cut", broken)
    for falsify in (None, 4):
        mon = mcore.Monitor(SPEC, ChainedLatch(), chunk=2, engine="wgl")
        s = _drive(mon, _history(falsify), 2)
        assert s["verdict"] is (falsify is None)
        assert s["carry_failures"] > 0
        assert s["quiescent_truncated_ops"] == 0


def test_streamcheck_failure_raises_instead_of_falling_back(monkeypatch):
    from jepsen_tpu_torch.monitor import wgl_stream

    def broken(self, *a, **kw):
        raise RuntimeError("stream build")

    monkeypatch.setattr(wgl_stream.StreamCheck, "__init__", broken)
    mon = mcore.Monitor(SPEC, ChainedLatch(), chunk=1, engine="streamlin",
                        engine_opts=CPU).start()
    _feed(mon, _history()[:2])
    with pytest.raises(RuntimeError, match="stream build"):
        mon.stop()


def test_checks_run_under_the_short_switch_interval(monkeypatch):
    """A monitor's check runs with the interpreter's switch interval at
    ``checkers.MONITOR_SWITCH_INTERVAL``, restored after it: beside 50 busy
    interpreter workers the check's torch calls otherwise each wait up to
    the default 5 ms for the GIL (the command line's monitored dirty-read
    demo run took 27 s to its first verdict on the CPU, against 1.6 s)."""
    import sys as _sys
    seen = []
    real = mengine.check_prefix

    def recording(*args, **kw):
        seen.append(_sys.getswitchinterval())
        return real(*args, **kw)

    monkeypatch.setattr(mengine, "check_prefix", recording)
    before = _sys.getswitchinterval()
    mon = mcore.Monitor(SPEC, ChainedLatch(), chunk=8, engine="jax-wgl",
                        engine_opts=CPU)
    assert _drive(mon, _history(falsify_at=4), 8)["verdict"] is False
    # the interpreter keeps the interval in microseconds: it reads back
    # rounded
    assert seen and seen == pytest.approx([cks.MONITOR_SWITCH_INTERVAL]
                                          * len(seen), abs=1e-9)
    assert _sys.getswitchinterval() == before


def test_short_switch_nests_and_restores():
    """Open scopes run at the shortest interval among them; the last to
    leave restores the interval saved by the first."""
    import sys as _sys
    before = _sys.getswitchinterval()
    with cks.short_switch(1e-3):
        assert _sys.getswitchinterval() == pytest.approx(1e-3, abs=1e-9)
        with cks.short_switch():
            assert _sys.getswitchinterval() == pytest.approx(
                cks.RACE_SWITCH_INTERVAL, abs=1e-9)
        assert _sys.getswitchinterval() == pytest.approx(1e-3, abs=1e-9)
    assert _sys.getswitchinterval() == before
