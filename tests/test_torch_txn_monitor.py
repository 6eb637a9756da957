"""The port's streaming txn check core (jepsen_tpu_torch/monitor/txn.py
``TxnCheck``) against the JAX package's on the CPU: at chunks of 1, 8
and 64 events every chunk's verdict dict, the squaring passes it cost
and the frontier's rebuilds equal the JAX package's, over the taxonomy
fixtures of tests/test_txn_monitor.py and a serial history of more
than 64 txns (so the frontier squares with torch, not on the host).
Then the monitor thread around it (``TxnMonitor``, ``install_txn``):
both packages' monitors driven deterministically over the same fixtures
(offer, then ``_step`` on the caller's thread) give equal summaries,
time fields aside; the JAX package's thread cases on the port; monitored
list-append runs through ``core.run``; and the port's divergences (a
monitor without its device raises before the first op, a thread
exception is re-raised by ``stop``). Tolerance: equality."""

import threading
import time

import pytest
import torch

from jepsen_tpu import cycle as jcycle
from jepsen_tpu.monitor import txn as jtxnmon
from jepsen_tpu.robust import ChainedLatch as JChainedLatch
from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import core as jcore
from jepsen_tpu_torch import cycle, simulate, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import monitor as jmonitor
from jepsen_tpu_torch import tests as tst
from jepsen_tpu_torch.monitor import core as mcore
from jepsen_tpu_torch.monitor import engine as mengine
from jepsen_tpu_torch.monitor import txn as txnmon
from jepsen_tpu_torch.monitor.txn import TxnCheck
from jepsen_tpu_torch.robust import ChainedLatch
from jepsen_tpu_torch.tests.cycle import append as append_workload

from test_txn_monitor import A, P, R, _fixtures

CPU = {"device": "cpu"}
TIME_FIELDS = ("time_to_first_verdict_s", "detection_latency_s")


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))


def _drive(hist, chunk, **kw):
    """Feed both cores in ``chunk``-event slices; every cut's result,
    pass cost and rebuild count must agree. Returns the final result
    and the port's core."""
    workload = kw.pop("workload", "append")
    core = TxnCheck(workload=workload, device="cpu", **kw)
    jcore = jtxnmon.TxnCheck(workload=workload, **kw)
    res = None
    for i, op in enumerate(hist):
        core.offer(op)
        jcore.offer(op)
        if (i + 1) % chunk == 0 or i == len(hist) - 1:
            p0, j0 = cycle.closure_passes(), jcycle.closure_passes()
            res = core.check()
            jres = jcore.check()
            assert res == jres, (i, chunk)
            assert cycle.closure_passes() - p0 \
                == jcycle.closure_passes() - j0, (i, chunk)
            assert core.frontier.rebuilds == jcore.frontier.rebuilds
            assert core.n_txns == jcore.n_txns
    return res, core


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_incremental_matches_jax_across_taxonomy(chunk):
    for name, hist, want_valid, want_class, kw in _fixtures():
        res, _ = _drive(hist, chunk, **dict(kw))
        assert res["valid"] is want_valid, (name, chunk)
        if want_class is not None:
            assert want_class in res["anomaly_types"], (name, chunk)


@pytest.mark.parametrize("chunk", [8, 64])
def test_large_serial_history_on_the_torch_frontier(chunk):
    """130 txns: the frontier rebuilds past 64 and 128 nodes and squares
    with torch; the injected G1c copy is caught and classified alike."""
    res, core = _drive(simulate.txn_append_history(130, 2), chunk)
    assert res["valid"] is True and core.frontier.n_pad == 256
    assert isinstance(core.frontier._r, torch.Tensor)
    res, _ = _drive(simulate.txn_append_history(130, 2, g1c=(80, 96)),
                    chunk)
    assert res["valid"] is False and "G1c" in res["anomaly_types"]


def test_garbage_read_and_skew_bound_match_jax():
    res, _ = _drive(P((0, 10, [R("x", [5])])), 1)
    assert res["valid"] == "unknown"
    hist = P((0, 10_000_000_000, [R("x", [2])]),
             (40_000_000_000, 50_000_000_000, [["append", "x", 2]]))
    res, _ = _drive(hist, 1, skew_bound=30_500_000_000)
    assert res["valid"] is True
    res, _ = _drive(hist, 8)
    assert res["valid"] is False


def test_wr_workload_and_offline_dispatch():
    hist = simulate.txn_wr_history(__import__("random").Random(2), 90, 8)
    res, core = _drive(hist, 16, workload="wr")
    assert res["valid"] is True
    off = mengine.check_txn_prefix(hist, "wr", core._opts())
    assert off["valid"] is True
    with pytest.raises(ValueError):
        TxnCheck(workload="nope", device="cpu")


# ---------------------------------------------------------------------------
# the monitor thread: TxnMonitor and install_txn

def _drive_monitor(mon, hist, chunk):
    """Offer the stream; every ``chunk`` completions run one ``_step`` on
    this thread, then one more (the final flush)."""
    done = 0
    for op in hist:
        mon.offer(op)
        if op.get("type") != "invoke":
            done += 1
            if done % chunk == 0:
                mon._step()
    mon._step()
    return {k: v for k, v in mon.summary().items() if k not in TIME_FIELDS}


_NAMES = [f[0] for f in _fixtures()]


@pytest.mark.parametrize("chunk", [1, 8, 64])
@pytest.mark.parametrize("name", _NAMES)
def test_txn_monitor_summary_equals_jax(name, chunk):
    (hist, want_valid, want_class, kw), = [
        f[1:] for f in _fixtures() if f[0] == name]
    latch, jlatch = ChainedLatch(), JChainedLatch()
    mon = txnmon.TxnMonitor(latch, chunk=chunk, device="cpu", **kw)
    jmon = jtxnmon.TxnMonitor(jlatch, chunk=chunk, **kw)
    got = _drive_monitor(mon, hist, chunk)
    assert got == _drive_monitor(jmon, hist, chunk)
    assert got["verdict"] is want_valid
    assert latch.is_set() is jlatch.is_set() is (not want_valid)
    if want_class is not None:
        assert want_class in got["anomaly_types"]
        assert latch.reason == mcore.ABORT_REASON
        ev, jev = mon.evidence, jmon.evidence
        assert set(ev) == set(jev) and ev["history"] == jev["history"]
        assert ev["result"] == jev["result"]


def test_txn_monitor_skew_bound_summary_equals_jax():
    hist = P((0, 10_000_000_000, [R("x", [2])]),
             (40_000_000_000, 50_000_000_000, [A("x", 2)]))
    kw = {"skew_bound": 30_500_000_000}
    got = _drive_monitor(txnmon.TxnMonitor(ChainedLatch(), chunk=1,
                                           device="cpu", **kw), hist, 1)
    want = _drive_monitor(jtxnmon.TxnMonitor(JChainedLatch(), chunk=1,
                                             **kw), hist, 1)
    assert got == want and got["skew_bound"] == 30_500_000_000
    assert got["verdict"] is True


def test_txn_monitor_thread_flips_latch_on_violation():
    test = {}
    mon = txnmon.install_txn(test, {"chunk": 2, "workload": "append",
                                    "engine-opts": CPU})
    try:
        for op in P((0, 10, [R("x", [2])]), (20, 30, [A("x", 2)])):
            mon.offer(op)
        deadline = time.monotonic() + 15
        while mon.violation is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert mon.violation is not None, "monitor never detected"
        assert test["abort"].is_set()
        assert test["abort"].reason == mcore.ABORT_REASON
        assert "G1c-realtime" in mon.violation["anomaly_types"]
        s = mon.summary()
        assert s["verdict"] is False and s["family"] == "txn"
        assert s["engine"] == "txn-append"
        assert s["txns"] >= 1 and s["chunks"] >= 1
    finally:
        mon.stop()


def test_txn_monitor_clean_run_summary():
    test = {"monitor": {"family": "txn", "workload": "append",
                        "chunk": 2, "engine-opts": CPU}}
    mon = jmonitor.install(test)          # core dispatch on family
    assert isinstance(mon, txnmon.TxnMonitor)
    try:
        for op in P((0, 10, [A("x", 1)]), (20, 30, [R("x", [1])])):
            mon.offer(op)
        deadline = time.monotonic() + 15
        while mon.checks == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        mon.stop()
    s = mon.summary()
    assert s["verdict"] is True and s["family"] == "txn"
    assert s["ops_consumed"] == 4 and mon.violation is None


def test_txn_monitor_without_its_device_raises_at_install():
    test = {"monitor": {"family": "txn", "chunk": 2}}   # None: CUDA
    with pytest.raises(RuntimeError, match="CUDA"):
        jmonitor.install(test)
    assert "op-sinks" not in test and "abort" not in test


def test_txn_monitor_thread_exception_is_reraised(monkeypatch):
    def boom(self, cancel=None):
        raise RuntimeError("closure boom")

    monkeypatch.setattr(TxnCheck, "check", boom)
    latch = ChainedLatch()
    mon = txnmon.TxnMonitor(latch, chunk=1, device="cpu").start()
    for op in P((0, 10, [A("x", 1)])):
        mon.offer(op)
    with pytest.raises(RuntimeError, match="closure boom"):
        mon.stop()
    assert latch.reason == mcore.ERROR_REASON
    assert mon.summary()["verdict"] == "unknown"


# ---------------------------------------------------------------------------
# monitored list-append runs through core.run


class ListAppendClient(jclient.Client):
    """A serializable in-memory list-append store: each txn runs under
    one lock. With ``stale_every`` set, every ``stale_every``-th txn's
    reads omit the appends of the last txn that appended to each key
    they read, unless that is the reading txn itself: acknowledged
    appends which a later read omits, while later reads see them again (a G-single-realtime cycle: the read's
    anti-dependency on the append, and the append finished before the
    read began)."""

    def __init__(self, lists=None, lock=None, stale_every=0, state=None,
                 delay_s=0.001):
        self.lists = lists if lists is not None else {}
        self.lock = lock or threading.Lock()
        self.stale_every = stale_every
        self.delay_s = delay_s
        self.state = state if state is not None \
            else {"txns": 0, "last": {}}

    def open(self, test, node):
        return ListAppendClient(self.lists, self.lock, self.stale_every,
                                self.state, self.delay_s)

    def invoke(self, test, op):
        time.sleep(self.delay_s)
        out = []
        with self.lock:
            self.state["txns"] += 1
            txn = self.state["txns"]
            stale = self.stale_every and txn % self.stale_every == 0
            last = self.state["last"]
            for f, k, v in op["value"]:
                seen = self.lists.setdefault(k, [])
                if f == "r":
                    writer, before = last.get(k, (txn, len(seen)))
                    out.append([f, k, list(seen[:before] if stale
                                            and writer != txn else seen)])
                else:
                    if last.get(k, (None,))[0] != txn:
                        last[k] = (txn, len(seen))
                    seen.append(v)
                    out.append([f, k, v])
        return dict(op, type="ok", value=out)


def _append_run(n_txns, stale_every=0, delay_s=0.001, **kw):
    import random
    random.seed(45100)
    w = append_workload.test({"key-count": 3, "device": "cpu"})
    t = tst.noop_test()
    t.update({"name": "txn-monitored", "ssh": {"dummy?": True},
              "concurrency": 4, "nodes": ["n1"],
              "client": ListAppendClient(stale_every=stale_every,
                                         delay_s=delay_s),
              "monitor": {"family": "txn", "chunk": 16,
                          "engine-opts": CPU},
              "generator": gen.clients(gen.limit(n_txns, w["generator"])),
              "checker": w["checker"], **kw})
    return jcore.run(t)


def test_monitored_append_run_stays_clean():
    test = _append_run(200)
    r = test["results"]
    assert r["valid"] is True and r["monitor"]["verdict"] is True
    assert r["monitor"]["engine"] == "txn-append"
    assert r["monitor"]["ops_consumed"] == 400
    assert not test.get("aborted")
    assert test["certificate"]["family"] == "txn"
    assert test["certificate"]["counts"].get("error", 0) == 0


def test_monitored_append_run_aborts_on_a_stale_read():
    # 5 ms txns: the run outlasts the monitor's first checks even on a
    # loaded host; the abort ends it after the first stale read's chunk
    test = _append_run(4000, stale_every=25, delay_s=0.005)
    r = test["results"]
    m = r["monitor"]
    assert test.get("aborted") == mcore.ABORT_REASON, m
    assert m["verdict"] is False and r["valid"] is False
    assert len(test["history"]) < 8000
    assert set(m["anomaly_types"]) <= set(r["anomaly_types"])
    cert = r["monitor-certification"]
    assert cert["confirmed"] is True and cert["counts"]["error"] == 0
