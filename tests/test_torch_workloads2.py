"""The port's workload library against the JAX package's, on the CPU:
the bank, long-fork, causal, causal-reverse and adya checkers give equal
results on the histories of ``tests/test_workloads.py`` and
``tests/test_workloads2.py``; every workload's generator (the cycle
list-append and wr ``txn_generator`` among them) yields the same ops,
op for op, through both packages' ``generator.testing.simulate`` under
``fixed_rand(45100)`` with ``random`` seeded alike; the perf and clock
checkers' pure parts are equal and, with the bank plotter, they write
the same file names into each package's store (matplotlib is present
here); the bank workload runs end to end through the port's
``core.run``. Tolerance: exact equality."""

import os
import random
import threading

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import store as jstore
from jepsen_tpu.checker import clock as jclock
from jepsen_tpu.checker import core as jcc
from jepsen_tpu.checker import perf as jperf
from jepsen_tpu.generator import testing as jgt
from jepsen_tpu.tests import adya as jadya
from jepsen_tpu.tests import bank as jbank
from jepsen_tpu.tests import causal as jcausal
from jepsen_tpu.tests import causal_reverse as jcausal_reverse
from jepsen_tpu.tests import long_fork as jlong_fork
from jepsen_tpu.tests.cycle import append as jappend
from jepsen_tpu.tests.cycle import wr as jwr
from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import independent
from jepsen_tpu_torch import store
from jepsen_tpu_torch import tests as tst
from jepsen_tpu_torch.checker import clock
from jepsen_tpu_torch.checker import core as cc
from jepsen_tpu_torch.checker import perf
from jepsen_tpu_torch.generator import testing as gt
from jepsen_tpu_torch.tests import (adya, bank, causal, causal_reverse,
                                    long_fork)
from jepsen_tpu_torch.tests.cycle import append, wr

PORT = {"gen": gen, "gt": gt, "ind": independent, "h": h, "bank": bank,
        "long_fork": long_fork, "causal": causal, "adya": adya,
        "causal_reverse": causal_reverse, "append": append, "wr": wr,
        "perf": perf, "clock": clock, "cc": cc, "store": store}
JAX = {"gen": jgen, "gt": jgt, "ind": jind, "h": jh, "bank": jbank,
       "long_fork": jlong_fork, "causal": jcausal, "adya": jadya,
       "causal_reverse": jcausal_reverse, "append": jappend, "wr": jwr,
       "perf": jperf, "clock": jclock, "cc": jcc, "store": jstore}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jstore"))


# ---------------------------------------------------------------------------
# checkers on the JAX package's histories


def _bank_test():
    return {"accounts": list(range(8)), "total-amount": 100,
            "max-transfer": 5, "nodes": ["n1"], "name": None}


def _read(txn, process=0, time=0):
    return {"type": "ok", "f": "read", "process": process, "value": txn,
            "time": time}


def _c(f, value, pos, link):
    return {"type": "ok", "f": f, "value": value, "position": pos,
            "link": link, "process": 0, "time": pos}


def _w(t, v, p):
    return {"type": t, "f": "write", "value": v, "process": p}


def _r(t, v, p):
    return {"type": t, "f": "read", "value": v, "process": p}


def _insert(p, t, k, v):
    return {"type": t, "f": "insert", "value": p["ind"].tuple_(k, v)}


CHECKS = {
    # name: (checker builder, history builder, test map)
    "bank-valid": (lambda p: p["bank"].checker(), lambda p: [
        p["h"].invoke_op(0, "read"),
        p["h"].ok_op(0, "read", {0: 50, 1: 50})], _bank_test()),
    "bank-wrong-total": (lambda p: p["bank"].checker(), lambda p: p[
        "h"].index([p["h"].invoke_op(0, "read"),
                    p["h"].ok_op(0, "read", {0: 50, 1: 49})]),
        _bank_test()),
    "bank-negative": (lambda p: p["bank"].checker(), lambda p: p[
        "h"].index([p["h"].invoke_op(0, "read"),
                    p["h"].ok_op(0, "read", {0: 150, 1: -50})]),
        _bank_test()),
    "bank-negative-allowed": (
        lambda p: p["bank"].checker({"negative-balances?": True}),
        lambda p: p["h"].index([p["h"].invoke_op(0, "read"),
                                p["h"].ok_op(0, "read", {0: 150, 1: -50})]),
        _bank_test()),
    "bank-nil-and-unexpected": (lambda p: p["bank"].checker(), lambda p: p[
        "h"].index([p["h"].invoke_op(0, "read"),
                    p["h"].ok_op(0, "read", {0: None, 1: 100}),
                    p["h"].invoke_op(0, "read"),
                    p["h"].ok_op(0, "read", {"bogus": 100})]),
        _bank_test()),
    "long-fork-fork": (lambda p: p["long_fork"].checker(2), lambda p: [
        {"type": "ok", "f": "write", "process": 0,
         "value": [["w", 0, 1]], "time": 0},
        {"type": "ok", "f": "write", "process": 1,
         "value": [["w", 1, 1]], "time": 1},
        _read([["r", 0, 1], ["r", 1, None]], 2, 2),
        _read([["r", 0, None], ["r", 1, 1]], 3, 3)], {}),
    "long-fork-comparable": (lambda p: p["long_fork"].checker(2), lambda p: [
        _read([["r", 0, 1], ["r", 1, None]], 0),
        _read([["r", 0, 1], ["r", 1, 1]], 1),
        _read([["r", 0, None], ["r", 1, None]], 2)], {}),
    "long-fork-multiple-writes": (
        lambda p: p["long_fork"].checker(2), lambda p: [
            {"type": "invoke", "f": "write", "process": 0,
             "value": [["w", 7, 1]], "time": 0},
            {"type": "invoke", "f": "write", "process": 1,
             "value": [["w", 7, 1]], "time": 1}], {}),
    "long-fork-distinct-values": (
        lambda p: p["long_fork"].checker(2), lambda p: [
            _read([["r", 0, 1], ["r", 1, None]], 0),
            _read([["r", 0, 2], ["r", 1, None]], 1)], {}),
    "long-fork-wrong-group": (
        lambda p: p["long_fork"].checker(2), lambda p: [
            _read([["r", 0, 1]], 0)], {}),
    "causal-valid": (lambda p: p["causal"].check(
        p["causal"].causal_register()), lambda p: [
        _c("read-init", None, 1, "init"), _c("write", 1, 2, 1),
        _c("read", 1, 3, 2), _c("write", 2, 4, 3), _c("read", 2, 5, 4)],
        {}),
    "causal-broken-link": (lambda p: p["causal"].check(
        p["causal"].causal_register()), lambda p: [
        _c("read-init", None, 1, "init"), _c("write", 1, 2, 99)], {}),
    "causal-stale-read": (lambda p: p["causal"].check(
        p["causal"].causal_register()), lambda p: [
        _c("read-init", None, 1, "init"), _c("write", 1, 2, 1),
        _c("write", 2, 3, 2), _c("read", 1, 4, 3)], {}),
    "causal-bad-write": (lambda p: p["causal"].check(
        p["causal"].causal_register()), lambda p: [
        _c("read-init", None, 1, "init"), _c("write", 7, 2, 1)], {}),
    "causal-reverse-reversal": (lambda p: p["causal_reverse"].checker(),
                                lambda p: [
        _w("invoke", 0, 0), _w("ok", 0, 0), _w("invoke", 1, 1),
        _w("ok", 1, 1), _r("invoke", None, 2), _r("ok", [1], 2)], {}),
    "causal-reverse-valid": (lambda p: p["causal_reverse"].checker(),
                             lambda p: [
        _w("invoke", 0, 0), _w("ok", 0, 0), _w("invoke", 1, 1),
        _w("ok", 1, 1), _r("invoke", None, 2), _r("ok", [0, 1], 2)], {}),
    "causal-reverse-concurrent": (lambda p: p["causal_reverse"].checker(),
                                  lambda p: [
        _w("invoke", 0, 0), _w("invoke", 1, 1), _w("ok", 0, 0),
        _w("ok", 1, 1), _r("invoke", None, 2), _r("ok", [1], 2)], {}),
    "adya-g2-legal": (lambda p: p["adya"].g2_checker(), lambda p: [
        _insert(p, "ok", 0, [1, None]), _insert(p, "fail", 0, [None, 2]),
        _insert(p, "ok", 1, [3, None])], {}),
    "adya-g2-illegal": (lambda p: p["adya"].g2_checker(), lambda p: [
        _insert(p, "ok", 0, [1, None]), _insert(p, "fail", 0, [None, 2]),
        _insert(p, "ok", 1, [3, None]), _insert(p, "ok", 0, [None, 9])],
        {}),
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_checker_equals_jax(name):
    build, hist, test = CHECKS[name]
    got = build(PORT).check(dict(test), hist(PORT))
    want = build(JAX).check(dict(test), hist(JAX))
    assert got == want
    assert got["valid"] in (True, False, "unknown")


# ---------------------------------------------------------------------------
# generators, op for op


def _bank_gen(p):
    return p["gen"].clients(p["gen"].limit(40, p["bank"].test()["generator"]))


GENS = {
    "bank": ({**_bank_test(), "concurrency": 2, "nodes": ["n1", "n2"]},
             _bank_gen),
    "long-fork": ({"nodes": ["n1", "n2"], "concurrency": 4},
                  lambda p: p["gen"].limit(40,
                                           p["long_fork"].generator(2))),
    "adya": ({"nodes": ["n1"], "concurrency": 4},
             lambda p: p["gen"].limit(12, p["adya"].g2_gen())),
    "causal-reverse": ({"nodes": ["n1"], "concurrency": 1},
                       lambda p: p["gen"].time_limit(2, p[
                           "causal_reverse"].workload(
                           {"nodes": ["n1"], "per-key-limit": 40})
                           ["generator"])),
    "causal": ({"nodes": ["n1", "n2"], "concurrency": 2},
               lambda p: p["gen"].limit(60, p["causal"].test(
                   {"time-limit": 30})["generator"])),
    "cycle-append": ({"nodes": ["n1"], "concurrency": 3},
                     lambda p: p["gen"].clients(p["gen"].limit(
                         60, p["append"].gen({"key-count": 2,
                                              "max-writes-per-key": 4})))),
    "cycle-wr": ({"nodes": ["n1"], "concurrency": 3},
                 lambda p: p["gen"].clients(p["gen"].limit(
                     60, p["wr"].gen({"max-txn-length": 6})))),
}


def _simulate(p, name):
    test, build = GENS[name]
    random.seed(7)
    with p["gen"].fixed_rand(45100):
        return p["gt"].simulate(dict(test), build(p), p["gt"].perfect)


@pytest.mark.parametrize("name", sorted(GENS))
def test_generator_equals_jax(name):
    ours = _simulate(PORT, name)
    assert ours
    assert ours == _simulate(JAX, name)


def test_txn_generator_retires_keys_like_jax():
    """The rotating key pool: a key retires after max-writes-per-key
    writes and a fresh key takes its slot, in both packages alike."""
    def draw(p):
        random.seed(45100)
        g = p["append"].gen({"key-count": 2, "max-writes-per-key": 3})
        return [g({}, None) for _ in range(40)]

    ours = draw(PORT)
    assert ours == draw(JAX)
    keys = {m[1] for op in ours for m in op["value"]}
    assert len(keys) > 2


# ---------------------------------------------------------------------------
# perf and clock: pure parts, then the files written


def _little_history(p):
    ms = 1_000_000
    hh = p["h"]
    return hh.index([
        dict(hh.invoke_op(0, "w", 1), time=0 * ms),
        dict(hh.op("info", "nemesis", "start"), time=1 * ms),
        dict(hh.ok_op(0, "w", 1), time=30 * ms),
        dict(hh.invoke_op(1, "r", None), time=31 * ms),
        dict(hh.op("fail", 1, "r"), time=60 * ms),
        dict(hh.op("info", "nemesis", "stop"), time=80 * ms),
        dict(hh.invoke_op(0, "w", 2), time=90 * ms),
        dict(hh.op("info", 0, "w", 2), time=95 * ms),
    ])


def _clock_history():
    s = 1_000_000_000
    return [
        {"type": "invoke", "process": "nemesis", "f": "bump", "time": 0},
        {"type": "info", "process": "nemesis", "f": "bump", "time": 1 * s,
         "clock_offsets": {"n1.example.com": 0.5,
                           "n2.example.com": -1.25}},
        {"type": "invoke", "process": 0, "f": "read", "time": 2 * s},
        {"type": "ok", "process": 0, "f": "read", "time": 3 * s},
        {"type": "info", "process": "nemesis", "f": "reset", "time": 4 * s,
         "clock_offsets": {"n1.example.com": 0.0,
                           "n2.example.com": 0.0}},
    ]


def test_perf_and_clock_pure_parts_equal_jax():
    ours, theirs = _little_history(PORT), _little_history(JAX)
    assert perf.latency_points_by_f_type(ours) \
        == jperf.latency_points_by_f_type(theirs)
    assert [(a, b, lat) for a, b, lat in perf.history_latencies(ours)] \
        == [(a, b, lat) for a, b, lat in jperf.history_latencies(theirs)]
    pts = [(t / 7.0, (t * 37) % 101 + 0.5) for t in range(300)]
    assert perf.latencies_to_quantiles(30, perf.QUANTILES, pts) \
        == jperf.latencies_to_quantiles(30, jperf.QUANTILES, pts)
    nem = [o for o in ours if o["process"] == "nemesis"]
    jnem = [o for o in theirs if o["process"] == "nemesis"]
    assert perf.nemesis_intervals(nem) == jperf.nemesis_intervals(jnem)
    assert perf.nemesis_activity(None, ours) \
        == jperf.nemesis_activity(None, theirs)
    hist = _clock_history()
    assert clock.history_datasets(hist) == jclock.history_datasets(hist)
    nodes = ["n1.example.com", "n2.example.com", "db3.example.com"]
    assert clock.short_node_names(nodes) == jclock.short_node_names(nodes)


def _files(p, build, hist, name):
    test = {**_bank_test(), "name": name, "nodes": ["n1", "n2"],
            "start-time": "20260729T000000.000000+0000"}
    r = p["cc"].check(build(p), test, hist)
    return r, sorted(os.listdir(p["store"].path(test)))


@pytest.mark.parametrize("what", ["perf", "clock", "bank-plot"])
def test_plots_write_the_same_files(what):
    if what == "perf":
        build = lambda p: p["perf"].perf()               # noqa: E731
        hist = _little_history
    elif what == "clock":
        build = lambda p: p["clock"].clock_plot()        # noqa: E731
        hist = lambda p: _clock_history()                # noqa: E731
    else:
        build = lambda p: p["bank"].plotter()            # noqa: E731
        hist = lambda p: p["h"].index([                  # noqa: E731
            dict(p["h"].invoke_op(i % 2, "read"), time=i * 10**8)
            if i % 2 == 0 else
            dict(p["h"].ok_op((i - 1) % 2, "read", {0: 60, 1: 40}),
                 time=i * 10**8) for i in range(8)])
    got, ours = _files(PORT, build, hist(PORT), what)
    want, theirs = _files(JAX, build, hist(JAX), what)
    assert got == want and got["valid"] is True
    assert ours == theirs
    assert {"perf": "rate.png", "clock": "clock-skew.png",
            "bank-plot": "bank.png"}[what] in ours


def test_bank_end_to_end_with_plot():
    """The bank workload through the port's ``core.run`` with an
    atomically locked in-memory bank: valid, and the plotter's bank.png
    in the store."""

    class BankClient(jclient.Client):
        def __init__(self, balances=None, lock=None):
            self.balances = balances if balances is not None \
                else {k: 100 // 8 + (4 if k == 0 else 0) for k in range(8)}
            self.lock = lock or threading.Lock()

        def open(self, test, node):
            return BankClient(self.balances, self.lock)

        def invoke(self, test, op):
            out = dict(op)
            with self.lock:
                if op["f"] == "read":
                    out["type"] = "ok"
                    out["value"] = dict(self.balances)
                else:
                    v = op["value"]
                    if self.balances[v["from"]] < v["amount"]:
                        out["type"] = "fail"
                    else:
                        self.balances[v["from"]] -= v["amount"]
                        self.balances[v["to"]] += v["amount"]
                        out["type"] = "ok"
            return out

    w = bank.test()
    t = tst.noop_test()
    t.update({
        "name": "bank-e2e", "ssh": {"dummy?": True},
        "client": BankClient(), "nodes": ["n1", "n2"], "concurrency": 4,
        "accounts": w["accounts"], "total-amount": w["total-amount"],
        "max-transfer": w["max-transfer"],
        "generator": gen.clients(gen.limit(100, w["generator"])),
        "checker": w["checker"]})
    test = core.run(t)
    assert test["results"]["valid"] is True
    assert os.path.exists(os.path.join(store.path(test), "bank.png"))
