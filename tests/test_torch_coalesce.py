"""The port's cross-tenant coalescer (``jepsen_tpu_torch/fleet/service.py``
``Coalescer``) against the JAX package's, on the CPU: the counterparts
of ``tests/test_coalesce.py``'s seventeen tests, plus the txn lane and
pre-registration.

Each scenario runs on both sides: the JAX package's under
``JAX_PLATFORMS=cpu``, the port's configured with ``device="cpu"``.
Coalesced verdicts must equal the solo verdicts and the JAX package's
coalesced verdicts; batch statistics are compared with the reference's
wherever the schedule is fixed (a size-cap close, a window far longer
than the submissions take to arrive). One deliberate divergence is held
here: a batch that fails on the coalescer thread is not re-run solo,
every batchmate's request answers 500 naming the error
(``test_a_failed_batch_is_a_500_for_every_batchmate``, the counterpart
of the reference's ``test_batcher_crash_falls_back_to_solo_path``)."""

import signal
import threading
import time

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu import web as jweb
from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu.fleet import service as jsvc
from jepsen_tpu.parallel import keyshard as jkeyshard
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import web as tweb
from jepsen_tpu_torch.analysis import planlint as tplanlint
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.fleet import service as tsvc
from jepsen_tpu_torch.monitor import engine as tengine
from jepsen_tpu_torch.parallel import keyshard as tkeyshard

from test_coalesce import burst_hist

#: each test's own wall limit (seconds)
TIME_LIMIT_S = 90

SIDES = {"torch": (tsvc, tkeyshard, tcc), "jax": (jsvc, jkeyshard, jcc)}


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(_sig, _frame):
        raise TimeoutError(f"test exceeded {TIME_LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def service_state(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "torch"))
    for m in (jcc, tcc, jsvc, tsvc):
        m.reset()
    tsvc.configure_coalesce(enabled=False, device="cpu")
    yield
    for m in (jsvc, tsvc, jcc, tcc):
        m.reset()


def coalesce(side, **kw):
    """Turn the side's coalescer on (the port's on the CPU)."""
    svc = SIDES[side][0]
    if side == "torch":
        kw["device"] = "cpu"
    return svc.configure_coalesce(enabled=True, **kw)


def concurrent_checks(svc, payloads, callers):
    """The payloads from one thread each, started together so they land
    in one coalescing window; (results or ApiErrors, in order)."""
    results = [None] * len(payloads)
    gate = threading.Barrier(len(payloads))

    def call(i):
        gate.wait()
        try:
            results[i] = svc.check_history(payloads[i], caller=callers[i])
        except svc.ApiError as e:
            results[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None for r in results)
    return results


def valids(results):
    return [r["valid"] for r in results]


MIXED = [{"history": burst_hist(2), "model": "cas-register"},
         {"history": burst_hist(2, stale_read=True),
          "model": "cas-register"},
         {"history": burst_hist(3), "model": "cas-register"},
         {"history": burst_hist(3, stale_read=True),
          "model": "cas-register"}]
FLAT = [{"history": burst_hist(2), "model": "cas-register",
         "searchplan": False},
        {"history": burst_hist(2, stale_read=True), "model": "cas-register",
         "searchplan": False}]


def test_coalesced_verdicts_match_solo_mixed_batch():
    got = {}
    for side, (svc, _ks, _cc) in SIDES.items():
        solo = [svc.check_history({**p, "coalesce": False},
                                  caller=f"solo-{i}")
                for i, p in enumerate(MIXED)]
        coalesce(side, window_ms=200)
        coal = concurrent_checks(svc, MIXED,
                                 [f"tenant-{i}" for i in range(4)])
        assert valids(coal) == valids(solo) == [True, False, True, False]
        st = svc.coalescer().stats()
        assert st["batches"] >= 1 and st["segments"] >= 2
        assert max(r.get("coalesced", {}).get("owners", 0)
                   for r in coal) >= 2
        got[side] = valids(coal)
    assert got["torch"] == got["jax"]


def _keyed_parts():
    keyed = []
    for k, bad in (("a", False), ("b", True)):
        for op in burst_hist(2, stale_read=bad):
            op = dict(op)
            op["value"] = [k, op["value"]]
            keyed.append(op)
    return keyed


def test_coalesced_keyed_and_register_model_match_solo():
    got = {}
    for side, (svc, _ks, _cc) in SIDES.items():
        coalesce(side, window_ms=100)
        r = svc.check_history({"history": _keyed_parts(),
                               "model": "register", "keyed": True},
                              caller="kt")
        got[side] = (r["valid"], {k: v["valid"]
                                  for k, v in r["keys"].items()})
    assert got["torch"] == got["jax"] == (False, {"a": True, "b": False})


def test_cpu_engines_bypass_coalescer():
    got = {}
    for side, (svc, _ks, _cc) in SIDES.items():
        coalesce(side, window_ms=50)
        got[side] = [svc.check_history(
            {"history": burst_hist(2, stale_read=True),
             "model": "cas-register", "engine": engine},
            caller=f"cpu-{engine}")["valid"]
            for engine in ("wgl", "linear")]
        assert svc.coalescer().stats()["batches"] == 0
    assert got["torch"] == got["jax"] == [False, False]


def test_payload_coalesce_opt_out_and_validation():
    for side, (svc, _ks, _cc) in SIDES.items():
        coalesce(side, window_ms=50)
        r = svc.check_history({"history": burst_hist(2),
                               "model": "cas-register",
                               "coalesce": False}, caller="opt-out")
        assert r["valid"] is True
        assert svc.coalescer().stats()["batches"] == 0
        with pytest.raises(svc.ApiError) as e:
            svc.check_history({"history": burst_hist(2),
                               "coalesce": "yes"})
        assert e.value.status == 400


def test_deadline_isolation_slow_tenant_cannot_poison_batchmate(
        monkeypatch):
    got = {}
    for side, (svc, ks, _cc) in SIDES.items():
        real = ks.check_batch_encoded

        def slow(spec, pairs, _real=real, **kw):
            time.sleep(0.6)
            return _real(spec, pairs, **kw)

        monkeypatch.setattr(ks, "check_batch_encoded", slow)
        coalesce(side, window_ms=100)
        out = concurrent_checks(svc, [
            {"history": burst_hist(2), "model": "cas-register",
             "timeout-s": 0.2},
            {"history": burst_hist(2, stale_read=True),
             "model": "cas-register", "timeout-s": 60}],
            ["hurried", "patient"])
        assert out[0]["valid"] == "unknown"
        assert "timeout" in out[0]["error"]
        got[side] = valids(out)
    assert got["torch"] == got["jax"] == ["unknown", False]


def test_expired_segment_never_touches_the_device(monkeypatch):
    got = {}
    for side, (svc, ks, _cc) in SIDES.items():
        calls = []
        real = ks.check_batch_encoded

        def spy(spec, pairs, _real=real, _calls=calls, **kw):
            _calls.append(len(pairs))
            return _real(spec, pairs, **kw)

        monkeypatch.setattr(ks, "check_batch_encoded", spy)
        coalesce(side, window_ms=400)
        out = concurrent_checks(svc, [
            {"history": burst_hist(2), "model": "cas-register",
             "searchplan": False, "timeout-s": 0.05},
            {"history": burst_hist(2), "model": "cas-register",
             "searchplan": False, "timeout-s": 60}],
            ["hurried", "patient"])
        assert valids(out) == ["unknown", True]
        assert calls == [1]
        st = svc.coalescer().stats()
        st.pop("failed", None)
        got[side] = st
    # the window far exceeds the arrivals: the schedule is fixed
    assert got["torch"] == got["jax"]
    assert got["torch"]["expired"] == 1


def test_a_failed_batch_is_a_500_for_every_batchmate(monkeypatch):
    """Deliberate divergence from the reference's
    ``test_batcher_crash_falls_back_to_solo_path``: the batch's error
    reaches every owner (a 500 naming it) and no segment re-runs on the
    solo path."""
    def boom(spec, pairs, **kw):
        raise RuntimeError("injected batcher fault")

    solo = []
    real_prefix = tengine.check_prefix

    def counted(*a, **kw):
        solo.append(1)
        return real_prefix(*a, **kw)

    monkeypatch.setattr(tkeyshard, "check_batch_encoded", boom)
    monkeypatch.setattr(tengine, "check_prefix", counted)
    coalesce("torch", window_ms=100)
    out = concurrent_checks(tsvc, [
        {"history": burst_hist(2), "model": "cas-register"},
        {"history": burst_hist(2, stale_read=True),
         "model": "cas-register"}], ["a", "b"])
    for e in out:
        assert isinstance(e, tsvc.ApiError) and e.status == 500
        assert "injected batcher fault" in e.payload["error"]
    assert solo == []
    st = tsvc.coalescer().stats()
    assert st["failed"] == 2 and st["fallbacks"] == 0 \
        and st["batches"] == 0
    flat = tsvc.slo_registry().snapshot()["counters"]
    assert flat.get("service.coalesce.failed") == 2
    assert "service.coalesce.fallbacks" not in flat


def test_replacing_coalescer_releases_queued_segments():
    for side, (svc, _ks, _cc) in SIDES.items():
        coalesce(side, window_ms=30_000)
        out = {}

        def call(_svc=svc):
            out["r"] = _svc.check_history(
                {"history": burst_hist(2), "model": "cas-register",
                 "searchplan": False}, caller="queued")

        t = threading.Thread(target=call)
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and not svc.coalescer().stats()["queued"]:
            time.sleep(0.01)
        old = svc.coalescer()
        if side == "torch":
            svc.configure_coalesce(enabled=False, device="cpu")
        else:
            svc.configure_coalesce(enabled=False)
        t.join(timeout=60)
        assert not t.is_alive()
        assert out["r"]["valid"] is True
        assert old.stats()["fallbacks"] == 1


def test_size_cap_closes_batch_before_window():
    got = {}
    for side, (svc, _ks, _cc) in SIDES.items():
        coalesce(side, window_ms=30_000, max_segments=2)
        t0 = time.monotonic()
        out = concurrent_checks(svc, FLAT, ["a", "b"])
        assert valids(out) == [True, False]
        assert time.monotonic() - t0 < 30
        st = svc.coalescer().stats()
        st.pop("failed", None)
        got[side] = st
    assert got["torch"] == got["jax"]
    assert got["torch"]["batches"] == 1 and got["torch"]["segments"] == 2
    assert got["torch"]["occupancy"] == 1.0


def test_cross_tenant_ledger_hits_on_shape_identical_submissions():
    got = {}
    for side, (svc, _ks, cc) in SIDES.items():
        coalesce(side, window_ms=200)
        first = concurrent_checks(svc, FLAT, ["tenant-a", "tenant-b"])
        assert valids(first) == [True, False]
        assert all(r["coalesced"]["owners"] == 2 for r in first)
        before = cc.stats()
        second = concurrent_checks(svc, FLAT, ["tenant-c", "tenant-d"])
        after = cc.stats()
        assert valids(second) == [True, False]
        assert after["hits"] > before["hits"]
        assert after["misses"] == before["misses"]
        got[side] = (valids(first), after["hits"] - before["hits"])
    assert got["torch"] == got["jax"]


def test_coalesce_metrics_on_api_metrics():
    names = {}
    for side, (svc, _ks, _cc) in SIDES.items():
        coalesce(side, window_ms=100)
        concurrent_checks(svc, [FLAT[0]] * 2, ["m-a", "m-b"])
        text = svc.metrics_text()
        for name in ("jepsen_service_coalesce_batches",
                     "jepsen_service_coalesce_segments",
                     "jepsen_service_coalesce_occupancy",
                     "jepsen_service_coalesce_owners",
                     "jepsen_service_coalesce_wait_s",
                     "jepsen_admission_shed_total"):
            assert name in text, (side, name)
        names[side] = sorted({line.split()[2] for line in text.splitlines()
                              if line.startswith("# TYPE")
                              and "coalesce" in line})
    assert names["torch"] == names["jax"]


def test_serve_queue_wait_zero_is_not_coerced_to_default():
    for side, web in (("torch", tweb), ("jax", jweb)):
        svc = SIDES[side][0]
        opts = {"ip": "127.0.0.1", "port": 0, "queue-wait-s": 0,
                "budgets": {"concurrent-checks": 1}}
        if side == "torch":
            opts["device"] = "cpu"
        server = web.serve(opts)
        try:
            assert svc.admission().queue_wait_s == 0.0
        finally:
            server.shutdown()
            server.server_close()


def test_serve_enables_coalescing_by_default_and_honors_opt_out():
    for side, web in (("torch", tweb), ("jax", jweb)):
        svc = SIDES[side][0]
        dev = {"device": "cpu"} if side == "torch" else {}
        for opts, check in (
                ({}, lambda c: c is not None),
                ({"coalesce?": False, "coalesce-window-ms": 5},
                 lambda c: c is None),
                ({"coalesce-window-ms": 7, "coalesce-max-segments": 3},
                 lambda c: c.window_s == pytest.approx(0.007)
                 and c.max_segments == 3)):
            server = web.serve({"ip": "127.0.0.1", "port": 0, **opts,
                                **dev})
            try:
                assert check(svc.coalescer()), (side, opts)
            finally:
                server.shutdown()
                server.server_close()


PL020_BAD = [{"coalesce-window-ms": 0}, {"coalesce-window-ms": -5},
             {"coalesce-window-ms": "fast"},
             {"coalesce-max-segments": 0},
             {"coalesce-max-segments": 2.5},
             {"coalesce-max-segments": True}]
PL020_NOOP = [{"coalesce?": True, "device-slots": 0},
              {"coalesce?": True, "engine": "linear"},
              {"device-slots": 0},
              {"coalesce?": True, "engine": "jax-wgl",
               "coalesce-window-ms": 25, "coalesce-max-segments": 32,
               "device-slots": 1}]


def _diags(lint, cfg):
    return [(d.code, d.severity, d.message, d.location, d.fix_hint)
            for d in lint(cfg)]


def test_pl020_bad_knobs_are_errors():
    for cfg in PL020_BAD:
        got = _diags(tplanlint.lint_coalesce, cfg)
        assert got == _diags(jplanlint.lint_coalesce, cfg)
        assert [(c, s) for c, s, *_ in got] == [("PL020", "error")], cfg


def test_pl020_noop_configurations_are_warnings():
    got = [_diags(tplanlint.lint_coalesce, c) for c in PL020_NOOP]
    assert got == [_diags(jplanlint.lint_coalesce, c) for c in PL020_NOOP]
    assert [[(c, s) for c, s, *_ in d] for d in got] == [
        [("PL020", "warning")], [("PL020", "warning")], [], []]


@pytest.mark.parametrize("kw,code", [
    ({"coalesce": True, "coalesce_window_ms": 0}, "PL020"),
    ({"serve": True, "serve_ip": "0.0.0.0"}, "PL016"),
    ({"sync_timeout_s": -1}, "PL016"),
])
def test_pl020_rides_run_fleet_preflight(kw, code):
    """A bad coalesce window, a tokenless non-loopback serve bind and a
    non-positive sync timeout each refuse the fleet run before any
    worker starts (PL020 and PL016)."""
    with pytest.raises(tfleet.FleetError) as e:
        tfleet.run_fleet([{"id": "c1", "group": {}, "params": {}}],
                         ["local"], **kw)
    assert code in str(e.value)


def test_coalescer_rejects_bad_construction():
    for svc, dev in ((tsvc, {"device": "cpu"}), (jsvc, {})):
        with pytest.raises(ValueError):
            svc.Coalescer(window_s=0, **dev)
        with pytest.raises(ValueError):
            svc.Coalescer(max_segments=0, **dev)


# ---------------------------------------------------------------------------
# the txn lane and pre-registration


def _txn(kind="valid"):
    def pair(t0, t1, proc, mops):
        return [{"type": "invoke", "f": "txn", "process": proc,
                 "time": t0, "value": mops},
                {"type": "ok", "f": "txn", "process": proc,
                 "time": t1, "value": mops}]
    if kind == "g1c-realtime":
        return (pair(0, 10, 0, [["r", "x", [2]]])
                + pair(20, 30, 1, [["append", "x", 2]]))
    out = pair(0, 10, 0, [["append", "x", 1]])
    out += pair(20, 30, 1, [["append", "x", 2]])
    out += pair(40, 50, 2, [["r", "x", [1, 2]]])
    return out


def test_coalesced_txn_tenants_match_solo():
    payloads = [{"family": "txn", "history": _txn(), "workload": "append"},
                {"family": "txn", "history": _txn("g1c-realtime"),
                 "workload": "append"},
                {"family": "txn", "history": _txn(), "workload": "append"}]
    got = {}
    for side, (svc, _ks, _cc) in SIDES.items():
        solo = [svc.check_history({**p, "coalesce": False},
                                  caller=f"solo-{i}")
                for i, p in enumerate(payloads)]
        coalesce(side, window_ms=200)
        res = concurrent_checks(svc, payloads,
                                [f"tenant-{i}" for i in range(3)])
        assert valids(res) == valids(solo) == [True, False, True]
        assert any("coalesced" in r for r in res)
        st = svc.coalescer().stats()
        assert st["batches"] >= 1 and st["segments"] >= 2
        got[side] = [(r["valid"], r["anomaly_types"]) for r in res]
    assert got["torch"] == got["jax"]


def test_preregistered_buckets_round_up_as_the_reference():
    keys = [("cas-register", 256), ("cas-register", 1024),
            ("txn-closure", 512)]
    got = {}
    for side in SIDES:
        coal = coalesce(side, window_ms=50, planned=keys[:1])
        coal.preregister(keys[1:])

        class Spec:
            def __init__(self, name):
                self.name = name
        got[side] = ([coal._bucket_key(Spec(m), n)
                      for m in ("cas-register", "txn-closure", "mutex")
                      for n in (1, 64, 65, 300, 2000)],
                     coal.stats()["planned"])
    assert got["torch"] == got["jax"]
