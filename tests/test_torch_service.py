"""The port's checking service (``jepsen_tpu_torch/fleet/service.py``)
against the JAX package's (``jepsen_tpu/fleet/service.py``) on the CPU,
tolerance zero.

``check_history`` gets the same seeded payloads on both sides (the
port's service configured with ``device="cpu"``, coalescing off):
cas-register, register and mutex, keyed, planned and unplanned, invalid
with a witness, txn ``append`` and ``wr``, an exhausted timeout, on-demand
certification. The responses are compared whole, less the wall clock.
The admission gate runs the same scripted scenarios on both sides
(tokens, budgets, the bounded queue, 429 with Retry-After, the daily
quota, the drain) and its snapshots, gauges and shed counts are
compared; ``metrics_text``'s series names, PL016 (``lint_service``),
campaign submission and status, and the deliberate divergence that an
engine error is a 500 (not the reference's 422) are held too."""

import random
import signal
import threading
import time

import pytest

from jepsen_tpu import simulate as jsim
from jepsen_tpu import store as jstore
from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu.fleet import service as jsvc
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.analysis import planlint as tplanlint
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.fleet import service as tsvc
from jepsen_tpu_torch.monitor import engine as tengine

#: each test's own wall limit (seconds)
TIME_LIMIT_S = 60


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


def _hist(model, seed, n_ops=40, procs=3, crash_p=0.02, corrupt=False):
    rng = random.Random(seed)
    h = jsim.random_history(rng, model, procs, n_ops, crash_p)
    if corrupt:
        h = jsim.corrupt(rng, h)
    return [{k: v for k, v in o.items() if k != "index"} for o in h]


def _keyed(parts):
    """One [k, v]-valued history of several keys, processes disjoint."""
    out = []
    for j, (k, h) in enumerate(parts):
        for o in h:
            o = dict(o)
            o["process"] = o["process"] + 100 * j
            o["value"] = [k, o.get("value")]
            out.append(o)
    return out


def _strip(r):
    """A response without its wall clock."""
    return {k: v for k, v in r.items() if k != "wall_s"}


def _both(payload, **kw):
    return (_strip(tsvc.check_history(dict(payload), **kw)),
            _strip(jsvc.check_history(dict(payload), **kw)))


BURST = [{"type": "invoke", "process": 0, "f": "write", "value": 0},
         {"type": "invoke", "process": 1, "f": "write", "value": 1},
         {"type": "ok", "process": 0, "f": "write", "value": 0},
         {"type": "ok", "process": 1, "f": "write", "value": 1},
         {"type": "invoke", "process": 2, "f": "read", "value": None},
         {"type": "ok", "process": 2, "f": "read", "value": 0}]


@pytest.mark.parametrize("model,seed,corrupt", [
    ("cas-register", 1, False), ("cas-register", 2, True),
    ("register", 3, False), ("register", 4, True),
    ("mutex", 5, False), ("mutex", 6, True),
])
@pytest.mark.parametrize("searchplan", [True, False],
                         ids=["planned", "unplanned"])
def test_check_history_equals_jax(model, seed, corrupt, searchplan):
    payload = {"history": _hist(model, seed, corrupt=corrupt),
               "model": model, "searchplan": searchplan}
    got, want = _both(payload)
    assert got == want
    if corrupt and model != "mutex":
        assert got["valid"] is False


@pytest.mark.parametrize("engine", ["jax-wgl", "wgl", "linear"])
def test_keyed_check_equals_jax(engine):
    hist = _keyed([("a", _hist("cas-register", 11)),
                   ("b", _hist("cas-register", 12, corrupt=True)),
                   ("c", _hist("cas-register", 13))])
    got, want = _both({"history": hist, "keyed": True,
                       "engine": engine})
    assert got == want
    assert got["valid"] is False and set(got["keys"]) == {"a", "b", "c"}


def test_invalid_witness_certification_equals_jax():
    """"certify": true: the certification summary of an invalid verdict
    (its witness replayed, the cross-check run) equals the JAX
    certifier's, keyed and not."""
    bad = _hist("cas-register", 2, corrupt=True)
    got, want = _both({"history": bad, "certify": True})
    assert got == want
    assert got["valid"] is False and got["certify"]["certified"] is True
    keyed = _keyed([("x", bad), ("y", _hist("cas-register", 1))])
    got, want = _both({"history": keyed, "keyed": True, "certify": True})
    assert got == want
    assert set(got["certify"]["keys"]) == {"x", "y"}


def test_exhausted_timeout_equals_jax():
    payload = {"history": _hist("cas-register", 7), "timeout-s": 1e-9}
    got, want = _both(payload)
    assert got == want
    assert got["valid"] == "unknown" and "budget" in got["error"]


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


WR = [{"type": "invoke", "f": "txn", "process": 0, "time": 0,
       "value": [["w", "x", 1]]},
      {"type": "ok", "f": "txn", "process": 0, "time": 10,
       "value": [["w", "x", 1]]},
      {"type": "invoke", "f": "txn", "process": 1, "time": 20,
       "value": [["r", "x", 1]]},
      {"type": "ok", "f": "txn", "process": 1, "time": 30,
       "value": [["r", "x", 1]]}]


@pytest.mark.parametrize("payload", [
    {"family": "txn", "history": _txn(), "workload": "append"},
    {"family": "txn", "history": _txn("g1c-realtime"),
     "workload": "append", "certify": True},
    {"family": "txn", "history": _txn("g1c-realtime"),
     "workload": "append", "skew-bound": 100},
    {"family": "txn", "history": WR, "workload": "wr"},
], ids=["append", "g1c-certified", "skew-bound", "wr"])
def test_txn_check_equals_jax(payload):
    got, want = _both(payload)
    assert got == want


@pytest.mark.parametrize("payload,status", [
    ({"history": "nope"}, 400),
    ({"history": BURST, "model": "no-such-model"}, 400),
    ({"history": BURST, "engine": "warp"}, 400),
    ({"history": BURST, "timeout-s": -1}, 400),
    ({"history": BURST, "coalesce": "yes"}, 400),
    ({"history": BURST, "certify": 1}, 400),
    ({"history": [{"type": "ok", "process": 0, "f": "read"}],
      "model": "register"}, 400),
    ({"history": BURST, "keyed": True}, 400),
    ({"family": "bogus", "history": BURST}, 400),
    ({"family": "txn", "history": _txn(), "workload": "nope"}, 400),
    ({"family": "txn", "history": _txn(), "anomalies": ["G9"]}, 400),
    ({"family": "txn", "history": _txn(), "skew-bound": -1}, 400),
])
def test_rejections_equal_jax(payload, status):
    errs = []
    for svc in (tsvc, jsvc):
        with pytest.raises(svc.ApiError) as e:
            svc.check_history(payload)
        errs.append((e.value.status, e.value.payload, e.value.headers))
    assert errs[0] == errs[1]
    assert errs[0][0] == status


def test_history_size_bound_equals_jax(monkeypatch):
    monkeypatch.setattr(tsvc, "MAX_CHECK_OPS", 2)
    monkeypatch.setattr(jsvc, "MAX_CHECK_OPS", 2)
    for svc in (tsvc, jsvc):
        with pytest.raises(svc.ApiError) as e:
            svc.check_history({"history": BURST})
        assert e.value.status == 413


def test_an_engine_error_is_a_500_not_bad_input(monkeypatch):
    """Deliberate divergence: an error raised by the engine (here the
    solo search) is the service's fault, a 500 naming it; the reference
    answers 422 "could not be checked". Errors before the dispatch stay
    422 (an encoder fault)."""
    def boom(*a, **kw):
        raise RuntimeError("injected engine fault")

    monkeypatch.setattr(tengine, "check_prefix", boom)
    with pytest.raises(tsvc.ApiError) as e:
        tsvc.check_history({"history": BURST, "model": "cas-register"})
    assert e.value.status == 500
    assert "injected engine fault" in e.value.payload["error"]
    monkeypatch.undo()
    tsvc.configure_coalesce(enabled=False, device="cpu")
    from jepsen_tpu_torch.models import base as tbase
    spec = tbase.model_spec("cas-register")
    monkeypatch.setattr(spec, "encode", boom)
    with pytest.raises(tsvc.ApiError) as e:
        tsvc.check_history({"history": BURST, "model": "cas-register"})
    assert e.value.status == 422


def test_a_txn_engine_error_is_a_500(monkeypatch):
    """The txn twin: inference faults stay 422, a closure fault is a
    500."""
    from jepsen_tpu_torch import cycle

    def boom(*a, **kw):
        raise RuntimeError("injected closure fault")

    monkeypatch.setattr(cycle, "transitive_closure", boom)
    with pytest.raises(tsvc.ApiError) as e:
        tsvc.check_history({"family": "txn", "history": _txn()})
    assert e.value.status == 500
    from jepsen_tpu_torch.cycle import append
    monkeypatch.setattr(append, "infer", boom)
    with pytest.raises(tsvc.ApiError) as e:
        tsvc.check_history({"family": "txn", "history": _txn()})
    assert e.value.status == 422


def test_unconfigured_device_means_cuda():
    """The service's device is set once, at configuration; None means
    CUDA, which raises without a card before anything is built."""
    import torch
    tsvc.reset()
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsvc.configure_coalesce(enabled=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsvc.device()
    assert tsvc.coalescer() is None
    # a CPU engine needs no device at all
    out = tsvc.check_history({"history": BURST, "engine": "wgl"})
    assert out["valid"] is True


# ---------------------------------------------------------------------------
# admission: the same scripted scenarios on both gates


def _authorize_story(svc):
    out = []
    a = svc.Admission(token="sekrit")
    for h in ("Bearer sekrit", "bearer sekrit", "sekrit", None, "",
              "Bearer nope", "Bearer sekri"):
        try:
            out.append(("ok", a.authorize(h)))
        except svc.ApiError as e:
            out.append((e.status, e.payload, e.headers))
    out.append(svc.Admission(tokens={"t1": "alice", "t2": "bob"})
               .authorize("Bearer t2"))
    out.append(svc.Admission().authorize(None, client="10.0.0.9"))
    return out


def _slot_story(svc):
    """A holder, one queued waiter, an immediate 429, the waiter
    admitted on release; then the daily quota and the campaign budget."""
    out = []
    a = svc.Admission(budgets={"concurrent-checks": 1, "queue-depth": 1},
                      queue_wait_s=10.0)
    entered, release, got = threading.Event(), threading.Event(), {}

    def holder():
        with a.check_slot("c"):
            entered.set()
            release.wait(30)

    def waiter():
        try:
            with a.check_slot("c"):
                got["w"] = "ran"
        except svc.ApiError as e:
            got["w"] = e.status

    t1 = threading.Thread(target=holder)
    t1.start()
    assert entered.wait(10)
    t2 = threading.Thread(target=waiter)
    t2.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and not a.snapshot().get("c", {}).get("waiting"):
        time.sleep(0.01)
    out.append(({c: dict(s, day=None) for c, s in a.snapshot().items()},
                a.gauges()))
    try:
        a._admit("c", 0)
    except svc.ApiError as e:
        out.append((e.status, e.payload, e.headers))
    release.set()
    t1.join(30)
    t2.join(30)
    out.append((got, a.snapshot(), a.gauges(), a.shed_count))
    q = svc.Admission(budgets={"ops-per-day": 10})
    with q.check_slot("c", ops=8):
        pass
    try:
        q._admit("c", 5)
    except svc.ApiError as e:
        out.append((e.status, e.payload["error"],
                    int(e.headers["Retry-After"]) >= 1))
    with q.check_slot("other", ops=9):
        pass
    out.append((sorted(q.snapshot()), q.shed_count))
    c = svc.Admission(budgets={"campaigns": 1})
    c.campaign_slot("c")
    try:
        c.campaign_slot("c")
    except svc.ApiError as e:
        out.append((e.status, e.payload, e.headers))
    c.campaign_done("c")
    c.campaign_slot("c")
    out.append((c.snapshot(), c.gauges()))
    for bad in ({"concurrent-checks": -1}, {"campaigns": True},
                {"queue-depth": 1.5}):
        try:
            svc.Admission(budgets=bad)
        except ValueError as e:
            out.append(str(e))
    return out


def _drain_story(svc):
    out = []
    a = svc.Admission(budgets={"concurrent-checks": 1, "queue-depth": 4},
                      queue_wait_s=30.0)
    entered, release, got = threading.Event(), threading.Event(), {}

    def holder():
        with a.check_slot("c"):
            entered.set()
            release.wait(30)

    def waiter():
        try:
            with a.check_slot("c"):
                got["w"] = "ran"
        except svc.ApiError as e:
            got["w"] = e.status

    t1 = threading.Thread(target=holder)
    t1.start()
    assert entered.wait(10)
    t2 = threading.Thread(target=waiter)
    t2.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and not a.snapshot().get("c", {}).get("waiting"):
        time.sleep(0.01)
    a.drain()
    t2.join(10)
    out.append(got)
    try:
        a._admit("c", 0)
    except svc.ApiError as e:
        out.append((e.status, e.payload, e.headers))
    try:
        a.campaign_slot("c")
    except svc.ApiError as e:
        out.append((e.status, e.payload, e.headers))
    release.set()
    t1.join(30)
    out.append((a.draining, a.snapshot(), a.gauges(), a.shed_count))
    return out


@pytest.mark.parametrize("story", [_authorize_story, _slot_story,
                                   _drain_story],
                         ids=["authorize", "slots", "drain"])
def test_admission_equals_jax(story):
    assert story(tsvc) == story(jsvc)


def test_over_budget_check_does_not_touch_inflight():
    out = []
    for svc in (tsvc, jsvc):
        svc.configure(budgets={"concurrent-checks": 1, "queue-depth": 0})
        row = []
        with svc.admission().check_slot("10.0.0.1"):
            try:
                svc.check_history({"history": BURST, "engine": "wgl"},
                                  caller="10.0.0.1")
            except svc.ApiError as e:
                row.append((e.status, e.headers))
            row.append(_strip(svc.check_history(
                {"history": BURST, "engine": "wgl"}, caller="10.0.0.2")))
        row.append(_strip(svc.check_history(
            {"history": BURST, "engine": "wgl"}, caller="10.0.0.1")))
        row.append((svc.admission().snapshot(),
                    svc.admission().shed_count))
        out.append(row)
    assert out[0] == out[1]
    assert out[0][0][0] == 429


# ---------------------------------------------------------------------------
# metrics, PL016, campaigns


def _series_names(text):
    return sorted({line.split()[2] for line in text.splitlines()
                   if line.startswith("# TYPE")})


def test_metrics_text_series_names_equal_jax():
    for svc in (tsvc, jsvc):
        svc.check_history({"history": BURST, "engine": "wgl"})
        svc.note_request("check", 200, 0.01)
        svc.note_request("check", 400, 0.002)
        svc.register_metrics_source(
            "fleet:t", lambda: {"gauges": {"fleet.lease_active": 2}})
        svc.register_metrics_source("broken", lambda: 1 / 0)
    got, want = tsvc.metrics_text(), jsvc.metrics_text()
    assert _series_names(got) == _series_names(want)
    assert "jepsen_admission_shed_total" in got
    assert "jepsen_service_requests" in got
    assert "jepsen_fleet_lease_active 2" in got
    tsvc.unregister_metrics_source("fleet:t")
    assert "jepsen_fleet_lease_active" not in tsvc.metrics_text()
    for p in ("/api/check", "/api/campaigns", "/api/campaigns/x/",
              "/api/metrics", "/api/nope"):
        assert tsvc.endpoint_of(p) == jsvc.endpoint_of(p)


PL016_CASES = [
    {},
    {"serve?": True},
    {"serve?": True, "serve-ip": "0.0.0.0"},
    {"serve?": True, "serve-ip": "10.1.2.3", "auth-token?": True},
    {"serve?": True, "serve-ip": "127.0.0.1"},
    {"serve?": True, "serve-ip": "::1"},
    {"serve?": True, "serve-ip": "localhost"},
    {"budgets": {"concurrent-checks": 0, "queue-depth": -1,
                 "campaigns": True, "ops-per-day": 2.5}},
    {"budgets": {"concurrent-checks": 4, "ops-per-day": None}},
    {"budgets": "nope"},
    {"queue-wait-s": 0},
    {"queue-wait-s": "soon"},
    {"queue-wait-s": 2.5},
    {"sync-timeout-s": -1, "lease-s": 10},
    {"sync-timeout-s": 30, "lease-s": 20},
    {"sync-timeout-s": 30, "lease-s": 30},
    {"sync-timeout-s": 10, "lease-s": 600},
    {"sync-timeout-s": 10, "lease-s": True},
]


@pytest.mark.parametrize("cfg", PL016_CASES)
def test_pl016_equals_jax(cfg):
    got = [(d.code, d.severity, d.message, d.location, d.fix_hint)
           for d in tplanlint.lint_service(cfg)]
    want = [(d.code, d.severity, d.message, d.location, d.fix_hint)
            for d in jplanlint.lint_service(cfg)]
    assert got == want


def _campaign_story(svc, builder):
    out = []
    cid, meta = svc.submit_campaign(
        {"axes": {"workload": ["noop"], "seed": [0, 1]},
         "options": {"time-limit": 1, "device": "cuda",
                     "ssh": {"dummy?": False}, "nodes": ["evil"]},
         "parallel": 2, "id": "api1"}, builder=builder)
    out.append(meta)
    svc._campaigns[cid]["thread"].join(120)
    st = svc.campaign_status("api1")
    out.append({k: st[k] for k in ("campaign", "status", "cells-planned",
                                   "cells-done", "outcomes")})
    for payload in ({"axes": {"workload": ["noop"]}, "id": "api1"},
                    {"axes": {}}, {"axes": {"workload": ["noop"]},
                                   "parallel": "two"},
                    {"axes": {"workload": ["noop"]},
                     "id": "../../../tmp/evil"}, "nope"):
        try:
            svc.submit_campaign(payload, builder=builder)
        except svc.ApiError as e:
            out.append(e.status)
    for cid in ("nope", "../x", ".hidden", ""):
        try:
            svc.campaign_status(cid)
        except svc.ApiError as e:
            out.append(e.status)
    return out


def test_campaign_submit_and_status_equal_jax():
    """A submitted sweep runs through each package's scheduler and
    polls alike; a payload cannot choose the device (the port's
    protected option) or point the control plane at real hosts."""
    got = _campaign_story(tsvc, "jepsen_tpu_torch.demo:demo_test")
    want = _campaign_story(jsvc, "jepsen_tpu.demo:demo_test")
    assert got == want
    assert got[1]["status"] == "complete"
    assert got[1]["outcomes"] == {"True": 2}
    assert "device" in tsvc.PROTECTED_OPTIONS


def test_shutdown_aborts_a_submitted_campaign():
    from jepsen_tpu_torch.campaign.journal import CampaignJournal
    tsvc.submit_campaign(
        {"axes": {"workload": ["noop"], "seed": list(range(50))},
         "options": {"time-limit": 30}, "id": "api-abort"},
        builder="jepsen_tpu_torch.demo:demo_test")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline \
            and not CampaignJournal("api-abort").load_meta():
        time.sleep(0.05)
    tsvc.shutdown(join_s=40)
    assert CampaignJournal("api-abort").load_meta()["status"] == "aborted"
    assert tsvc.latch().is_set()
    assert tsvc.admission().draining
