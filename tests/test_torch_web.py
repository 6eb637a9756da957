"""The port's viewer and HTTP front (``jepsen_tpu_torch/web.py``) against
the JAX package's (``jepsen_tpu/web.py``) on the CPU.

The viewer pages -- home, the campaign index with its utilization,
audit, capacity, padding-waste and phase tables, and a run directory's
page with its monitor banner and phase panel -- are rendered by both
packages over one store that holds runs and campaigns, and must be the
same HTML. Over real sockets (every server binds ``127.0.0.1:0`` and is
shut down by its fixture): the ``/api/check`` round trip equal to the
JAX server's, the 413 before any body read, the JSON errors, the
campaign listing, browsing, zips and the path-traversal guard, the
token gate on every route, 429 with Retry-After (for a burst of 32
clients too), ``/api/metrics`` with a
registered source, and the 404 that falls back to
``fleet.sync.fetch_on_demand``. The entry points: ``serve`` with its
``capacity-plan`` (the plan's shapes pre-registered on the coalescer)
and without a device (CUDA, raising here), ``python -m jepsen_tpu_torch
serve`` in a subprocess (401/200/413, exit 0 on SIGINT), ``campaign
--serve`` and PL016 in the command line's and ``run_fleet``'s
preflights."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu import store as jstore
from jepsen_tpu import web as jweb
from jepsen_tpu.fleet import service as jsvc
from jepsen_tpu_torch import obs as tobs
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import web as tweb
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.campaign.journal import CampaignJournal
from jepsen_tpu_torch.fleet import service as tsvc
from jepsen_tpu_torch.fleet import sync as tsync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: each test's own wall limit (seconds)
TIME_LIMIT_S = 60

TS = "20260729T000000.000000+0000"
TS2 = "20260730T000000.000000+0000"
BAD_HIST = [
    {"type": "invoke", "process": 0, "f": "write", "value": 1},
    {"type": "ok", "process": 0, "f": "write", "value": 1},
    {"type": "invoke", "process": 1, "f": "read", "value": None},
    {"type": "ok", "process": 1, "f": "read", "value": 99},
]


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
def one_store(tmp_path, monkeypatch):
    """Both packages read and write the same store."""
    base = str(tmp_path / "store")
    monkeypatch.setattr(jstore, "base_dir", base)
    monkeypatch.setattr(tstore, "base_dir", base)
    for m in (tcc, jsvc, tsvc):
        m.reset()
    yield base
    for m in (jsvc, tsvc, tcc):
        m.reset()


def _metrics():
    reg = tobs.Registry()
    reg.inc("wgl.phase_s", 0.75, engine="torch-wgl", phase="device")
    reg.inc("wgl.phase_s", 0.25, engine="torch-wgl", phase="host")
    reg.inc("wgl.cells_real", 96, bucket="128", engine="torch-wgl-batch")
    reg.inc("wgl.cells_padded", 32, bucket="128",
            engine="torch-wgl-batch")
    reg.inc("fleet.cells_stolen", 1, worker="local#2")
    reg.inc("fleet.artifact_syncs", 2, worker="local#2", status="failed")
    return reg.snapshot()


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


@pytest.fixture()
def rich_store(one_store):
    """Runs (valid with a monitor violation and metrics, invalid with a
    trace journal, one incomplete) and two campaigns (one with every
    finalize artifact, one bare)."""
    tstore.save_2({"name": "reg", "start-time": TS, "history": [],
                   "results": {"valid": True}})
    run = os.path.join(one_store, "reg", TS)
    _write(os.path.join(run, "monitor.json"),
           {"verdict": False, "detected_at_index": 12,
            "detection_latency_s": 0.5})
    _write(os.path.join(run, "metrics.json"), _metrics())
    _write(os.path.join(run, "trace.jsonl"), "")
    _write(os.path.join(run, "certificate.json"), {})
    tstore.save_2({"name": "reg", "start-time": TS2, "history": [],
                   "results": {"valid": False}})
    _write(os.path.join(one_store, "reg", TS2, tstore.TRACE_JOURNAL_FILE),
           "")
    os.makedirs(os.path.join(one_store, "bank", TS), exist_ok=True)
    _write(os.path.join(one_store, "bank", TS, "test.json"), {})
    jr = CampaignJournal("c-full")
    jr.write_meta({"status": "complete", "cells": ["a", "b", "c"]})
    jr.append_cell({"cell": "a", "outcome": True, "valid": True,
                    "path": run, "wall_s": 1.5, "worker": "local"})
    jr.append_cell({"cell": "b", "outcome": False, "valid": False,
                    "path": os.path.join(one_store, "reg", TS2),
                    "wall_s": 2.25, "worker": "local#2"})
    jr.append_cell({"cell": "c", "outcome": "crashed", "valid": None,
                    "path": None, "wall_s": 0.5, "worker": "local#2"})
    cdir = tstore.campaign_path("c-full")
    _write(os.path.join(cdir, "metrics.json"), _metrics())
    _write(os.path.join(cdir, "metrics_fold.json"), _metrics())
    _write(os.path.join(cdir, "bubble_ledger.json"),
           {"episodes": 3, "device_s": 1.25, "idle_s": 0.5,
            "attribution_frac": 0.875})
    _write(os.path.join(cdir, "fleet_analysis.json"),
           {"counts": {"error": 1, "warning": 2, "info": 0}})
    _write(os.path.join(cdir, "campaign_trace.jsonl"), "")
    _write(os.path.join(cdir, "capacity_plan.json"), {})
    _write(os.path.join(cdir, "report.json"),
           {"capacity": {"oracle": {"predicted": [["cas-register", 128]],
                                    "actual": [["cas-register", 128],
                                               ["mutex", 64]],
                                    "error_frac": 0.5},
                         "recommendation": {"set_n_floor": 128}}})
    bare = CampaignJournal("c-bare")
    bare.write_meta({"status": "running", "cells": ["x"]})
    return one_store


@pytest.mark.parametrize("page", ["home", "campaigns", "run-dir",
                                  "campaign-dir", "fast-tests",
                                  "utilization"])
def test_viewer_pages_equal_jax(rich_store, page):
    run = os.path.join(rich_store, "reg", TS)
    render = {
        "home": lambda w: w._home_page(),
        "campaigns": lambda w: w._campaigns_page(),
        "run-dir": lambda w: w._dir_page(f"reg/{TS}", run),
        "campaign-dir": lambda w: w._dir_page(
            "campaigns/c-full", tstore.campaign_path("c-full")),
        "fast-tests": lambda w: w._fast_tests(),
        "utilization": lambda w: w._utilization_rows(
            "c-full", tstore.latest_campaign_records("c-full")),
    }[page]
    got, want = render(tweb), render(jweb)
    assert got == want
    text = json.dumps(got)
    if page == "home":
        assert "valid-true" in text and "valid-false" in text
        assert "violation @12" in text and "journal" in text
    if page == "campaigns":
        assert "1 error(s), 2 warning(s)" in text
        assert "merged trace" in text and "Padding waste" in text
        assert "Where the time goes" in text and "idle bubbles" in text
    if page == "run-dir":
        assert "monitor: violation" in text and "torch-wgl" in text


@pytest.fixture()
def servers():
    """A server of each package over the same store; shut down after."""
    made = []

    def make(pkg, **opts):
        web = tweb if pkg == "torch" else jweb
        if pkg == "torch":
            opts.setdefault("device", "cpu")
        srv = web.serve({"ip": "127.0.0.1", "port": 0, **opts})
        made.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}"

    yield make
    for srv in made:
        srv.shutdown()
        srv.server_close()


def _post(base, path, data, headers=None):
    req = urllib.request.Request(
        base + path, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_api_check_roundtrip_equals_jax(servers):
    body = json.dumps({"history": BAD_HIST, "model": "register",
                       "engine": "wgl"}).encode()
    got = {}
    for pkg in ("torch", "jax"):
        tsvc.reset()
        jsvc.reset()
        status, r = _post(servers(pkg), "/api/check", body)
        r.pop("wall_s")
        got[pkg] = (status, r)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 200 and got["torch"][1]["valid"] is False


def test_oversized_body_gets_413_before_any_read(servers):
    for pkg in ("torch", "jax"):
        s, r = _post(servers(pkg), "/api/check", b"x",
                     headers={"Content-Length":
                              str(tsvc.MAX_BODY_BYTES + 1)})
        assert s == 413 and "exceeds" in r["error"]


def test_json_errors_equal_jax(servers):
    out = {}
    for pkg in ("torch", "jax"):
        base = servers(pkg)
        row = [_post(base, "/api/nope", b"{}"),
               _post(base, "/api/check", b"{not json"),
               _post(base, "/api/check", b"[1, 2]")]
        s, _h, b = _get(base, "/api/check")
        row.append((s, json.loads(b)))
        s, _h, b = _get(base, "/api/campaigns/x/y", )
        row.append((s, json.loads(b)))
        conn = http.client.HTTPConnection(base[len("http://"):],
                                          timeout=30)
        conn.putrequest("POST", "/api/check", skip_accept_encoding=True)
        conn.endheaders()
        resp = conn.getresponse()
        row.append((resp.status, json.loads(resp.read())))
        conn.close()
        req = urllib.request.Request(base + "/files/x", data=b"{}")
        try:
            urllib.request.urlopen(req, timeout=30)
        except urllib.error.HTTPError as e:
            row.append((e.code, e.read()))
        out[pkg] = row
    assert out["torch"] == out["jax"]
    assert [r[0] for r in out["torch"]] == [404, 400, 400, 405, 400, 411,
                                           404]


def test_campaign_listing_and_status(servers):
    CampaignJournal("listed").write_meta({"status": "complete"})
    for pkg in ("torch", "jax"):
        base = servers(pkg)
        s, _h, b = _get(base, "/api/campaigns")
        assert s == 200 and json.loads(b)["campaigns"] == ["listed"]
        s, _h, b = _get(base, "/api/campaigns/listed")
        assert json.loads(b)["status"] == "complete"


def test_browse_zip_and_traversal_guard(servers, rich_store):
    for pkg in ("torch", "jax"):
        base = servers(pkg)
        s, _h, home = _get(base, "/")
        assert s == 200 and b"reg" in home
        s, _h, listing = _get(base, f"/files/reg/{TS}/")
        assert b"results.json" in listing
        s, h, _b = _get(base, f"/files/reg/{TS}")
        assert s == 200       # redirected to the trailing slash
        s, h, data = _get(base, f"/files/reg/{TS}/results.json")
        assert b"valid" in data and "json" in h["Content-Type"]
        s, h, z = _get(base, f"/files/reg/{TS}.zip")
        assert z[:2] == b"PK" and h["Content-Type"] == "application/zip"
        conn = http.client.HTTPConnection(base[len("http://"):],
                                          timeout=30)
        conn.request("GET", "/files/../../etc/passwd")
        assert conn.getresponse().status in (403, 404)
        conn.close()
        s, _h, _b = _get(base, "/nowhere")
        assert s == 404


def test_token_gates_every_route(servers, rich_store):
    base = servers("torch", token="sekrit")
    for path in ("/", "/campaigns", f"/files/reg/{TS}/", "/api/metrics",
                 "/api/campaigns"):
        s, h, b = _get(base, path)
        assert s == 401 and h.get("WWW-Authenticate") == "Bearer", path
        assert "error" in json.loads(b)
        s, _h, _b = _get(base, path,
                         headers={"Authorization": "Bearer sekrit"})
        assert s == 200, path
    s, _h, _b = _get(base, "/campaigns?token=sekrit")
    assert s == 200
    s, _r = _post(base, "/api/check", json.dumps(
        {"history": BAD_HIST, "model": "register"}).encode())
    assert s == 401


def test_shed_is_429_with_retry_after_over_socket(servers):
    base = servers("torch", token="sekrit",
                   budgets={"concurrent-checks": 1, "queue-depth": 0},
                   **{"queue-wait-s": 0})
    gate = tsvc.admission()
    with gate.check_slot("token"):
        req = urllib.request.Request(
            base + "/api/check",
            data=json.dumps({"history": BAD_HIST, "model": "register",
                             "engine": "wgl"}).encode(),
            headers={"Authorization": "Bearer sekrit"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 429
        assert int(e.value.headers["Retry-After"]) >= 1
        assert "budget" in json.loads(e.value.read())["error"]
    assert _counted("check", "429", 1) == 1


def test_a_burst_past_the_budget_is_answered_not_reset(servers):
    """32 clients at once against a full gate: the listener's accept
    queue holds them all (socketserver's default holds 5), and each gets
    its 429, none a reset connection."""
    import threading
    base = servers("torch", token="sekrit",
                   budgets={"concurrent-checks": 1, "queue-depth": 0},
                   **{"queue-wait-s": 0})
    assert tweb.Server.request_queue_size >= 32
    burst = 32
    barrier, codes = threading.Barrier(burst), []
    body = json.dumps({"history": BAD_HIST, "model": "register",
                       "engine": "wgl"}).encode()

    def call():
        req = urllib.request.Request(
            base + "/api/check", data=body,
            headers={"Authorization": "Bearer sekrit"})
        barrier.wait()
        try:
            urllib.request.urlopen(req, timeout=30)
            codes.append(200)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
        except OSError as e:
            codes.append(repr(e))

    with tsvc.admission().check_slot("token"):
        threads = [threading.Thread(target=call) for _ in range(burst)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIME_LIMIT_S)
    assert codes == [429] * burst


def test_metrics_route_serves_a_registered_source(servers):
    base = servers("torch")
    tsvc.register_metrics_source(
        "fleet:live", lambda: {"gauges": {"fleet.pending_cells": 3}})
    s, h, body = _get(base, "/api/metrics")
    text = body.decode()
    assert s == 200 and h["Content-Type"].startswith("text/plain")
    assert "jepsen_fleet_pending_cells 3" in text
    assert "jepsen_admission_shed_total" in text
    tsvc.unregister_metrics_source("fleet:live")
    s, _h, body = _get(base, "/api/metrics")
    assert b"pending_cells" not in body
    assert _counted("metrics", "200", 2) == 2


def test_a_browsed_miss_fetches_on_demand(servers, monkeypatch,
                                          one_store):
    """A /files path that is not on disk asks ``fleet.sync`` for it (a
    remote cell whose sync failed) and serves it once pulled."""
    asked = []

    def fetch(rel):
        asked.append(rel)
        _write(os.path.join(one_store, rel, "results.json"),
               {"valid": True})
        return True

    monkeypatch.setattr(tsync, "pending", lambda: {"r/t": {}})
    monkeypatch.setattr(tsync, "fetch_on_demand", fetch)
    base = servers("torch")
    s, _h, b = _get(base, "/files/r/t/")
    assert s == 200 and b"results.json" in b
    assert asked == ["r/t"]
    monkeypatch.setattr(tsync, "pending", lambda: {})
    s, _h, _b = _get(base, "/files/r/gone/")
    assert s == 404 and asked == ["r/t"]


@pytest.mark.parametrize("plan_form", ["path", "dict", "unreadable"])
def test_serve_capacity_plan_raises_before_any_socket(plan_form, tmp_path):
    """``capacity-plan`` pre-registers the plan's predicted shapes on the
    coalescer, as the reference's does; an unreadable plan is logged
    and the coalescer starts with none planned."""
    from jepsen_tpu_torch.analysis import capplan
    plan, _ = capplan.build_plan(
        {"base": {"workload": "register"},
         "axes": {"per-key-limit": [20, 120]}})
    path = str(tmp_path / "capacity_plan.json")
    capplan.dump_plan(plan, path)
    cap = {"path": path, "dict": plan,
           "unreadable": str(tmp_path / "nope.json")}[plan_form]
    srv = tweb.serve({"ip": "127.0.0.1", "port": 0, "device": "cpu",
                      "capacity-plan": cap})
    try:
        planned = tsvc.coalescer().stats()["planned"]
    finally:
        srv.shutdown()
        srv.server_close()
    assert planned == (0 if plan_form == "unreadable" else 2)


def test_serve_without_a_device_means_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve resolves CUDA")
    opened = []
    monkeypatch.setattr(tweb, "ThreadingHTTPServer",
                        lambda *a: opened.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        tweb.serve({"ip": "127.0.0.1", "port": 0})
    assert opened == []


def _counted(endpoint, status, n):
    """Wait for the server's request accounting, which runs after the
    response is written, to reach ``n``."""
    reg = tsvc.slo_registry()
    deadline = time.monotonic() + 10
    while reg.counter_value("service.requests", endpoint=endpoint,
                            status=status) < n \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return reg.counter_value("service.requests", endpoint=endpoint,
                             status=status)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_subcommand_end_to_end(tmp_path):
    """``python -m jepsen_tpu_torch serve --token T --device cpu`` in a
    subprocess: 401, the verdict, 413, /api/metrics, then exit 0 within
    10 s of SIGINT."""
    port = _free_port()
    log = open(tmp_path / "serve.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve", "--host",
         "127.0.0.1", "--port", str(port), "--token", "T", "--device",
         "cpu"], cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": ROOT})
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 40
        while True:
            assert proc.poll() is None, "serve exited early"
            try:
                with socket.create_connection(("127.0.0.1", port), 1):
                    break
            except OSError:
                assert time.monotonic() < deadline, "never listened"
                time.sleep(0.1)
        body = json.dumps({"history": BAD_HIST, "model": "register"})
        assert _post(base, "/api/check", body.encode())[0] == 401
        auth = {"Authorization": "Bearer T"}
        s, r = _post(base, "/api/check", body.encode(), headers=auth)
        assert s == 200 and r["valid"] is False
        assert _post(base, "/api/check", b"x",
                     headers={**auth, "Content-Length":
                              str(tsvc.MAX_BODY_BYTES + 1)})[0] == 413
        s, _h, text = _get(base, "/api/metrics", headers=auth)
        assert s == 200 and b"jepsen_service_coalesce_batches" in text
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.seek(0)
        out = log.read()
        log.close()
    assert "Listening on http://127.0.0.1:" in out


def _cli(argv, cwd):
    return subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch"] + argv, cwd=cwd,
        capture_output=True, text=True, timeout=50,
        env={**os.environ, "PYTHONPATH": ROOT})


@pytest.mark.parametrize("argv,code,text", [
    (["serve", "--host", "0.0.0.0", "--port", "0", "--device", "cpu"],
     254, "PL016"),
    (["serve", "--host", "127.0.0.1", "--port", "0", "--device", "cpu",
      "--coalesce-window-ms", "0"], 254, "PL020"),
    (["campaign", "--no-ssh", "--lint", "--axis", "workload=noop",
      "--serve", "--serve-ip", "10.0.0.1", "--device", "cpu"],
     1, "PL016"),
])
def test_service_preflights_refuse(argv, code, text, tmp_path):
    r = _cli(argv, str(tmp_path))
    assert r.returncode == code, r.stderr[-2000:]
    assert text in r.stdout + r.stderr


def test_serve_without_a_card_exits_255_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve would listen")
    r = _cli(["serve", "--host", "127.0.0.1", "--port", "0"],
             str(tmp_path))
    assert r.returncode == 255
    assert "CUDA" in r.stderr and "Listening" not in r.stdout


def test_campaign_serve_runs_the_viewer_beside_the_sweep(tmp_path):
    """``campaign --serve`` serves the viewer and /api while its cells
    run, on the campaign's device, and exits as the campaign does."""
    port = _free_port()
    r = _cli(["campaign", "--no-ssh", "--axis", "workload=noop",
              "--seeds", "1", "--time-limit", "1", "--serve",
              "--serve-ip", "127.0.0.1", "--serve-port", str(port),
              "--campaign-id", "served", "--device", "cpu"],
             str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Web server on http://127.0.0.1:" in r.stderr
    with open(tmp_path / "store" / "campaigns" / "served"
              / "report.json") as f:
        assert json.load(f)["status"] == "complete"
