"""The port's store reader (``python -m jepsen_tpu_torch.trace_summary``)
against the JAX package's ``tools/trace_summary.py``, loaded with
``importlib`` as the JAX package's own tests load it, on the same run
and campaign directories: stores the port writes (``core.run`` on the
CPU, the campaign scheduler, the fleet dispatcher) and stores the JAX
package writes. The texts must be equal line for line once the port's
divergent lines (ROADMAP.md C, "The store reader") are put back into
the reference's words (``to_reference``); each divergence has its own
assertion below. The exit codes of both command lines are compared on
good and bad arguments."""

import importlib.util
import json
import os
import random
import re
import subprocess
import sys
import threading
import time

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import tests as ttst
from jepsen_tpu_torch import trace_summary as pts
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.checker import checkers as tcheckers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "trace_summary.py")
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("trace_summary_ref", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_reference(text):
    """The port's summary with each divergent line put back into the
    reference tool's words, and the port's added note lines dropped."""
    out = []
    notes = {pts.DUTY_NOTE, pts.COMPILE_NOTE, pts.CAPACITY_NOTE}
    for line in text.split("\n"):
        if line in notes:
            continue
        if line == pts.NO_MERGED_TRACE:
            line = pts.NO_MERGED_TRACE.replace("jepsen_tpu_torch.",
                                               "jepsen_tpu.")
        if line == pts.DUTY_TITLE.strip("\n"):
            line = "-- device duty cycle --"
        elif line == pts.BUBBLE_TITLE.strip("\n"):
            line = "-- idle bubbles (makespan minus device-compute) --"
        line = re.sub(r"^( *[-\d.]+s)  dispatch \(", r"\1  busy (", line)
        line = line.replace("%  dispatch duty cycle (dispatch / wall;",
                            "%  duty cycle (busy / wall;")
        line = re.sub(r"^( *[-\d.]+s)  device lap \(",
                      r"\1  device-compute (", line)
        m = re.match(r"recommendation: an op-count floor of (\d+) would "
                     r"collapse the plan shapes to (\d+) \(from (\d+)\); "
                     r"the port's floor is a constant and a coarser "
                     r"bucket only adds padding rows$", line)
        if m:
            line = (f"recommendation: set_n_floor({m[1]}) -> {m[2]} "
                    f"shape(s) (from {m[3]})")
        out.append(line)
    return "\n".join(out)


def assert_parity(ref_text, port_text):
    assert to_reference(port_text).split("\n") == ref_text.split("\n")


# ---------------------------------------------------------------------------
# port runs on the CPU


class StaleRegister(tclient.Client):
    """A register client that applies the first ``apply_n`` writes and
    acknowledges the rest without applying them: reads then show the
    lost writes, and a monitor reports a violation instant."""

    def __init__(self, apply_n=3):
        self.apply_n = apply_n
        self.value = None
        self.n = 0
        self.lock = threading.Lock()

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        time.sleep(0.001)
        out = dict(op, type="ok")
        with self.lock:
            if op["f"] == "write":
                self.n += 1
                if self.n <= self.apply_n:
                    self.value = op["value"]
            else:
                out["value"] = self.value
        return out


def _register_test(name, **kw):
    rng = random.Random(45100)
    t = ttst.noop_test()
    t.update({"name": name, "ssh": {"dummy?": True}, "concurrency": 4,
              "client": ttst.atom_client(ttst.Atom(None)),
              "checker": tcheckers.linearizable({
                  "model": "cas-register", "algorithm": "jax-wgl",
                  "engine_opts": CPU}),
              "generator": tgen.clients(tgen.limit(60, tgen.mix([
                  lambda: {"f": "read"},
                  lambda: {"f": "write", "value": rng.randint(0, 4)}])))})
    t.update(kw)
    return t


def _writes_then_reads():
    import itertools
    c = itertools.count(1)

    def g(test, ctx):
        n = next(c)
        if n % 2:
            return {"type": "invoke", "f": "write", "value": n}
        return {"type": "invoke", "f": "read"}

    return g


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Three port runs in one store: a plain run (no monitor, no
    certificate, one flat search: a search plan would split the history
    at its quiescent points, which follow the run's timing, and send the
    segments to the batch engine), a monitored certified run, and a
    monitored run whose lost writes the monitor reports (its violation
    instant)."""
    prev = tstore.base_dir
    tstore.base_dir = str(tmp_path_factory.mktemp("torch-store"))
    try:
        plain = tcore.run(_register_test(
            "plain", **{"certify?": False, "searchplan?": False}))
        certified = tcore.run(_register_test(
            "certified", monitor={"chunk": 8, "engine-opts": CPU}))
        violation = tcore.run(_register_test(
            "violation", concurrency=1, client=StaleRegister(),
            monitor={"chunk": 4, "engine": "wgl"}, **{"time-limit-s": 60},
            generator=tgen.clients(_writes_then_reads()),
            checker=tcheckers.linearizable({"model": "cas-register",
                                            "algorithm": "wgl"})))
        yield {"plain": plain, "certified": certified,
               "violation": violation,
               "dirs": {k: tstore.path(t) for k, t in (
                   ("plain", plain), ("certified", certified),
                   ("violation", violation))}}
    finally:
        tstore.base_dir = prev


def test_plain_run_equals_the_reference(ref, port_runs):
    d = port_runs["dirs"]["plain"]
    text = pts.summarize(d)
    assert_parity(ref.summarize(d), text)
    for section in ("lifecycle phases", "op latency (60 ops, from trace "
                    "spans)", "op counts", "WGL search telemetry",
                    "padding waste"):
        assert section in text
    assert "verdict certificate" not in text
    assert "streaming monitor" not in text


def test_monitored_run_with_a_violation_equals_the_reference(ref,
                                                             port_runs):
    test = port_runs["violation"]
    assert test["results"]["abort-reason"] == "monitor-violation"
    d = port_runs["dirs"]["violation"]
    text = pts.summarize(d)
    assert_parity(ref.summarize(d), text)
    idx = test["results"]["monitor"]["detected_at_index"]
    assert f"!! monitor violation at history index {idx} " in text
    assert "-- streaming monitor --" in text


def test_certified_run_equals_the_reference(ref, port_runs):
    d = port_runs["dirs"]["certified"]
    assert os.path.exists(os.path.join(d, "certificate.json"))
    text = pts.summarize(d)
    assert_parity(ref.summarize(d), text)
    assert "\n-- verdict certificate --\nclean: verdict True" in text
    assert "-- streaming monitor --" in text


def test_op_count_is_the_history_s_client_ops(port_runs):
    test = port_runs["plain"]
    ops = sum(1 for o in test["history"]
              if isinstance(o["process"], int) and o["type"] != "invoke")
    assert f"-- op latency ({ops} ops, from trace spans) --" in \
        pts.summarize(port_runs["dirs"]["plain"])


# ---------------------------------------------------------------------------
# the divergent lines, one assertion each


def test_duty_cycle_says_dispatch_wall_not_device_time(port_runs):
    text = pts.summarize(port_runs["dirs"]["plain"])
    assert pts.DUTY_TITLE + "\n" + pts.DUTY_NOTE + "\n" in text
    assert "device duty cycle" not in text
    assert re.search(r"^ *[\d.]+s  dispatch \(jax-wgl\)", text, re.M)
    assert not re.search(r"s  busy \(", text)
    assert "profile_main" in pts.DUTY_NOTE and "torch.profiler" in \
        pts.DUTY_NOTE


def test_bubble_ledger_names_the_device_lap(port_runs):
    text = pts.summarize(port_runs["dirs"]["plain"])
    assert pts.BUBBLE_TITLE in text
    assert "device-compute" not in text
    assert re.search(r"^ *[\d.]+s  device lap \(\d+ lane", text, re.M)


def _write_metrics(d, counters):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump({"counters": counters, "gauges": {}, "histograms": {}},
                  f)


def test_compile_lap_note_only_when_a_compile_lap_is_there(ref, tmp_path):
    with_lap = str(tmp_path / "lap")
    _write_metrics(with_lap, {
        "wgl.phase_s{engine=torch-wgl,phase=compile}": 0.25,
        "wgl.phase_s{engine=torch-wgl,phase=device}": 0.5})
    text = pts.summarize(with_lap)
    assert_parity(ref.summarize(with_lap), text)
    assert text.endswith("torch-wgl:\n     0.500s  device   ( 66.7%)\n"
                         "     0.250s  compile  ( 33.3%)\n"
                         + pts.COMPILE_NOTE)
    without = str(tmp_path / "nolap")
    _write_metrics(without, {
        "wgl.phase_s{engine=torch-wgl,phase=device}": 0.5})
    assert pts.COMPILE_NOTE not in pts.summarize(without)


def test_padding_waste_table_equals_the_reference(ref, tmp_path):
    """The padding-waste table and duty cycle from a run's metrics.json,
    as ``tests/test_introspection.py`` feeds the reference tool, with the
    port's engine label as the artifact holds it."""
    d = str(tmp_path / "run")
    _write_metrics(d, {
        "wgl.cells_real{bucket=128,engine=torch-wgl}": 100,
        "wgl.cells_padded{bucket=128,engine=torch-wgl}": 28,
        "wgl.device_busy_s{engine=torch-wgl}": 0.5})
    text = pts.summarize(d)
    assert_parity(ref.summarize(d), text)
    assert "-- padding waste (per n-bucket) --" in text
    assert "     128         100          28   21.9%" in text
    assert "     0.500s  dispatch (torch-wgl)" in text
    assert "(no trace wall to compute the duty cycle against)" in text


def test_capacity_recommendation_names_the_floor_not_a_setter(ref,
                                                              tmp_path):
    cdir = str(tmp_path / "campaigns" / "rec")
    os.makedirs(cdir)
    report = {"capacity": {
        "oracle": {"predicted": [["cas-register", 64],
                                 ["cas-register", 256]],
                   "actual": [["cas-register", 64]],
                   "missed": [], "unplanned": [], "error_frac": 0.5},
        "recommendation": {"set_n_floor": 256, "distinct_after": 1,
                           "distinct_before": 2}}}
    lines = pts._capacity_lines(cdir, report)
    assert to_reference("\n".join(lines)) == \
        "\n".join(ref._capacity_lines(cdir, report))
    assert pts.CAPACITY_NOTE in lines
    rec = [x for x in lines if x.startswith("recommendation:")]
    assert rec == ["recommendation: an op-count floor of 256 would "
                   "collapse the plan shapes to 1 (from 2); the port's "
                   "floor is a constant and a coarser bucket only adds "
                   "padding rows"]
    assert "set_n_floor" not in "\n".join(lines)


# ---------------------------------------------------------------------------
# campaigns


@pytest.fixture
def stores(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "torch"))
    jcc.reset()
    tcc.reset()
    yield tmp_path
    jcc.reset()
    tcc.reset()


def test_planned_campaign_equals_the_reference(ref, stores):
    """A register campaign planned by the port's capacity planner, at
    the smallest size of ``tests/test_capplan.py``'s oracle campaign."""
    from jepsen_tpu_torch import campaign
    from jepsen_tpu_torch.analysis import capplan
    from jepsen_tpu_torch.cli import test_opt_fn
    from jepsen_tpu_torch.demo import demo_test

    options = test_opt_fn({"no-ssh": True, "workload": "register",
                           "time-limit": 1, "concurrency": "1n",
                           "nodes": "n1,n2", "device": "cpu"})
    cells_plan = campaign.plan.expand({"axes": {"seed": [0]}})
    plan, _diags = capplan.preflight(cells_plan, base=options, mode="plan")
    lock = threading.Lock()

    def build(params):
        o = dict(options)
        o.update(params)
        with lock:
            random.seed(params["seed"])
            return demo_test(o)

    report = campaign.run_cells(
        [{"id": c["id"], "group": c["group"], "params": c["params"],
          "build": build} for c in cells_plan],
        campaign_id="oracle", capacity_plan=plan)
    assert report["capacity"]["oracle"]["error_frac"] == 0.0
    cdir = tstore.campaign_path("oracle")
    text = pts.summarize_campaign(cdir)
    assert_parity(ref.summarize_campaign(cdir), text)
    assert "\n-- capacity plan (predicted vs actual) --\n" + \
        pts.CAPACITY_NOTE + "\n" in text
    assert "prediction error: 0.0 (0 missed, 0 unplanned)" in text
    assert "\n-- fleetlint audit --\nclean: 0 error(s)" in text


NOOP = {"nodes": ["n1"], "concurrency": 1, "ssh": {"dummy?": True},
        "time-limit": 1, "workload": "noop"}


def test_fleet_merged_trace_equals_the_reference(ref, stores):
    """A fleet campaign's merged trace (one seeded worker kill, as in
    ``tests/test_obs_fleet.py``): one lane per worker beside the
    coordinator's, the per-worker rows read from the port's span names
    (``fleet.cell``, ``fleet.artifact_sync``, ``jepsen.run``,
    ``analyze``)."""
    from jepsen_tpu.campaign import plan as jplan
    from jepsen_tpu_torch.fleet import dispatch as tdispatch
    cells = jplan.expand({"axes": {"seed": [0, 1], "workload": ["noop"]}})
    cells[0]["params"]["die-once-marker"] = str(stores / "die")
    rep = tdispatch.run_fleet(
        cells, tdispatch.parse_workers("local,local"),
        campaign_id="obsfleet", base_options=dict(NOOP, device="cpu"),
        lease_s=120)
    assert rep["status"] == "complete"
    cdir = tstore.campaign_path("obsfleet")
    text = pts.summarize_campaign(cdir)
    assert_parity(ref.summarize_campaign(cdir), text)
    lanes = re.findall(r"^lane \d+: (.*?)(?:   cells|$)", text, re.M)
    assert lanes[0] == "coordinator"
    assert sorted(lanes[1:]) == sorted(f"worker {w}"
                                       for w in rep["trace"]["workers"])
    rows = text.split("-- per-worker (exec / search / sync) --\n")[1]
    for w in rep["trace"]["workers"]:
        assert re.search(rf"^ *{re.escape(w)}  exec +[\d.]+s \(", rows,
                         re.M)
        assert re.search(rf"^ *worker {re.escape(w)}  run +[\d.]+s   "
                         r"search/analyze", rows, re.M)
    assert "\n-- fleetlint audit --\nclean: 0 error(s)" in text
    # without the persisted audit and folds both tools audit and fold in
    # process, each through its own package's modules
    for f in ("fleet_analysis.json", "metrics_fold.json",
              "bubble_ledger.json"):
        os.remove(os.path.join(cdir, f))
    before = tstore.base_dir
    text = pts.summarize_campaign(cdir)
    assert tstore.base_dir == before
    assert_parity(ref.summarize_campaign(cdir), text)
    assert "\n-- fleetlint audit --\nclean: 0 error(s)" in text


# ---------------------------------------------------------------------------
# stores the JAX package writes


def test_jax_run_equals_the_reference(ref, stores):
    from test_obs import _run_dummy
    test = _run_dummy("summary-jax")
    d = jstore.path(test)
    text = pts.summarize(d)
    assert_parity(ref.summarize(d), text)
    assert "jepsen.run" in text and "p50" in text


def test_jax_campaign_equals_the_reference(ref, stores):
    from jepsen_tpu import campaign as jcampaign
    from jepsen_tpu.analysis import capplan as jcap
    from test_capplan import quick_cells
    plan, _ = jcap.build_plan(
        {"axes": {"workload": ["noop"], "seed": [0, 1]}})
    jcampaign.run_cells(quick_cells(), campaign_id="persist",
                        capacity_plan=plan)
    cdir = jstore.campaign_path("persist")
    text = pts.summarize_campaign(cdir)
    assert_parity(ref.summarize_campaign(cdir), text)
    assert "prediction error: 0.0" in text


# ---------------------------------------------------------------------------
# containment and the store root


def test_store_root_is_restored_after_an_exception(tmp_path):
    before = tstore.base_dir
    cdir = str(tmp_path / "store" / "campaigns" / "c1")
    with pytest.raises(RuntimeError):
        with pts._store_rooted_at(cdir) as cid:
            assert cid == "c1"
            assert tstore.base_dir == str(tmp_path / "store")
            raise RuntimeError("boom")
    assert tstore.base_dir == before


def test_store_root_scopes_in_threads_restore_the_root(tmp_path):
    before = tstore.base_dir
    seen = []

    def read(i):
        for _ in range(50):
            with pts._store_rooted_at(
                    str(tmp_path / f"s{i}" / "campaigns" / "c")):
                seen.append(tstore.base_dir == str(tmp_path / f"s{i}"))

    threads = [threading.Thread(target=read, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(seen) and len(seen) == 400
    assert tstore.base_dir == before


def test_bubble_fold_is_contained_but_not_notimplemented(monkeypatch,
                                                         port_runs):
    from jepsen_tpu_torch.obs import bubbles
    d = port_runs["dirs"]["plain"]

    def boom(exc):
        def fold(events, *a, **k):
            raise exc
        return fold

    monkeypatch.setattr(bubbles, "fold_events", boom(ValueError("x")))
    text = pts.summarize(d)
    assert "idle bubbles" not in text and "op counts" in text
    monkeypatch.setattr(bubbles, "fold_events",
                        boom(NotImplementedError("unported")))
    with pytest.raises(NotImplementedError):
        pts.summarize(d)


def test_fresh_audit_is_contained_but_not_notimplemented(monkeypatch,
                                                         tmp_path):
    from jepsen_tpu_torch.analysis import fleetlint
    cdir = str(tmp_path / "store" / "campaigns" / "c1")
    os.makedirs(cdir)
    monkeypatch.setattr(fleetlint, "audit", lambda *a, **k: 1 / 0)
    assert pts._fleet_audit(cdir) is None
    assert "(no fleet_analysis.json and the audit could not run)" in \
        pts.summarize_campaign(cdir)

    def unported(*a, **k):
        raise NotImplementedError("unported")

    monkeypatch.setattr(fleetlint, "audit", unported)
    with pytest.raises(NotImplementedError):
        pts._fleet_audit(cdir)


# ---------------------------------------------------------------------------
# the command line


def _cli(args, cwd, port):
    cmd = [sys.executable, "-m", "jepsen_tpu_torch.trace_summary"] \
        if port else [sys.executable, TOOL]
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(cmd + args, capture_output=True, text=True,
                          timeout=120, cwd=cwd, env=env)


@pytest.mark.parametrize("case", ["run", "bad-dir", "campaign",
                                  "bad-campaign", "no-campaigns",
                                  "latest"])
def test_cli_exit_codes_equal_the_reference(case, port_runs, tmp_path):
    cwd = str(tmp_path)
    d = port_runs["dirs"]["plain"]
    if case in ("campaign", "latest"):
        os.makedirs(tmp_path / "store" / "campaigns" / "c1")
        if case == "latest":
            os.symlink(d, tmp_path / "store" / "latest")
    args = {"run": [d], "bad-dir": ["/nonexistent-dir-xyz"],
            "campaign": ["--campaign", "c1"],
            "bad-campaign": ["--campaign", "nope"],
            "no-campaigns": ["--campaign"], "latest": []}[case]
    port = _cli(args, cwd, True)
    jax = _cli(args, cwd, False)
    assert port.returncode == jax.returncode == \
        {"run": 0, "bad-dir": 1, "campaign": 0, "bad-campaign": 1,
         "no-campaigns": 1, "latest": 0}[case], (port.stderr, jax.stderr)
    assert port.stderr.strip().splitlines()[-1:] == \
        jax.stderr.strip().splitlines()[-1:] if port.returncode else True
    assert to_reference(port.stdout) == jax.stdout
    if case == "bad-dir":
        assert "not a directory" in port.stderr


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jepsen_tpu'] = None; "
            "import jepsen_tpu_torch.trace_summary as t; "
            "import jepsen_tpu_torch.profile_main; "
            "print(t.main(['/nonexistent-dir-xyz']))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "1"


def test_shared_lines_are_the_reference_s(ref):
    """Every line the port shares with the reference is built by the
    same code: the module's helpers not named as divergences are the
    reference's, token for token, outside their docstrings."""
    import ast
    import inspect

    def body(fn):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        node = tree.body[0]
        if ast.get_docstring(node):
            node.body = node.body[1:]
        return ast.dump(node)

    for name in ("_quantile", "_fmt_s", "_stream_lines",
                 "_certificate_lines", "_resolve_campaign_dir",
                 "_span_sum", "main"):
        assert body(getattr(pts, name)) == body(getattr(ref, name)), name
