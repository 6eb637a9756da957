"""The port's fleet (``jepsen_tpu_torch/fleet/{ledger,backends,worker,
dispatch}``, the scheduler's ``ledger=`` and ``backends=``, planlint
PL014) against the JAX package's.

Pure functions are fed the same inputs on both sides and compared
whole. Dispatch runs real loopback worker processes: the reference's
under ``JAX_PLATFORMS=cpu`` with its own builder, the port's with
``jepsen_tpu_torch.demo:demo_test`` and ``device: "cpu"`` in the base
options. Each package writes into a store of its own. Masked, and why:
which worker ran a cell and its pid (thread scheduling), wall clocks,
the clock handshake stamps, ``writer`` (``host:pid``) and absolute
paths (each side's store root). Everything else -- the per-cell outcome
fold, the terminal-once records, lease counts, steal attempts and the
report's summary -- is compared at equality."""

import json
import os
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import store as jstore
from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu.campaign import plan as jplan
from jepsen_tpu.campaign import scheduler as jscheduler
from jepsen_tpu.fleet import backends as jbackends
from jepsen_tpu.fleet import dispatch as jdispatch
from jepsen_tpu.fleet import ledger as jledger
from jepsen_tpu.fleet import worker as jworker
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.analysis import planlint as tplanlint
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.campaign import scheduler as tscheduler
from jepsen_tpu_torch.fleet import backends as tbackends
from jepsen_tpu_torch.fleet import dispatch as tdispatch
from jepsen_tpu_torch.fleet import ledger as tledger
from jepsen_tpu_torch.fleet import worker as tworker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NOOP = {"nodes": ["n1"], "concurrency": 1, "ssh": {"dummy?": True},
        "time-limit": 1, "workload": "noop"}
SIDES = {
    "jax": dict(store=jstore, cc=jcc, ledger=jledger, dispatch=jdispatch,
                scheduler=jscheduler, builder="jepsen_tpu.demo:demo_test",
                options=NOOP),
    "torch": dict(store=tstore, cc=tcc, ledger=tledger,
                  dispatch=tdispatch, scheduler=tscheduler,
                  builder="jepsen_tpu_torch.demo:demo_test",
                  options=dict(NOOP, device="cpu")),
}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "torch"))
    jcc.reset()
    tcc.reset()
    yield
    jcc.reset()
    tcc.reset()


def _cells(n=2):
    return jplan.expand({"axes": {"seed": list(range(n)),
                                  "workload": ["noop"]}})


def _run_both(cells_fn=lambda side: _cells(), workers="local,local", **kw):
    """run_fleet on both sides over fresh copies of the same cells
    (``cells_fn(side_name)``); returns {side: report}."""
    out = {}
    for name, side in SIDES.items():
        out[name] = side["dispatch"].run_fleet(
            cells_fn(name), side["dispatch"].parse_workers(workers),
            builder=side["builder"], base_options=side["options"],
            lease_s=120, **kw)
    return out


_VOLATILE = ("worker", "pid", "clock", "wall_s", "writer", "path", "t",
             "error")


def _mask(rec):
    out = {k: v for k, v in rec.items() if k not in _VOLATILE}
    if "die-once-marker" in (out.get("params") or {}):
        # each side's marker is a file of its own
        out["params"] = dict(out["params"], **{"die-once-marker": "m"})
    return out


def _terminal_counts(side, cid):
    counts = {}
    for r in side["store"].load_campaign_records(cid):
        if not r.get("event"):
            counts[r["cell"]] = counts.get(r["cell"], 0) + 1
    return counts


def _fold(side, cid):
    return sorted((_mask(r) for r in
                   side["store"].latest_campaign_records(cid)),
                  key=lambda r: r["cell"])


def _events(side, cid, kind):
    return sorted((e["cell"], e.get("attempt"))
                  for e in side["store"].campaign_events(cid)
                  if e["event"] == kind)


# ---------------------------------------------------------------------------
# ledger: persistence, cross-process visibility, torn tails


def _both(fn):
    return {name: fn(side) for name, side in SIDES.items()}


def test_ledger_survives_process_restart():
    def go(side):
        cc, led = side["cc"], side["ledger"]
        led.attach()
        a = [cc.note("e", ("spec", 64, True)) for _ in range(2)]
        cc.reset()
        led.attach()
        return a, cc.note("e", ("spec", 64, True)), cc.stats()
    out = _both(go)
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == ([False, True], True)


def test_ledger_sees_sibling_process_appends():
    def go(side):
        side["ledger"].attach()
        sibling = side["ledger"].Ledger(side["store"].compile_ledger_path())
        sibling.record("e", ("other-shape", 128))
        return side["cc"].note("e", ("other-shape", 128))
    assert _both(go) == {"jax": True, "torch": True}


def test_ledger_cross_process_for_real():
    """A second python process appends through the port's ledger (jax
    and the JAX package blocked in it); this one hits on both sides'
    readers of that file."""
    d = tstore.compile_ledger_path()
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jepsen_tpu'] = None\n"
            "from jepsen_tpu_torch.fleet import ledger as fl\n"
            f"fl.Ledger({d!r}).record('e', ('from-child', 7))\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                   cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    tledger.attach()
    assert tcc.note("e", ("from-child", 7)) is True
    jledger.attach(d, jax_cache=False)
    assert jcc.note("e", ("from-child", 7)) is True


def test_ledger_torn_tail_and_fragment_tolerated():
    def go(side):
        led = side["ledger"].attach()
        led.record("e", ("good", 1))
        with open(led.path, "ab") as f:
            f.write(b'{"engine": "e", "key": [trunc')
        led2 = side["ledger"].Ledger(led.dir)
        first = sorted(led2.refresh())
        led2.record("e", ("after-tear", 2))
        led3 = side["ledger"].Ledger(led.dir)
        st = led3.stats()
        with open(led.path, "rb") as f:
            lines = [ln for ln in f.read().split(b"\n") if ln]
        return (first, sorted(led3.refresh()), st["shapes"],
                [json.loads(ln)["key"] if ln.startswith(b'{"engine": "e", '
                                                        b'"key": ["') and
                 ln.endswith(b"}") else None for ln in lines])
    out = _both(go)
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == 2


@pytest.mark.parametrize("partial", [b'{"key": ["chaos-torn', b"{", b""])
def test_ledger_refresh_leaves_a_torn_final_line_for_later(partial):
    """A final line with no newline yet is left unparsed; once its
    writer completes it, the next refresh picks it up."""
    def go(side):
        led = side["ledger"].Ledger(side["store"].compile_ledger_path())
        led.record("e", ("k", 1))
        with open(led.path, "ab") as f:
            f.write(partial)
        before = sorted(led.refresh())
        with open(led.path, "ab") as f:
            f.write(b'_x"]}\n' if partial else b"")
        after = sorted(led.refresh())
        led.record("e", ("k", 2))
        return before, after, sorted(led.refresh()), led.stats()["shapes"]
    out = _both(go)
    assert out["torch"] == out["jax"]


def test_ledger_stats_aggregate_across_processes():
    def go(side):
        led = side["ledger"].attach()
        led.record("e", ("s1", 1))
        led.note_stats(5, 2, cold_wall_s=1.25, warm_wall_s=0.5)
        side["ledger"].Ledger(led.dir).note_stats(3, 1)
        st = led.stats()
        return {k: v for k, v in st.items() if k != "path"}
    out = _both(go)
    assert out["torch"] == out["jax"]
    assert (out["torch"]["hits"], out["torch"]["misses"]) == (8, 3)


def test_ledger_attach_is_idempotent_per_dir():
    def go(side):
        fl = side["ledger"]
        led = fl.attach()
        same = fl.attach() is led and fl.attached() is led
        fl.detach(expected=fl.Ledger(led.dir))
        kept = fl.attached() is led
        fl.detach(expected=led)
        return same, kept, fl.attached()
    assert _both(go) == {"jax": (True, True, None),
                         "torch": (True, True, None)}


@pytest.mark.parametrize("key", [
    ("spec", 64, True, 2.5), ("s", (1, 2), 3), ("s", [4, [5, 6]], None),
    ("cas-register", 1024, 8, 4, 2)])
def test_canon_key_roundtrips_json_types(key):
    import numpy as np
    key = tuple(np.int64(x) if isinstance(x, int)
                and not isinstance(x, bool) else x for x in key)
    k = tledger.canon_key("e", key)
    assert k == jledger.canon_key("e", key)
    assert tledger.canon_key("e", json.loads(json.dumps(list(k[1])))) == k


def test_fold_walls_equal():
    recs = [{"wall_s": 1.5, "compile-cache": {"hits": 0, "misses": 2}},
            {"wall_s": 0.25, "compile-cache": {"hits": 3, "misses": 0}},
            {"wall_s": 4.0},
            {"wall_s": None, "compile-cache": {"misses": 1}},
            {"wall_s": 2, "compile-cache": {}}]
    assert tledger.fold_walls(recs) == jledger.fold_walls(recs) == \
        (1.5, 0.25)


def test_attach_points_no_jax_cache_anywhere():
    """The reference's ``attach`` points jax's persistent compilation
    cache at ``compile_ledger/jax_cache``; the port has no per-shape
    compile cache, so ``jax_cache=True`` makes no directory and loads
    no jax (ROADMAP.md, deliberate divergences)."""
    code = ("import os, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jepsen_tpu'] = None\n"
            "from jepsen_tpu_torch import store\n"
            f"store.base_dir = {str(tstore.base_dir)!r}\n"
            "from jepsen_tpu_torch.fleet import ledger\n"
            "led = ledger.attach(jax_cache=True)\n"
            "print(sorted(os.listdir(led.dir)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert not hasattr(tledger, "enable_jax_cache")
    jledger.attach()
    assert os.path.isdir(jstore.compile_ledger_path("jax_cache"))


def _quick_test(side_name, name):
    from jepsen_tpu import tests as jtst
    from jepsen_tpu_torch import tests as ttst
    t = (jtst if side_name == "jax" else ttst).noop_test()
    t.update({"ssh": {"dummy?": True}, "obs?": False, "name": name,
              "nodes": ["n1"], "concurrency": 1})
    return t


@pytest.mark.parametrize("ledger", [True, False])
def test_run_cells_reports_the_ledger_block(ledger):
    out = {}
    for name, side in SIDES.items():
        rep = side["scheduler"].run_cells(
            [{"id": "a", "test": _quick_test(name, "led")}],
            campaign_id="led", ledger=ledger)
        cc = rep["compile_cache"]
        led = cc.get("ledger")
        rec = side["store"].latest_campaign_records("led")[0]
        out[name] = (sorted(cc), sorted(led or {}),
                     led and os.path.exists(led["path"]),
                     rec.get("compile-cache"),
                     os.path.exists(side["store"].compile_ledger_path(
                         "ledger.jsonl")))
    assert out["torch"] == out["jax"]
    assert out["torch"][2] is (True if ledger else None)


# ---------------------------------------------------------------------------
# planlint PL014


@pytest.mark.parametrize("cfg", [
    {"workers": ["local", "local#2"], "lease-s": 600, "time-limit": 60},
    {"workers": []}, {"workers": ["a", "a", " "]}, {"lease-s": 0},
    {"lease-s": -3}, {"lease-s": True}, {"lease-s": "10"},
    {"lease-s": 5, "time-limit": 10}, {"lease-s": 10, "time-limit": 10},
    {"serve?": True, "device-slots": 0},
    {"serve?": True, "device-slots": 2},
    {"backends": ["gpu", "cpu"]}, {"backends": ["cpu"]}, None, {}])
def test_pl014_equal(cfg):
    def d(diags):
        return [dict(vars(x)) for x in diags]
    assert d(tplanlint.lint_fleet(cfg)) == d(jplanlint.lint_fleet(cfg))


@pytest.mark.parametrize("tiers,ref_codes", [
    (["tpu", "cpu"], []), (["gpu", "warp"], ["PL014"])])
def test_pl014_names_the_ports_tiers(tiers, ref_codes):
    """``tpu`` is a tier of the reference and none of the port's, so the
    port's PL014 names its own tier list (ROADMAP.md, deliberate
    divergences)."""
    assert [x.code for x in jplanlint.lint_fleet({"backends": tiers})] \
        == ref_codes
    diags = tplanlint.lint_fleet({"backends": tiers})
    assert [(x.code, x.severity) for x in diags] == [("PL014", "error")]
    assert "known tiers are ['gpu', 'cpu']" in diags[0].message


# ---------------------------------------------------------------------------
# parse_workers, the worker's result protocol


@pytest.mark.parametrize("spec,ssh", [
    ("local,local,name=local,db1:22", None),
    (["h1"], {"username": "u", "port": 2222, "password": "ignored"}),
    ("local,localhost,127.0.0.1,local", None),
    ("a=h:2201,b=h:2202,h", {"private-key-path": "/k",
                             "strict-host-key-checking": False}),
    ("", None), ([], None), (" , x ,", None)])
def test_parse_workers_equal(spec, ssh):
    def shape(ws):
        return [(w.id, w.host, w.kind, w.conn_spec, repr(w)) for w in ws]
    assert shape(tdispatch.parse_workers(spec, ssh=ssh)) == \
        shape(jdispatch.parse_workers(spec, ssh=ssh))


@pytest.mark.parametrize("out", [
    "", "noise\nJEPSEN-FLEET-RESULT: {\"outcome\": true}",
    "JEPSEN-FLEET-RESULT: {tor", "JEPSEN-FLEET-RESULT: [1, 2]",
    "JEPSEN-FLEET-RESULT: null",
    "JEPSEN-FLEET-RESULT: {\"a\": 1}\nJEPSEN-FLEET-RESULT: {\"a\": 2}\n",
    None])
def test_worker_parse_result_equal(out):
    assert tworker.parse_result(out) == jworker.parse_result(out)
    assert tworker.RESULT_MARKER == jworker.RESULT_MARKER


def test_worker_resolve_builder():
    with pytest.raises(ValueError):
        tworker.resolve_builder("no-colon")
    from jepsen_tpu_torch import demo
    assert tworker.resolve_builder(
        "jepsen_tpu_torch.demo:demo_test") is demo.demo_test


def test_worker_contains_builder_crash():
    rec = tworker.run_cell_spec({
        "cell": "x", "campaign": "c",
        "builder": "jepsen_tpu_torch.demo:does_not_exist",
        "store-dir": tstore.base_dir})
    ref = jworker.run_cell_spec({
        "cell": "x", "campaign": "c",
        "builder": "jepsen_tpu.demo:does_not_exist",
        "store-dir": jstore.base_dir})
    assert rec["outcome"] == ref["outcome"] == "crashed"
    assert "does_not_exist" in rec["error"]
    assert sorted(rec) == sorted(ref)


def test_worker_told_nothing_runs_on_cuda(monkeypatch):
    """No device in the spec means CUDA: without a card the register
    build raises and the cell records ``crashed`` with the error,
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"cell": "r", "campaign": "c", "store-dir": tstore.base_dir,
            "ledger": False,
            "options": dict(NOOP, workload="register")}
    rec = tworker.run_cell_spec(spec)
    assert rec["outcome"] == "crashed"
    assert "CUDA" in rec["error"]
    assert "backend" not in rec
    # the cpu tier carries the device option to the build, and the run
    # then decides on the CPU
    rec = tworker.run_cell_spec(dict(spec, backend="cpu"))
    assert rec["outcome"] is True and rec["backend"] == "cpu"


# ---------------------------------------------------------------------------
# dispatch: loopback fleets of real worker processes


def test_fleet_loopback_two_workers():
    reps = _run_both(campaign_id="fl")
    for name, side in SIDES.items():
        rep = reps[name]
        assert rep["status"] == "complete" and rep["mode"] == "fleet"
        assert rep["workers"] == ["local", "local#2"]
        recs = side["store"].latest_campaign_records("fl")
        assert {r["worker"] for r in recs} <= {"local", "local#2"}
        assert all(r.get("pid") not in (None, os.getpid()) for r in recs)
    assert sorted(reps["torch"]) == sorted(reps["jax"])
    assert reps["torch"]["summary"] == reps["jax"]["summary"] == {
        "cells": 2, "skipped-resumed": 0, "outcomes": {"True": 2}}
    t, j = SIDES["torch"], SIDES["jax"]
    assert _fold(t, "fl") == _fold(j, "fl")
    assert _terminal_counts(t, "fl") == _terminal_counts(j, "fl") == {
        c["id"]: 1 for c in _cells(2)}
    assert _events(t, "fl", "lease") == _events(j, "fl", "lease")
    assert reps["torch"]["fleet_analysis"]["counts"] == \
        reps["jax"]["fleet_analysis"]["counts"] == \
        {"error": 0, "warning": 0, "info": 0}
    assert reps["torch"]["fleet_analysis"]["checks"] == \
        reps["jax"]["fleet_analysis"]["checks"]
    from jepsen_tpu.campaign.journal import CampaignJournal as JJ
    from jepsen_tpu_torch.campaign.journal import CampaignJournal as TJ
    meta = [{k: v for k, v in J("fl").load_meta().items()
             if k not in ("created", "updated")} for J in (JJ, TJ)]
    assert meta[0] == meta[1]
    assert meta[1]["mode"] == "fleet" and meta[1]["status"] == "complete"


def test_fleet_worker_death_steals_cell(tmp_path):
    """kill -9 one worker mid-cell (a die-once marker): the cell is
    re-leased and re-run with the same outcome, and the journal holds
    exactly one terminal record per cell, on both sides."""
    def cells(side):
        cs = _cells(2)
        cs[0]["params"]["die-once-marker"] = str(tmp_path / f"{side}-die")
        return cs
    reps = _run_both(cells, campaign_id="steal")
    victim = _cells(2)[0]["id"]
    assert (tmp_path / "jax-die").exists()
    assert (tmp_path / "torch-die").exists()
    t, j = SIDES["torch"], SIDES["jax"]
    assert reps["torch"]["summary"] == reps["jax"]["summary"]
    assert reps["torch"]["status"] == "complete"
    assert _fold(t, "steal") == _fold(j, "steal")
    stolen = [r for r in tstore.latest_campaign_records("steal")
              if r["cell"] == victim][0]
    assert stolen["attempt"] == 2 and stolen["outcome"] is True
    assert _events(t, "steal", "lease") == _events(j, "steal", "lease")
    assert [(c, a) for c, a in _events(t, "steal", "lease")
            if c == victim] == [(victim, 1), (victim, 2)]
    failed = sorted(e["cell"] for e in tstore.campaign_events("steal")
                    if e["event"] == "lease-failed")
    assert failed == [victim]
    assert _terminal_counts(t, "steal") == \
        _terminal_counts(j, "steal") == {c["id"]: 1 for c in _cells(2)}


def test_fleet_resume_skips_terminal_cells():
    _run_both(campaign_id="res")
    reps = _run_both(campaign_id="res", resume=True)
    assert reps["torch"]["summary"] == reps["jax"]["summary"]
    assert reps["torch"]["summary"]["skipped-resumed"] == 2
    for name, side in SIDES.items():
        assert len(_events(side, "res", "lease")) == 2
        with pytest.raises(side["dispatch"].FleetError):
            side["dispatch"].run_fleet(
                _cells(2), side["dispatch"].parse_workers("local"),
                campaign_id="res", base_options=side["options"])


@pytest.mark.parametrize("workers,kw", [
    ([], {}), ("local", {"lease_s": 0}), ("local,local", {"lease_s": -1})])
def test_fleet_pl014_errors_refuse_the_run(workers, kw):
    for name, side in SIDES.items():
        with pytest.raises(side["dispatch"].FleetError, match="PL014"):
            side["dispatch"].run_fleet(
                _cells(1), side["dispatch"].parse_workers(workers),
                campaign_id="nope", base_options=side["options"], **kw)
        assert side["store"].campaigns() == []


@pytest.mark.parametrize("kw", [{"capacity": "plan"},
                                {"device_mem_budget": 1 << 30},
                                {"capacity_plan": {"cells": []}}])
def test_fleet_capacity_raises_naming_d5(kw):
    with pytest.raises(NotImplementedError, match=r"A\.11\(d5\)"):
        tdispatch.run_fleet(_cells(1), tdispatch.parse_workers("local"),
                            campaign_id="cap", **kw)
    assert tstore.campaigns() == []


# ---------------------------------------------------------------------------
# backends: failover tiering


def test_failover_ladder_caching_and_floor():
    def run(mod, ladder):
        calls = []

        def fake_probe(tier, timeout_s=None):
            calls.append(tier)
            return None if tier == "gpu" else "down"

        f = mod.Failover(ladder=ladder, probe_fn=fake_probe)
        return [f.choose(), f.choose()], calls
    assert run(tbackends, ("gpu", "cpu")) == \
        run(jbackends, ("gpu", "cpu")) == (["gpu", "gpu"], ["gpu"])
    for mod in (tbackends, jbackends):
        down = mod.Failover(probe_fn=lambda t, timeout_s=None: "down")
        assert down.choose() == "cpu"
        with pytest.raises(ValueError):
            mod.Failover(ladder=("warp",))
        with pytest.raises(ValueError):
            mod.Failover(ladder=())
        assert mod.as_failover("gpu,cpu").ladder == ["gpu", "cpu"]
        assert mod.as_failover(["cpu"]).ladder == ["cpu"]
    assert tbackends.as_failover(True).ladder == ["gpu", "cpu"]


@pytest.mark.parametrize("ladder", [("tpu", "gpu", "cpu"), ("tpu",),
                                    "tpu,cpu"])
def test_a_tpu_tier_raises(ladder):
    with pytest.raises(ValueError, match="no TPU tier"):
        tbackends.as_failover(ladder)
    assert jbackends.as_failover(ladder).ladder[0] == "tpu"
    with pytest.raises(ValueError, match="no TPU tier"):
        tbackends.tier_options("tpu")


def test_tiers_are_the_device_option_not_an_environment():
    assert tbackends.tier_options("cpu") == {"device": "cpu"}
    assert tbackends.tier_options("gpu") == {"device": "cuda"}
    assert jbackends.tier_env("cpu") == {"JAX_PLATFORMS": "cpu"}
    assert not hasattr(tbackends, "tier_env")


def test_backend_apply_degrades_linearizable_gates():
    from jepsen_tpu import checker as jchk
    from jepsen_tpu.checker import checkers as jcks
    from jepsen_tpu.models import register_spec as jreg
    from jepsen_tpu_torch import checker as tchk
    from jepsen_tpu_torch.checker import checkers as tcks
    from jepsen_tpu_torch.models import register_spec as treg
    out = {}
    for name, chk, cks, spec, mod in (
            ("jax", jchk, jcks, jreg, jbackends),
            ("torch", tchk, tcks, treg, tbackends)):
        lin = cks.Linearizable(spec, "jax-wgl")
        test = {"checker": chk.compose({"w": lin, "stats": cks.stats()})}
        mod.apply(test, "cpu")
        lin2 = cks.Linearizable(spec, "jax-wgl")
        t2 = mod.apply({"checker": lin2}, "gpu")
        out[name] = (lin.algorithm, test["backend"], lin2.algorithm,
                     t2["backend"])
    assert out["torch"] == out["jax"] == ("linear", "cpu", "jax-wgl", "gpu")


def test_cpu_probe_is_healthy_here():
    assert tbackends.probe("cpu") is None


def test_gpu_probe_reads_the_card():
    err = tbackends.probe("gpu")
    if torch.cuda.is_available():
        assert err is None
    else:
        assert err is not None and "CUDA" in err


def _ok_register_test(side_name):
    """A register test whose checker is one Linearizable gate."""
    if side_name == "jax":
        from jepsen_tpu import client as jc
        from jepsen_tpu import generator as gen
        from jepsen_tpu.checker import checkers as cks
        from jepsen_tpu.models import register_spec as spec
    else:
        from jepsen_tpu_torch import client as jc
        from jepsen_tpu_torch import generator as gen
        from jepsen_tpu_torch.checker import checkers as cks
        from jepsen_tpu_torch.models import register_spec as spec

    class OkClient(jc.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            return dict(op, type="ok")

    lin = cks.Linearizable(spec, "jax-wgl")
    t = _quick_test(side_name, "bk")
    t.update({"client": OkClient(), "checker": lin,
              "generator": gen.clients(gen.limit(
                  3, gen.repeat({"f": "read"})))})
    return t, lin


def test_scheduler_applies_backend_tier():
    out = {}
    for name, side in SIDES.items():
        t, lin = _ok_register_test(name)
        f = (tbackends if name == "torch" else jbackends).Failover(
            ladder=("gpu", "cpu"),
            probe_fn=lambda t_, timeout_s=None: "down")
        rep = side["scheduler"].run_cells([{"id": "a", "test": t}],
                                          campaign_id="bk", backends=f)
        rec = side["store"].latest_campaign_records("bk")[0]
        out[name] = (rec["backend"], lin.algorithm, rep["summary"])
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == ("cpu", "linear")


def test_fleet_backends_journal_cpu_when_the_gpu_probe_fails(monkeypatch):
    """``backends`` gpu,cpu with the gpu probe stubbed down: every cell
    journals the cpu tier, on both sides; the port's workers get it as
    the device option, the reference's as ``JAX_PLATFORMS``. The port's
    base options name no device, so its register cells reach the CPU
    through the tier alone."""
    def down(t, timeout_s=None):
        return None if t == "cpu" else "down"

    for mod in (jbackends, tbackends):
        monkeypatch.setattr(mod, "as_failover",
                            lambda x, mod=mod: mod.Failover(
                                ladder=list(x), probe_fn=down))
    out = {}
    for name, side in SIDES.items():
        rep = side["dispatch"].run_fleet(
            _cells(2), side["dispatch"].parse_workers("local,local"),
            campaign_id="bk", builder=side["builder"],
            base_options=dict(NOOP, workload="register")
            if name == "torch" else dict(side["options"]),
            lease_s=120, backends=["gpu", "cpu"])
        out[name] = (rep["summary"]["cells"],
                     sorted(r.get("backend") for r in
                            side["store"].latest_campaign_records("bk")))
    assert out["torch"] == out["jax"] == (2, ["cpu", "cpu"])
    recs = tstore.latest_campaign_records("bk")
    assert all(r["outcome"] is True for r in recs)
