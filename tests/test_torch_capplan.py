"""The port's capacity planner (``jepsen_tpu_torch.analysis.capplan``) and
size model (``sizemodel``) held against the JAX package's on the same
matrices, with tolerance zero: plan JSON, diagnostics and the prediction
oracle equal the reference's except three fields, each of which differs
only as stated (ROADMAP.md, deliberate divergences):

* the ``hbm`` byte figures (and the byte counts and slot counts derived
  from them in CP004-CP006): the port counts its own buffers;
* CP003's message and fix text: the port's op-count floor is a
  constant;
* the shapes' engine labels: ``torch-wgl-batch`` for ``jax-wgl-batch``.

The port's figures are held as upper bounds on the CPU too: the peak
of the CPU allocator (``torch.profiler`` with ``profile_memory``) over a
search, a key batch, a fold and a closure stays under the prediction."""

import json
import random
import re
import threading

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu.analysis import capplan as jcap
from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.analysis import sizemodel as jsize
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.analysis import capplan as tcap
from jepsen_tpu_torch.analysis import planlint as tplanlint
from jepsen_tpu_torch.analysis import shapelint
from jepsen_tpu_torch.analysis import sizemodel as tsize
from jepsen_tpu_torch.campaign import compile_cache as tcc


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "torch"))
    jcc.reset()
    tcc.reset()
    yield
    jcc.reset()
    tcc.reset()


REGISTER_MATRIX = {"base": {"workload": "register", "concurrency": 10},
                   "axes": {"seed": [0, 1], "per-key-limit": [20, 40]}}

FRAGMENTED_MATRIX = {
    "base": {"workload": "register"},
    "axes": {"per-key-limit": [20, 120, 260, 600, 1200], "seed": [0]}}

CP007_MATRIX = {"base": {"workload": "register",
                         "per-key-limit": 7_000_000},
                "axes": {"seed": [0]}}

CP008_MATRIX = {"base": {"workload": "register", "per-key-limit": 2 ** 25},
                "axes": {"seed": [0]}}

#: the JAX package's engine labels -> the port's
LABELS = {"jax-wgl": "torch-wgl", "jax-wgl-batch": "torch-wgl-batch",
          "streamlin": "torch-streamlin",
          "streamlin-batch": "torch-streamlin-batch"}

#: the codes whose text carries byte figures (or slot counts from them)
BYTE_CODES = ("CP004", "CP005", "CP006")


def codes(diags):
    return [d.code for d in diags]


def _shape(sh, jax_side):
    """A plan shape without its byte figures, under the port's label."""
    out = {k: v for k, v in sh.items() if k != "hbm"}
    if jax_side:
        out["engine"] = LABELS.get(out["engine"], out["engine"])
    return out


def _diag(d):
    """One diagnostic dict as compared: CP003's text dropped (held by
    ``test_cp003_text_describes_the_port``), byte figures masked."""
    d = dict(d)
    if d["code"] == "CP003":
        d.pop("message"), d.pop("fix_hint")
    elif d["code"] in BYTE_CODES:
        for k in ("message", "fix_hint"):
            if d.get(k):
                d[k] = re.sub(r"[\d,]+", "#", d[k])
    return d


def _plan(plan, jax_side):
    """A plan as compared: the three stated fields set aside."""
    plan = json.loads(json.dumps(plan))
    for cell in plan["cells"]:
        cell["shapes"] = [_shape(s, jax_side) for s in cell["shapes"]]
    for k in ("per_cell_peak_bytes", "auto_slots"):
        plan["hbm"].pop(k)
    plan["diagnostics"]["diagnostics"] = [
        _diag(d) for d in plan["diagnostics"]["diagnostics"]]
    return plan


def _both(fn):
    """(jax result, port result) of ``fn(capplan module)``."""
    return fn(jcap), fn(tcap)


def _same_plans(matrix, **kw):
    (jp, jd), (tp, td) = _both(lambda m: m.build_plan(matrix, **kw))
    assert _plan(tp, False) == _plan(jp, True)
    assert codes(td) == codes(jd)
    return tp, td


# ---------------------------------------------------------------------------
# sizemodel: delegation and the reference's arithmetic


def test_plan_sizes_delegates_to_live_engine():
    from jepsen_tpu_torch.checker import torch_wgl
    for args in ((64, 1, 4), (1024, 8, 16), (16384, 8192, 512),
                 (2048, 2, 64)):
        assert tsize.plan_sizes(*args) == torch_wgl._plan_sizes(*args) \
            == jsize.plan_sizes(*args)


def test_bucket_for_delegates_to_compile_cache():
    for n in (1, 22, 64, 65, 1000, 5000):
        assert tsize.bucket_for(n) == tcc.bucket_for(n) \
            == jsize.bucket_for(n)
    # the port's floor is the reference's default, and a constant
    assert tsize.n_floor() == jsize.n_floor() == 64
    assert not hasattr(tcc, "set_n_floor")


def test_history_cell_math_matches_jaxlint_formula():
    for args in ((10, 1, 2), (10, 2, 1), (16384, 2, 256)):
        assert tsize.history_cells(*args) == jsize.history_cells(*args)
    assert tsize.history_ranks(10) == jsize.history_ranks(10) == 20
    assert tsize.history_cells(10, arg_width=1, keys=2) == 2 * 10 * 6
    for args in ((64, 1), (16384, 1), (2 ** 25, 1)):
        assert tsize.buffer_cells(*args) == jsize.buffer_cells(*args)
        assert tsize.int32_wall(*args, S=1) == jsize.int32_wall(*args, S=1)


def test_jaxlint_delegates_to_sizemodel(monkeypatch):
    # capplan must consume sizemodel's math, not a private copy: an
    # inflated sizemodel answer must flip CP008 on a tiny matrix
    assert "CP008" not in codes(tcap.build_plan(REGISTER_MATRIX)[1])
    monkeypatch.setattr(tsize, "history_cells",
                        lambda n, a=1, k=1: tsize.INT32_CELL_LIMIT)
    assert "CP008" in codes(tcap.build_plan(REGISTER_MATRIX)[1])


def test_search_shape_register():
    j = jsize.search_shape("cas-register", 22, concurrency=10)
    t = tsize.search_shape("cas-register", 22, concurrency=10)
    assert _shape(t, False) == _shape(j, True)
    assert t["bucket"] == 64 and t["A"] == 2 and t["S"] == 1
    assert t["engine"] == "torch-wgl-batch"
    assert set(t["hbm"]) == set(j["hbm"])
    assert t["hbm"]["total"] == sum(v for k, v in t["hbm"].items()
                                    if k != "total") > 0
    assert 0 < t["int32"]["frac"] < 0.5


def test_ledger_key_shape_projections():
    # the reference's key layouts under the port's labels
    solo = ("cas-register", 64, 2, 1, 4, 2, 64, 4096, 1024, "auto",
            None, None)
    batch = ["cas-register", 8, 64, 64, 2, 1, 4, 2, 4096, 1024, 1, 0,
             None, False]
    fold = ("cas-register", 1, 4096, 8, 1, 8, 64, 2)
    for jlabel, key in (("jax-wgl", solo), ("jax-wgl-batch", batch),
                        ("streamlin", fold), ("streamlin-batch", fold)):
        want = jsize.ledger_key_shape(jlabel, key)
        assert want is not None
        assert tsize.ledger_key_shape(LABELS[jlabel], key) == want
        # a label of the other package projects nothing
        assert tsize.ledger_key_shape(jlabel, key) is None
    assert tsize.ledger_key_shape("linear", ("m", 64)) is None
    assert tsize.ledger_key_shape("torch-wgl", ()) is None


def test_ledger_key_shape_matches_live_notes():
    """The projection reads the keys the port's engines really note."""
    from jepsen_tpu_torch.checker import torch_wgl
    from jepsen_tpu_torch.models import model_spec
    from jepsen_tpu_torch.parallel import keyshard
    from jepsen_tpu_torch import simulate
    spec = model_spec("cas-register")
    hist = simulate.random_history(random.Random(3), "cas-register", 4,
                                   120, 0.0)
    e, st = spec.encode(hist)
    before = tcc.noted_keys()
    torch_wgl.check_encoded(spec, e, st, device="cpu")
    keyshard.check_batch_encoded(spec, [(e, st)], device="cpu")
    got = {tsize.ledger_key_shape(eng, k)
           for eng, k in tcc.noted_keys() - before}
    assert got == {("cas-register", tsize.bucket_for(len(e)))}


# ---------------------------------------------------------------------------
# build_plan: the CP codes, each from a golden fixture


def test_cp002_census_and_single_bucket():
    plan, diags = _same_plans(REGISTER_MATRIX)
    assert plan["compiles"]["keys"] == [["cas-register", 64]]
    assert plan["unknown_cells"] == 0
    assert "CP002" in codes(diags)
    assert not [d for d in diags if d.severity == "error"]


def test_cp001_unknown_workload_and_runtime_bound():
    plan, diags = _same_plans({"axes": {"workload": ["mystery"]}})
    assert "CP001" in codes(diags)
    assert plan["unknown_cells"] == 1
    assert plan["cells"][0]["unknown"] is True
    _, diags = _same_plans(
        {"base": {"workload": "register", "per-key-limit": 0},
         "axes": {"seed": [0]}})
    assert "CP001" in codes(diags)


def test_known_empty_workloads_are_not_unknown():
    plan, diags = _same_plans(
        {"axes": {"workload": ["noop", "bank", "set"]}})
    assert plan["unknown_cells"] == 0
    assert plan["compiles"]["distinct"] == 0
    assert "CP001" not in codes(diags)


def test_txn_and_monitored_cells_plan_as_the_reference():
    plan, diags = _same_plans(
        {"base": {"workload": "append", "txn-count": 3000,
                  "monitor": {"engine": "streamlin"}},
         "axes": {"seed": [0]}})
    models = {s["model"] for s in plan["cells"][0]["shapes"]}
    assert models == {"txn-closure", "streamlin"}
    _same_plans({"base": {"workload": "wr", "time-limit": 5,
                          "rate": 20, "concurrency": "2n",
                          "nodes": ["a", "b"]},
                 "axes": {"seed": [0]}})


def test_cp003_fragmented_buckets_with_computed_floor():
    plan, diags = _same_plans(FRAGMENTED_MATRIX)
    assert plan["compiles"]["distinct"] > shapelint.MAX_PLAN_SHAPES
    cp3 = [d for d in diags if d.code == "CP003"]
    assert cp3
    rec = plan["recommendation"]
    assert rec == jcap.build_plan(FRAGMENTED_MATRIX)[0]["recommendation"]
    assert rec["distinct_after"] < rec["distinct_before"]
    assert rec["distinct_after"] <= shapelint.MAX_PLAN_SHAPES
    # the floor the dict names does collapse the census (on the JAX
    # package, which has a floor to set)
    with jcc.bucket_floor(rec["set_n_floor"]):
        plan2, _ = jcap.build_plan(FRAGMENTED_MATRIX)
    assert plan2["compiles"]["distinct"] == rec["distinct_after"]


def test_cp003_text_describes_the_port():
    """CP003 keeps the reference's trigger, location and
    recommendation; its text names no setter the port lacks."""
    (_, jd), (_, td) = _both(lambda m: m.build_plan(FRAGMENTED_MATRIX))
    j3 = [d for d in jd if d.code == "CP003"][0]
    t3 = [d for d in td if d.code == "CP003"][0]
    assert (t3.severity, t3.location) == (j3.severity, j3.location)
    assert "set_n_floor" in j3.fix_hint
    assert "set_n_floor" not in t3.message + t3.fix_hint
    assert "constant" in t3.fix_hint and "padding rows" in t3.fix_hint
    assert "compiles nothing per shape" in t3.message
    rec = tcap.build_plan(FRAGMENTED_MATRIX)[0]["recommendation"]
    assert f"a floor of {rec['set_n_floor']}" in t3.fix_hint


def test_recommend_floor_pow2_and_noop_when_fits():
    for keys in ({("m", 64), ("m", 128)},
                 {("m", b) for b in (64, 128, 256, 512, 1024)},
                 {(m, b) for m in ("a", "b") for b in (64, 256, 1024)}):
        assert tcap.recommend_floor(keys) == jcap.recommend_floor(keys)
    assert tcap.recommend_floor({("m", 64), ("m", 128)}) is None
    rec = tcap.recommend_floor({("m", b) for b in (64, 128, 256, 512,
                                                   1024)})
    f = rec["set_n_floor"]
    assert f & (f - 1) == 0
    assert rec["distinct_after"] <= shapelint.MAX_PLAN_SHAPES


def test_cp004_cell_exceeds_budget():
    plan, diags = _same_plans(REGISTER_MATRIX, device_mem_budget=1024)
    cp4 = [d for d in diags if d.code == "CP004"]
    assert cp4 and cp4[0].severity == "error"
    assert plan["hbm"]["auto_slots"] is None


def test_cp005_cp006_slots_vs_budget():
    plan, diags = _same_plans(REGISTER_MATRIX, device_mem_budget=1 << 30,
                              device_slots=500)
    assert "CP006" in codes(diags)
    cp5 = [d for d in diags if d.code == "CP005"]
    assert cp5 and "auto" in cp5[0].fix_hint
    auto = plan["hbm"]["auto_slots"]
    assert auto >= 1
    assert auto * plan["hbm"]["per_cell_peak_bytes"] <= (1 << 30)
    assert tcap.auto_slots(plan) == auto
    _, diags2 = _same_plans(REGISTER_MATRIX, device_mem_budget=1 << 30,
                            device_slots=1)
    assert "CP005" not in codes(diags2)


def test_hbm_differs_only_in_bytes():
    """The stated divergence: the byte figures are the port's, under the
    reference's field names; the peak cell is the same cell."""
    (jp, _), (tp, _) = _both(lambda m: m.build_plan(
        FRAGMENTED_MATRIX, device_mem_budget=1 << 40))
    for jc_, tc_ in zip(jp["cells"], tp["cells"]):
        for js, ts in zip(jc_["shapes"], tc_["shapes"]):
            assert set(ts["hbm"]) == set(js["hbm"])
            assert ts["hbm"] != js["hbm"]
    assert tp["hbm"]["peak_cell"] == jp["hbm"]["peak_cell"]
    assert tp["hbm"]["per_cell_peak_bytes"] \
        != jp["hbm"]["per_cell_peak_bytes"]


def test_cp007_int32_proximity():
    plan, diags = _same_plans(CP007_MATRIX)
    assert "CP007" in codes(diags)
    assert "CP008" not in codes(diags)
    assert 0.5 <= plan["int32"]["max_frac"] < 1.0


def test_cp008_int32_wall_crossed():
    plan, diags = _same_plans(CP008_MATRIX)
    cp8 = [d for d in diags if d.code == "CP008"]
    assert cp8 and cp8[0].severity == "error"
    assert plan["int32"]["max_frac"] >= 1.0


def test_plan_is_byte_deterministic(tmp_path):
    p1, _ = tcap.build_plan(FRAGMENTED_MATRIX, device_mem_budget=1 << 30)
    p2, _ = tcap.build_plan(FRAGMENTED_MATRIX, device_mem_budget=1 << 30)
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    tcap.dump_plan(p1, str(a))
    tcap.dump_plan(p2, str(b))
    assert a.read_bytes() == b.read_bytes()
    assert tcap.load_plan(str(a)) == p1
    assert tcap.load_plan(str(tmp_path / "nope.json")) is None


def test_render_table_mentions_every_cell():
    plan, _ = tcap.build_plan(REGISTER_MATRIX)
    text = tcap.render_table(plan)
    for cell in plan["cells"]:
        assert cell["cell"] in text
    assert "distinct compile shapes" in text
    frag = tcap.render_table(tcap.build_plan(FRAGMENTED_MATRIX)[0])
    assert "floor is a constant" in frag and "set_n_floor" not in frag


# ---------------------------------------------------------------------------
# PL021


@pytest.mark.parametrize("cfg", [
    {"capacity": "bogus"}, {"capacity": "enforce"},
    {"device-slots": "auto"},
    {"capacity": "warn", "device-mem-budget": -5},
    {"device-mem-budget": 1 << 30},
    {"capacity": "enforce", "device-mem-budget": 1 << 30,
     "unknown-cells": 2},
    {"capacity": "warn"}, {},
])
def test_pl021_matrix(cfg):
    got = [vars(d) for d in tplanlint.lint_capacity(cfg)]
    assert got == [vars(d) for d in jplanlint.lint_capacity(cfg)]
    assert all(d["code"] == "PL021" for d in got)


def test_pl021_capacity_plan_file(tmp_path):
    missing = str(tmp_path / "nope.json")
    ds = tplanlint.lint_capacity({"capacity-plan-file": missing})
    assert codes(ds) == ["PL021"] and ds[0].severity == "error"
    assert "jepsen_tpu_torch.lint --matrix" in ds[0].fix_hint
    plan, _ = tcap.build_plan(REGISTER_MATRIX)
    p = tmp_path / "plan.json"
    tcap.dump_plan(plan, str(p))
    assert tplanlint.lint_capacity({"capacity-plan-file": str(p)}) == []


# ---------------------------------------------------------------------------
# preflight: enforce refusal + containment


def test_enforce_refuses_on_pl021_and_cp_errors():
    for cap in (jcap, tcap):
        with pytest.raises(cap.CapacityError):
            cap.preflight(REGISTER_MATRIX, mode="enforce")
        with pytest.raises(cap.CapacityError):
            cap.preflight(CP008_MATRIX, mode="enforce",
                          device_mem_budget=1 << 40)
    (jp, jd), (tp, td) = _both(lambda m: m.preflight(
        REGISTER_MATRIX, mode="enforce", device_mem_budget=1 << 30))
    assert tp is not None and codes(td) == codes(jd)
    assert not [d for d in td if d.severity == "error"]


def test_preflight_contained_on_planner_crash(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planner bug")
    monkeypatch.setattr(tcap, "build_plan", boom)
    plan, diags = tcap.preflight(REGISTER_MATRIX, mode="warn")
    assert plan is None
    plan, diags = tcap.preflight(REGISTER_MATRIX, mode="enforce",
                                 device_mem_budget=1 << 30)
    assert plan is None


def test_run_fleet_enforce_refusal_is_preflight():
    from jepsen_tpu_torch import fleet
    cells = [{"id": "seed=0", "group": "g", "params": {"seed": 0}}]
    with pytest.raises(fleet.FleetError, match="capacity preflight"):
        fleet.run_fleet(cells, ["local"], capacity="enforce",
                        base_options={"workload": "register",
                                      "device": "cpu"})
    assert tstore.latest_campaign() is None


# ---------------------------------------------------------------------------
# the scheduler wiring: persisted plan, oracle, containment


class OkClient(tclient.Client):
    def open(self, test, node):
        return self

    def invoke(self, test, op):
        out = dict(op)
        out["type"] = "ok"
        return out


def quick_cells(n=2):
    from jepsen_tpu_torch import checker as cc
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import tests as tst

    def cell(i):
        t = tst.noop_test()
        t.update({"name": f"cap-{i}", "ssh": {"dummy?": True},
                  "obs?": False, "nodes": ["n1"], "concurrency": 1,
                  "client": OkClient(), "checker": cc.noop(),
                  "generator": gen.clients(gen.limit(
                      3, gen.repeat({"f": "read"})))})
        return {"id": f"cap-{i}", "test": t}
    return [cell(i) for i in range(n)]


def test_containment_crashing_oracle_never_changes_outcome(monkeypatch):
    from jepsen_tpu_torch import campaign
    from jepsen_tpu_torch.cli import campaign_exit_code
    plan, _ = tcap.build_plan(REGISTER_MATRIX)

    def boom(*a, **k):
        raise RuntimeError("oracle bug")
    monkeypatch.setattr(tcap, "report_section", boom)
    report = campaign.run_cells(quick_cells(), campaign_id="contain",
                                capacity_plan=plan)
    assert report["summary"]["outcomes"] == {"True": 2}
    assert "capacity" not in report
    assert campaign_exit_code(report) == 0


def test_containment_unpersistable_plan(monkeypatch):
    from jepsen_tpu_torch import campaign
    monkeypatch.setattr(tcap, "dump_plan",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("disk full")))
    report = campaign.run_cells(quick_cells(), campaign_id="contain2",
                                capacity_plan={"whatever": 1})
    assert report["summary"]["outcomes"] == {"True": 2}
    assert "capacity" not in report


def test_scheduler_persists_plan_and_runs_oracle():
    from jepsen_tpu_torch import campaign
    plan, _ = tcap.build_plan(
        {"axes": {"workload": ["noop"], "seed": [0, 1]}})
    report = campaign.run_cells(quick_cells(), campaign_id="persist",
                                capacity_plan=plan)
    p = tstore.campaign_path("persist", tcap.PLAN_FILE)
    assert tcap.load_plan(p) == plan
    cap = report["capacity"]
    assert cap["oracle"]["predicted"] == []
    assert cap["oracle"]["error_frac"] == 0.0
    assert cap["path"] == p
    assert cap["oracle"] == jcap.oracle(plan, [])


# ---------------------------------------------------------------------------
# THE prediction oracle: a real CPU register campaign


def test_prediction_oracle_on_real_campaign():
    from jepsen_tpu_torch import campaign, web
    from jepsen_tpu_torch.cli import test_opt_fn
    from jepsen_tpu_torch.demo import demo_test

    options = test_opt_fn({"no-ssh": True, "workload": "register",
                           "time-limit": 1, "concurrency": "1n",
                           "nodes": "n1,n2", "device": "cpu"})
    matrix = {"axes": {"seed": [0]}}
    cells_plan = campaign.plan.expand(matrix)
    plan, _diags = tcap.preflight(cells_plan, base=options, mode="plan")
    assert plan["compiles"]["keys"] == [["cas-register", 64]]

    lock = threading.Lock()

    def build(params):
        o = dict(options)
        o.update(params)
        with lock:
            if "seed" in params:
                random.seed(params["seed"])
            return demo_test(o)

    cells = [{"id": c["id"], "group": c["group"],
              "params": c["params"], "build": build}
             for c in cells_plan]
    report = campaign.run_cells(cells, campaign_id="oracle",
                                capacity_plan=plan)
    assert report["summary"]["outcomes"] == {"True": 1}
    oracle = report["capacity"]["oracle"]
    # the port's labels reach the oracle: zero prediction error
    assert oracle["missed"] == [], oracle
    assert oracle["unplanned"] == [], oracle
    assert oracle["error_frac"] == 0.0
    assert oracle["actual"] == [["cas-register", 64]]
    html_table = web._capacity_table({"report": report})
    assert "cas-register" in html_table and "Predicted" in html_table


def test_cli_device_slots_auto_resolves_from_plan(monkeypatch):
    from jepsen_tpu_torch import campaign as campaign_mod
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.cli import test_opt_fn
    seen = {}

    def fake_run_cells(cells, **kw):
        seen.update(kw, cells=len(cells))
        return {"status": "complete",
                "summary": {"outcomes": {"True": len(cells)}},
                "results": {"True": ["x"] * len(cells)}}

    monkeypatch.setattr(campaign_mod, "run_cells", fake_run_cells)
    cmd = cli.campaign_cmd({"test-fn": lambda o: {}})
    options = test_opt_fn({"no-ssh": True, "workload": "register",
                           "time-limit": 1, "concurrency": "1n",
                           "device": "cpu"})
    options.update({"axis": ["seed=0,1"], "seeds": None,
                    "capacity": "plan",
                    "device-mem-budget": 1 << 30,
                    "device-slots": "auto", "parallel": 1})
    with pytest.raises(SystemExit) as e:
        cmd["campaign"]["run"](options)
    assert e.value.code == 0
    assert isinstance(seen["device_slots"], int)
    assert seen["device_slots"] == seen["capacity_plan"]["hbm"][
        "auto_slots"] >= 1
    assert seen["capacity_plan"]["compiles"]["keys"] \
        == [["cas-register", 64]]


def test_cli_device_slots_auto_rejected_without_plan():
    from jepsen_tpu import cli as jcli
    from jepsen_tpu_torch import cli as tcli
    for cli in (jcli, tcli):
        with pytest.raises(cli.CliError):
            cli.test_all_cmd({"tests-fn": lambda o: []})["test-all"][
                "run"]({"device-slots": "auto"})


# ---------------------------------------------------------------------------
# coalescer bucket pre-registration (through the capacity plan)


def _planned_coalescer(plan_keys, **kw):
    from jepsen_tpu_torch.fleet.service import Coalescer
    return Coalescer(window_s=60.0, planned=plan_keys, device="cpu", **kw)


def test_coalescer_preregistration_rounds_up_to_planned():
    from jepsen_tpu_torch.models import model_spec
    plan, _ = tcap.build_plan({"base": {"workload": "register"},
                               "axes": {"per-key-limit": [200, 900]}})
    keys = sorted(tcap.predicted_keys(plan))
    assert keys == [("cas-register", 256), ("cas-register", 1024)]
    c = _planned_coalescer(keys)
    try:
        spec = model_spec("cas-register")
        assert c._bucket_key(spec, 100) == ("cas-register", 256)
        assert c._bucket_key(spec, 300) == ("cas-register", 1024)
        assert c._bucket_key(spec, 2000) == ("cas-register", 2048)
        assert c._bucket_key(model_spec("register"), 100) \
            == ("register", 128)
        assert c.stats()["planned"] == 2
    finally:
        c.stop()


def test_coalescer_submit_queues_on_planned_bucket():
    from jepsen_tpu_torch.models import model_spec
    c = _planned_coalescer([("cas-register", 512)])
    try:
        spec = model_spec("cas-register")
        item = c.submit(spec, list(range(100)), None, deadline=1e18,
                        owner="t1")
        with c._cond:
            assert list(c._queues) == [("cas-register", 512)]
            assert c._queues[("cas-register", 512)] == [item]
    finally:
        c.stop()


def test_coalescer_without_plan_keeps_raw_rule():
    from jepsen_tpu_torch.models import model_spec
    c = _planned_coalescer(None)
    try:
        assert c._bucket_key(model_spec("cas-register"), 100) \
            == ("cas-register", 128)
        assert c.stats()["planned"] == 0
    finally:
        c.stop()


def test_coalescer_dispatch_compiles_at_planned_bucket(monkeypatch):
    from jepsen_tpu_torch.fleet import service
    from jepsen_tpu_torch.models import model_spec
    from jepsen_tpu_torch.parallel import keyshard
    spec = model_spec("cas-register")
    seen = {}

    def fake_batch(spec_, pairs, **kw):
        seen.update(kw, pairs=len(pairs))
        return [{"valid": True, "configs_explored": 0}] * len(pairs)

    monkeypatch.setattr(keyshard, "check_batch_encoded", fake_batch)
    c = service.Coalescer(window_s=0.01, planned=[("cas-register", 256)],
                          device="cpu")
    try:
        hist = [{"index": 0, "type": "invoke", "f": "write",
                 "value": 1, "process": 0},
                {"index": 1, "type": "ok", "f": "write", "value": 1,
                 "process": 0}]
        e, init = spec.encode(hist)
        import time
        item = c.submit(spec, e, init, deadline=time.monotonic() + 30)
        r = c.wait(item)
        assert r == {"valid": True, "configs_explored": 0}
        assert seen["n_floor"] == 256, seen
    finally:
        c.stop()


def test_keyshard_n_floor_override_raises_pad():
    from jepsen_tpu_torch.models import model_spec
    from jepsen_tpu_torch.parallel import keyshard
    spec = model_spec("cas-register")
    hist = [{"index": 0, "type": "invoke", "f": "write", "value": 1,
             "process": 0},
            {"index": 1, "type": "ok", "f": "write", "value": 1,
             "process": 0},
            {"index": 2, "type": "invoke", "f": "read", "value": None,
             "process": 0},
            {"index": 3, "type": "ok", "f": "read", "value": 1,
             "process": 0}]
    pair = spec.encode(hist)
    before = tcc.noted_keys()
    out = keyshard.check_batch_encoded(spec, [pair], n_floor=128,
                                       device="cpu")
    assert out[0]["valid"] is True
    new = tcc.noted_keys() - before
    buckets = {tsize.ledger_key_shape(e, k) for e, k in new}
    assert ("cas-register", 128) in buckets, buckets


def test_oracle_warm_ledger_keys_are_not_missed():
    (jp, _), (tp, _) = _both(lambda m: m.build_plan(REGISTER_MATRIX))
    key = ("cas-register", 8, 64, 64, 2, 1, 4, 2, 4096, 1024, 1, 0,
           None, False)
    jwarm, twarm = [("jax-wgl-batch", key)], [("torch-wgl-batch", key)]
    o = tcap.oracle(tp, [], warm_keys=twarm)
    assert o == jcap.oracle(jp, [], warm_keys=jwarm)
    assert o["missed"] == [] and o["unplanned"] == []
    assert o["warm"] == [["cas-register", 64]]
    assert o["error_frac"] == 0.0
    o2 = tcap.oracle(tp, twarm, warm_keys=twarm)
    assert o2 == jcap.oracle(jp, jwarm, warm_keys=jwarm)
    assert o2["warm"] == [] and o2["missed"] == []
    assert o2["error_frac"] == 0.0


def test_preflight_budget_alone_builds_no_plan():
    (jp, jd), (tp, td) = _both(lambda m: m.preflight(
        REGISTER_MATRIX, device_mem_budget=1 << 30))
    assert tp is None and jp is None
    assert [vars(d) for d in td] == [vars(d) for d in jd]
    assert codes(td) == ["PL021"] and td[0].severity == "warning"


def test_configure_coalesce_planned_passthrough():
    from jepsen_tpu_torch.fleet import service
    try:
        coal = service.configure_coalesce(
            planned=[("cas-register", 256)], device="cpu")
        assert coal.stats()["planned"] == 1
    finally:
        service.reset()


# ---------------------------------------------------------------------------
# python -m jepsen_tpu_torch.lint --matrix


def test_lint_matrix_clean_and_cp_error(tmp_path, capsys):
    from jepsen_tpu_torch import lint
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(REGISTER_MATRIX))
    assert lint.main(["--matrix", str(clean)]) == 0
    out = capsys.readouterr().out
    assert "capacity plan" in out and "cas-register" in out
    assert lint.main(["--matrix", str(clean), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) \
        == tcap.build_plan(REGISTER_MATRIX)[0]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(CP008_MATRIX))
    assert lint.main(["--matrix", str(bad)]) == 1
    assert "CP008" in capsys.readouterr().out
    assert lint.main(["--matrix", str(bad), "--device-mem-budget",
                      "1G"]) == 1
    assert lint.main(["--matrix", str(tmp_path / "missing.json")]) == 2


# ---------------------------------------------------------------------------
# the port's byte figures are upper bounds (CPU allocator peaks)


#: run in a fresh interpreter: ``torch.profiler`` traces the whole
#: process, and a test process may hold other threads that run torch
#: ops (a competition's straggling racers, a coalescer); the snippet
#: sets ``peak`` (from ``_cpu_peak``) and ``pred`` and the JSON of both
#: is the last line printed
_PEAK_PREAMBLE = r"""
import json, random, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from jepsen_tpu_torch import cycle, simulate
from jepsen_tpu_torch.analysis import sizemodel as tsize
from jepsen_tpu_torch.checker import streamlin, torch_wgl
from jepsen_tpu_torch.models import model_spec
from jepsen_tpu_torch.parallel import keyshard


def _cpu_peak(fn):
    # peak bytes the CPU allocator holds above its level at entry while
    # fn runs, from torch.profiler's memory events
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    events = sorted((e.start_ns(), e.nbytes())
                    for e in prof.profiler.kineto_results.events()
                    if e.nbytes())
    cur = peak = 0
    for _t, nb in events:
        cur += nb
        peak = max(peak, cur)
    return peak


spec = model_spec("cas-register")
# one thread: the ops here are small, and workers beside this process
# hold the cores
torch.set_num_threads(1)
"""


def _peak_and_prediction(snippet):
    """(peak, predicted) bytes from ``snippet`` run after the preamble in
    a subprocess on the CPU."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _PEAK_PREAMBLE + snippet
         + "\nprint(json.dumps([peak, pred]))"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-3000:]
    peak, pred = json.loads(out.stdout.strip().splitlines()[-1])
    return peak, pred


@pytest.mark.parametrize("n_ops,procs", [(600, 16), (2000, 64)])
def test_search_footprint_bounds_the_cpu_peak(n_ops, procs):
    peak, pred = _peak_and_prediction(f"""
hist = simulate.random_history(random.Random(45100), "cas-register",
                               {procs}, {n_ops}, 0.0)
e, st = spec.encode(hist)
prep = torch_wgl._prepare_search(spec, e, st)
assert prep[0] == "search"
*_, n_pad, C, A, S = prep[1]
pred = tsize.hbm_bytes(n_pad, S, C, arg_width=A, engine="torch-wgl",
                       device="cpu")["total"]
peak = _cpu_peak(lambda: torch_wgl.check_encoded(
    spec, e, st, device="cpu", max_configs=1 << 14))
""")
    assert 0.5 * pred <= peak <= pred, (peak, pred)


def test_batch_footprint_bounds_the_cpu_peak():
    peak, pred = _peak_and_prediction("""
keys, _ = simulate.bench_histories(16)
pairs = [spec.encode(h) for h in keys]
pred = tsize.search_shape(
    "cas-register", max(len(p[0]) for p in pairs), keys=16,
    concurrency=8, engine="torch-wgl-batch")["hbm"]["total"]
peak = _cpu_peak(lambda: keyshard.check_batch_encoded(
    spec, pairs, device="cpu"))
""")
    assert 0.5 * pred <= peak <= pred, (peak, pred)


@pytest.mark.parametrize("what", ["fold", "closure"])
def test_fold_and_closure_footprints_bound_the_cpu_peak(what):
    snippet = {"fold": """
hist = simulate.random_history(random.Random(7), "cas-register", 8, 120,
                               0.0)
e, st = spec.encode(hist)
job = streamlin.history_job(spec, e, st, F=1024, device="cpu")
pred = tsize.stream_frontier_shape(
    job.F, job.B * 32, state_size=job.S, arg_width=job.A,
    open_cap=job.C, events=job.E, device="cpu")["hbm"]["total"]
peak = _cpu_peak(lambda: streamlin.solo_fold(job))
""", "closure": """
adj = np.random.RandomState(0).rand(1024, 1024) < 2.0 / 1024
pred = tsize.closure_shape(1024, device="cpu")["hbm"]["total"]
peak = _cpu_peak(lambda: cycle.transitive_closure(adj, device="cpu"))
"""}[what]
    peak, pred = _peak_and_prediction(snippet)
    assert 0.5 * pred <= peak <= pred, (peak, pred)
    if what == "closure":
        # on the card the closure squares in bf16: half the float32 lanes
        assert tsize.closure_shape(1024)["hbm"]["total"] < pred


def test_stream_frontier_on_cuda_counts_the_fold_kernels_scratch():
    """The stated divergence for the fold: on CUDA ``pool`` is the fold
    kernel's scratch (``fold_kernel.plan``), its outputs and its one
    upload, each as the caching allocator charges it, in place of the
    plain fold's transients; the field names stay the reference's."""
    from jepsen_tpu_torch.checker import fold_kernel
    F, NW, S, A, C, E = 8192, 256, 1, 2, 16, 512
    kw = dict(state_size=S, arg_width=A, open_cap=C, events=E)
    ref = jsize.stream_frontier_shape(F, NW, **kw)
    card = tsize.stream_frontier_shape(F, NW, **kw)
    cpu = tsize.stream_frontier_shape(F, NW, device="cpu", **kw)
    assert card == tsize.stream_frontier_shape(F, NW, device="cuda", **kw)
    assert set(card) == set(cpu) == set(ref)
    assert set(card["hbm"]) == set(cpu["hbm"]) == set(ref["hbm"])
    assert {k: v for k, v in card.items() if k != "hbm"} \
        == {k: v for k, v in cpu.items() if k != "hbm"}
    B = NW // 32
    scratch = fold_kernel.scratch_bytes(1, F, B, S, A, C)
    # the scratch counts two row heaps with their fingerprints (F x 4
    # uint32 a heap), the two orders, the seen and work lists and the
    # pool's 32 bytes an entry
    P = F * (C + 1)
    assert scratch >= 2 * 4 * F * (B + S + 4) + 5 * 4 * F + 32 * P
    assert card["hbm"]["pool"] >= scratch + F * (B + S) * 4
    assert card["hbm"]["pool"] <= scratch + F * (B + S) * 4 + (3 << 20)
    assert card["hbm"]["pool"] < cpu["hbm"]["pool"] / 4
    assert card["hbm"]["total"] == sum(
        v for k, v in card["hbm"].items() if k != "total")
    for n in (1, 511, 512, 513, (1 << 20) - 1, 1 << 20):
        got = tsize._charged(n)
        assert got >= n and got % 512 == 0 and got - n < 512 + (
            (1 << 20) if got >= 1 << 20 else 0)


def test_batch_prediction_narrows_with_the_key_axis():
    """A batch of K keys narrows each key's frontier and stack as
    ``keyshard.batch_sizes`` does, so its prediction grows slower than
    K lanes of the solo prediction."""
    from jepsen_tpu_torch.parallel import keyshard
    one = tsize.hbm_bytes(256, 1, 8, keys=1, arg_width=2,
                          engine="torch-wgl-batch")
    many = tsize.hbm_bytes(256, 1, 8, keys=64, arg_width=2,
                           engine="torch-wgl-batch")
    assert one["total"] < many["total"] < 64 * one["total"]
    B, W, O, T = keyshard.batch_sizes(64, tsize.plan_sizes(256, 1, 8))
    assert many["stack"] == (64 * O + 1) * ((B + 1) * 4 + 16)


def test_port_int32_wall_is_the_kernel_gate():
    """ROADMAP.md C, the int32 wall: the port's tensors index in int64;
    its one 32-bit index is the rollout kernel's ``int n``, and the gate
    caps n (the chain's bitset in shared memory) far below 2^31, while
    a staged launch holds its 8 bytes per op in shared memory, so the
    bulk copy's ``(uint32_t)(8 * n)`` cannot wrap. The planner keeps the
    reference's CP007/CP008 thresholds all the same."""
    from jepsen_tpu_torch.checker import rollout
    from jepsen_tpu_torch.models.registers import _cas_step
    n_max = rollout.SMEM_BUDGET // 4 * 32
    assert n_max < 2 ** 31 // 1000
    assert rollout.gate(_cas_step, 8, 1024, n_max, n_max // 32, 1, 2) \
        is not None
    assert rollout.gate(_cas_step, 8, 1024, n_max + 32, n_max // 32 + 1,
                        1, 2) is None
    for n in (64, 1024, 8192, 16384, n_max):
        p = rollout.plan(8, n, n // 32)
        if p.staged:
            assert 8 * n < rollout.SMEM_BUDGET < 2 ** 32
    # the reference's wall, not the port's, decides CP008
    plan, diags = tcap.build_plan(CP008_MATRIX)
    assert plan["int32"]["max_frac"] >= 1.0
    assert plan["compiles"]["keys"][0][1] > n_max


_BATCH_KEY = ("cas-register", 8, 64, 64, 2, 1, 4, 2, 4096, 1024, 1, 0,
              None, False)


def test_oracle_brackets_count_notes_not_key_sets():
    """ROADMAP.md C.11: the reference brackets a campaign with the set of
    keys noted so far, so a shape an earlier campaign of the same
    process noted is lost from the next one's "actual" (error 1.0); the
    port brackets the counts, and the shape counts again."""
    plan, _ = jcap.build_plan(REGISTER_MATRIX)
    jcc.note("jax-wgl-batch", _BATCH_KEY)
    before = jcc.noted_keys()
    jcc.note("jax-wgl-batch", _BATCH_KEY)
    ref = jcap.oracle(plan, jcc.noted_keys() - before)
    assert ref["missed"] == [["cas-register", 64]]
    assert ref["error_frac"] == 1.0
    tplan, _ = tcap.build_plan(REGISTER_MATRIX)
    tcc.note("torch-wgl-batch", _BATCH_KEY)
    counts = tcc.noted_counts()
    assert tcc.noted_since(counts) == set()
    tcc.note("torch-wgl-batch", _BATCH_KEY)
    port = tcap.oracle(tplan, tcc.noted_since(counts))
    assert port["actual"] == [["cas-register", 64]]
    assert port["error_frac"] == 0.0
    assert tcc.noted_keys() == {("torch-wgl-batch", _BATCH_KEY)}


def test_second_campaign_of_a_process_reads_its_shapes():
    """Two campaigns in one process whose cells note the same plan
    shape: both oracles read error 0.0."""
    from jepsen_tpu_torch import campaign
    from jepsen_tpu_torch.checker import core as tcore

    class Noting(tcore.Checker):
        def check(self, test, hist, opts=None):
            tcc.note("torch-wgl-batch", _BATCH_KEY)
            return {"valid": True}

    plan, _ = tcap.build_plan(REGISTER_MATRIX)
    for cid in ("first", "second"):
        cells = quick_cells(1)
        cells[0]["test"]["checker"] = Noting()
        rep = campaign.run_cells(cells, campaign_id=cid,
                                 capacity_plan=plan)
        oracle = rep["capacity"]["oracle"]
        assert oracle["actual"] == [["cas-register", 64]], (cid, oracle)
        assert oracle["error_frac"] == 0.0
