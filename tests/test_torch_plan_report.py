"""The port's plan report of record (``searchplan.build_plan``,
``checker.core.plan_history``), its partition predicates and JX007
(``analysis/shapelint.py``), against the JAX package's.

The cases of ``tests/test_searchplan.py`` (per-value parts, the plan
report persisted once per test, its opt-out, SP005, SP007, JX007), each
run through both packages on the same input: plan summaries (but for
``built_s``, a clock reading) and diagnostics are equal, and so is the
``test["analysis"]["searchplan"]`` that ``core.check`` writes for every
history of the reference's verdict-equivalence table."""

import pytest

from jepsen_tpu import independent as jind
from jepsen_tpu.analysis import jaxlint as jjl
from jepsen_tpu.analysis import searchplan as jsp
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu.checker import core as jcc
from jepsen_tpu_torch import independent, store
from jepsen_tpu_torch.analysis import searchplan, shapelint
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as cc
from jepsen_tpu_torch.checker import wgl
from jepsen_tpu_torch.models import base as mbase

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))


class _Ev:
    """Tiny indexed event-list builder."""

    def __init__(self):
        self.events = []

    def __call__(self, t, p, f, v):
        self.events.append({"type": t, "process": p, "f": f, "value": v,
                            "index": len(self.events)})


def quiescent_hist(bursts=3, stale_read=False, crashed_read=False,
                   crashed_write=False):
    """test_searchplan.py's write||write bursts sealed by isolated
    writes."""
    ev = _Ev()
    for j in range(bursts):
        x = j * 10
        ev("invoke", 0, "write", x)
        ev("invoke", 1, "write", x + 1)
        ev("ok", 0, "write", x)
        ev("ok", 1, "write", x + 1)
        if crashed_read:
            ev("invoke", 100 + j, "read", None)
            ev("info", 100 + j, "read", None)
        if crashed_write and j == 0:
            ev("invoke", 200, "write", 777)
            ev("info", 200, "write", 777)
        ev("invoke", 0, "write", x + 5)
        ev("ok", 0, "write", x + 5)
    ev("invoke", 2, "read", None)
    ev("ok", 2, "read", 0 if stale_read else (bursts - 1) * 10 + 5)
    return ev.events


def keyed_hist(nk=2, bad_key=None, crashed_read=False,
               t=independent.tuple_):
    """test_searchplan.py's independent [k v] register histories, with
    the tuples of the package ``t`` belongs to."""
    ev = _Ev()
    for k in range(nk):
        for j in range(3):
            x = j * 10
            ev("invoke", 2 * k, "write", t(k, x))
            ev("ok", 2 * k, "write", t(k, x))
            if crashed_read and j == 1:
                ev("invoke", 100 + k, "read", t(k, None))
                ev("info", 100 + k, "read", t(k, None))
            ev("invoke", 2 * k + 1, "read", t(k, None))
            ev("ok", 2 * k + 1, "read",
               t(k, 999 if (k == bad_key and j == 2) else x))
    return ev.events


def _set_hist(lost=False):
    ev = _Ev()
    for v in (1, 2, 3):
        ev("invoke", v, "add", v)
        ev("ok", v, "add", v)
    ev("invoke", 0, "read", None)
    ev("ok", 0, "read", [1, 3] if lost else [1, 2, 3])
    return ev.events


def _lin():
    return ck.linearizable({"model": "cas-register",
                            "algorithm": "jax-wgl", "engine_opts": CPU})


def _jlin():
    return jck.linearizable({"model": "cas-register",
                             "algorithm": "jax-wgl"})


def _report(x):
    """A plan report without its clock readings."""
    x = dict(x)
    x["summary"] = {k: v for k, v in x["summary"].items()
                    if k != "built_s"}
    return x


def _plan_fields(plan):
    return ({k: v for k, v in plan.summary().items() if k != "built_s"},
            [(d.code, d.severity, d.message, d.location, d.fix_hint)
             for d in plan.diagnostics])


# ---------------------------------------------------------------------------
# per-value parts


def _per_value_equal(events):
    parts = searchplan.per_value_parts(events)
    assert parts == jsp.per_value_parts([dict(o) for o in events])
    return parts


def test_per_value_parts_build_register_histories():
    parts = _per_value_equal(_set_hist())
    assert sorted(parts) == [1, 2, 3]
    reg = mbase.model_spec("register")
    for el, evs in parts.items():
        e, st = reg.encode(evs)
        assert wgl.check_encoded(reg, e, st)["valid"] is True


def test_per_value_read_before_add_stays_valid():
    ev = _Ev()
    ev("invoke", 0, "read", None)
    ev("ok", 0, "read", [])
    ev("invoke", 0, "add", 1)
    ev("ok", 0, "add", 1)
    ev("invoke", 0, "read", None)
    ev("ok", 0, "read", [1])
    ev("invoke", 0, "add", 2)
    ev("ok", 0, "add", 2)
    ev("invoke", 0, "read", None)
    ev("ok", 0, "read", [1, 2])
    parts = _per_value_equal(ev.events)
    reg = mbase.model_spec("register")
    for el, evs in parts.items():
        e, st = reg.encode(evs)
        assert wgl.check_encoded(reg, e, st)["valid"] is True, el


def test_per_value_detects_lost_add():
    parts = _per_value_equal(_set_hist(lost=True))
    reg = mbase.model_spec("register")
    verdicts = {}
    for el, evs in parts.items():
        e, st = reg.encode(evs)
        verdicts[el] = wgl.check_encoded(reg, e, st)["valid"]
    assert verdicts == {1: True, 2: False, 3: True}


def test_per_value_not_applicable_to_registers():
    assert _per_value_equal(quiescent_hist(2)) is None


def test_per_key_parts_equal_jax():
    mine = searchplan.per_key_parts(keyed_hist(3, crashed_read=True))
    ref = jsp.per_key_parts(keyed_hist(3, crashed_read=True,
                                       t=jind.tuple_))
    assert mine == ref and sorted(mine) == [0, 1, 2]
    assert searchplan.per_key_parts(quiescent_hist(2)) is None


# ---------------------------------------------------------------------------
# the plan report (checker.core.plan_history)


def test_plan_report_persists_in_analysis():
    chk = independent.checker(_lin())
    test = {"checker": chk, "searchplan-min-segment": 1}
    cc.check_safe(chk, test, keyed_hist(2))
    jchk = jind.checker(_jlin())
    jtest = {"checker": jchk, "searchplan-min-segment": 1}
    jcc.check_safe(jchk, jtest, keyed_hist(2, t=jind.tuple_))
    report = test["analysis"]["searchplan"]
    assert _report(report) == _report(jtest["analysis"]["searchplan"])
    assert report["summary"]["subsearches"] >= 2
    codes = [d["code"] for d in report["diagnostics"]]
    assert "SP001" in codes and "SP004" in codes


def test_plan_report_runs_once_per_test():
    chk = independent.checker(_lin())
    test = {"checker": chk, "searchplan-min-segment": 1}
    hist = keyed_hist(2)
    cc.plan_history(test, hist)
    marker = test["analysis"]["searchplan"]
    cc.plan_history(test, hist)
    assert test["analysis"]["searchplan"] is marker


def test_plan_opt_out():
    chk = independent.checker(_lin())
    test = {"checker": chk, "searchplan?": False}
    cc.check_safe(chk, test, keyed_hist(2))
    assert "searchplan" not in test.get("analysis", {})


def test_sp005_single_search_warns():
    plan = searchplan.build_plan({"searchplan-min-segment": 1},
                                 quiescent_hist(1)[:4], lin=_lin(),
                                 keyed=False)
    ref = jsp.build_plan({"searchplan-min-segment": 1},
                         quiescent_hist(1)[:4], lin=_jlin(), keyed=False)
    assert _plan_fields(plan) == _plan_fields(ref)
    assert len(plan.subsearches) == 1
    assert "SP005" in [d.code for d in plan.diagnostics]


def test_sp007_unknown_predicate():
    test = {"searchplan-partitions": ["per-key", "bogus"],
            "searchplan-min-segment": 1}
    plan = searchplan.build_plan(test, keyed_hist(2), lin=_lin(),
                                 keyed=True)
    ref = jsp.build_plan(test, keyed_hist(2, t=jind.tuple_), lin=_jlin(),
                         keyed=True)
    assert _plan_fields(plan) == _plan_fields(ref)
    assert "SP007" in [d.code for d in plan.diagnostics]
    assert len(plan.subsearches) >= 2


def test_per_value_plan_equals_jax():
    test = {"searchplan-partitions": ["per-value", "crash-segments"],
            "searchplan-min-segment": 1}
    lin = ck.linearizable({"model": "register", "algorithm": "jax-wgl"})
    jlin = jck.linearizable({"model": "register", "algorithm": "jax-wgl"})
    plan = searchplan.build_plan(test, _set_hist(), lin=lin, keyed=False)
    ref = jsp.build_plan(test, _set_hist(), lin=jlin, keyed=False)
    assert _plan_fields(plan) == _plan_fields(ref)
    assert {p["spec"] for p in plan.summary()["parts"]} == {"register"}


# ---------------------------------------------------------------------------
# JX007


def test_jx007_shape_proliferation():
    sizes = [8, 20, 40, 80, 300, 900, 2000]
    diags = shapelint.lint_searchplan_shapes(sizes)
    assert [d for d in diags if d.code == "JX007"]
    assert "set_n_floor" in diags[0].fix_hint
    assert [d.to_dict() for d in diags] == [
        d.to_dict() for d in jjl.lint_searchplan_shapes(sizes)]


def test_jx007_few_shapes_clean():
    assert not shapelint.lint_searchplan_shapes([8, 8, 9, 15, 16, 16])
    assert shapelint.MAX_PLAN_SHAPES == jjl.MAX_PLAN_SHAPES


# ---------------------------------------------------------------------------
# core.check writes the JAX package's report of record


HISTORIES = [
    ("valid-single", lambda t: quiescent_hist(3), False),
    ("invalid-single-stale", lambda t: quiescent_hist(3, stale_read=True),
     False),
    ("valid-single-crashes",
     lambda t: quiescent_hist(3, crashed_read=True), False),
    ("invalid-single-crashes",
     lambda t: quiescent_hist(3, stale_read=True, crashed_read=True,
                              crashed_write=True), False),
    ("valid-multikey", lambda t: keyed_hist(2, t=t), True),
    ("invalid-multikey", lambda t: keyed_hist(2, bad_key=1, t=t), True),
    ("valid-multikey-crashes",
     lambda t: keyed_hist(2, crashed_read=True, t=t), True),
]


@pytest.mark.parametrize("name,build,keyed", HISTORIES,
                         ids=[x[0] for x in HISTORIES])
@pytest.mark.parametrize("min_seg", [1, None])
def test_core_check_plan_report_equals_jax(name, build, keyed, min_seg):
    chk = independent.checker(_lin()) if keyed else _lin()
    jchk = jind.checker(_jlin()) if keyed else _jlin()
    base = {"certify?": False}
    if min_seg:
        base["searchplan-min-segment"] = min_seg
    test, jtest = dict(base, checker=chk), dict(base, checker=jchk)
    got = cc.check(chk, test, build(independent.tuple_))
    want = jcc.check(jchk, jtest, build(jind.tuple_))
    assert got["valid"] == want["valid"]
    for part in ("history", "searchplan"):
        mine, ref = test["analysis"][part], jtest["analysis"][part]
        if part == "searchplan":
            mine, ref = _report(mine), _report(ref)
        assert mine == ref, part
