"""The port's planlint (the preflight path of
``jepsen_tpu_torch/analysis/planlint.py``) against the JAX package's.

Each case builds one test map twice, once from each package's own
classes (tests scaffold, client, nemesis, generator, checkers), and
``lint_plan`` must give equal (code, severity, location) triples
(tolerance: exact equality, order included). Messages are not compared:
they name each package's own classes."""

import pytest

from jepsen_tpu import client as jclient
from jepsen_tpu import generator as jgen
from jepsen_tpu import nemesis as jnemesis
from jepsen_tpu import tests as jtests
from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.checker import checkers as jcheckers
from jepsen_tpu.checker import core as jcore
from jepsen_tpu.tests import linearizable_register as jlr
from jepsen_tpu_torch import client
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch import tests
from jepsen_tpu_torch.analysis import planlint
from jepsen_tpu_torch.checker import checkers
from jepsen_tpu_torch.checker import core as ccore
from jepsen_tpu_torch.tests import linearizable_register as lr

PORT = {"client": client, "gen": gen, "nemesis": nemesis, "tests": tests,
        "checkers": checkers, "core": ccore, "lr": lr}
JAX = {"client": jclient, "gen": jgen, "nemesis": jnemesis,
       "tests": jtests, "checkers": jcheckers, "core": jcore, "lr": jlr}


def _base(p, **kw):
    t = p["tests"].noop_test()
    t.update({
        "ssh": {"dummy?": True},
        "checker": p["checkers"].linearizable(
            {"model": "cas-register", "algorithm": "jax-wgl"}),
        "generator": p["gen"].clients(p["gen"].limit(
            10, p["gen"].repeat({"f": "read"}))),
    })
    t.update(kw)
    return t


class _HalfNemesis:
    """Has invoke but no setup/teardown (PL002)."""

    def invoke(self, test, op):
        return dict(op, type="info")


class _NoInvokeNemesis:
    def setup(self, test):
        return self


def _register(p):
    w = p["lr"].test({"nodes": ["n1", "n2"]})
    return _base(p, nodes=["n1", "n2"], concurrency=4,
                 generator=w["generator"], checker=w["checker"])


#: name -> build(package namespace) -> test map
CASES = {
    "clean": lambda p: _base(p),
    "register_workload": _register,
    "no_client_invoke": lambda p: _base(p, client=object()),
    "client_partial": lambda p: _base(p, client=_HalfNemesis()),
    "nemesis_partial": lambda p: _base(p, nemesis=_HalfNemesis()),
    "nemesis_no_invoke": lambda p: _base(p, nemesis=_NoInvokeNemesis()),
    "checker_unusable": lambda p: _base(p, checker=object()),
    "generator_unusable": lambda p: _base(p, generator=3.5),
    "concurrency": lambda p: _base(p, concurrency=0),
    "concurrency_uneven": lambda p: _base(p, concurrency=7),
    "literal_op_outside_model": lambda p: _base(
        p, generator=[{"f": "write", "value": 1}, {"f": "bogus"}]),
    "nemesis_literal_op": lambda p: _base(
        p, nemesis=p["nemesis"].partition_halves(),
        generator=[{"type": "info", "f": "explode"}]),
    "time_limit": lambda p: _base(p, **{"time-limit": -1}),
    "robustness_knobs": lambda p: _base(
        p, **{"op-timeout-ms": 120000, "time-limit-s": 60,
              "abort-grace-s": 0}),
    "robustness_negative": lambda p: _base(p, **{"op-timeout-ms": -5}),
    "monitor_config": lambda p: _base(
        p, monitor={"chunk": 0, "engine": "bogus"},
        **{"op-timeout-ms": 500}),
    "monitor_stream_engine": lambda p: _base(
        p, monitor={"engine": "streamlin", "quiescent-carry?": False,
                    "engine-opts": {"frontier-cap": 1 << 20,
                                    "window-cap": 48}}),
    "monitor_txn": lambda p: _base(
        p, monitor={"family": "txn", "workload": "nope",
                    "anomalies": ["G1c-realtime", "G-bogus",
                                  "G0-process"],
                    "realtime": False, "skew-bound": -1}),
    "monitor_chunk_without_monitor": lambda p: _base(
        p, **{"monitor-chunk": 8}),
    "searchplan": lambda p: _base(
        p, checker=p["core"].unbridled_optimism(),
        **{"searchplan?": True, "searchplan-partitions": ["per-key",
                                                         "bogus"],
           "searchplan-min-segment": 0}),
    "certify_config": lambda p: _base(
        p, certify={"samples": 0, "budget": "lots"}),
    "certify_opted_out": lambda p: _base(
        p, certify={"samples": 2}, **{"certify?": False}),
    "certify_not_mapping": lambda p: _base(p, certify=[1]),
    "telemetry": lambda p: _base(p, **{"telemetry-flush-ms": 0}),
    "introspection": lambda p: _base(
        p, name=None, **{"profile?": True, "obs?": False,
                         "profile-max-s": -1,
                         "progress-interval-s": 0.01}),
    "trend_unreadable": lambda p: _base(
        p, **{"phases?": False, "profile?": True, "bubbles?": True,
              "trend-baseline": "/nonexistent/trend.jsonl",
              "trend-gate-threshold": 0}),
}


def _triples(diags):
    return [(d.code, d.severity, d.location) for d in diags]


@pytest.mark.parametrize("name", sorted(CASES))
def test_lint_plan_equals_jax(name):
    ours = _triples(planlint.lint_plan(CASES[name](PORT)))
    theirs = _triples(jplanlint.lint_plan(CASES[name](JAX)))
    assert ours == theirs
    if name not in ("clean", "register_workload"):
        assert ours, f"{name} should raise a finding"


def test_not_a_mapping_equals_jax():
    assert _triples(planlint.lint_plan([1])) == \
        _triples(jplanlint.lint_plan([1]))


def test_preflight_raises_on_fatal_codes():
    with pytest.raises(planlint.PlanLintError) as ei:
        planlint.preflight(CASES["no_client_invoke"](PORT))
    assert [d.code for d in ei.value.diagnostics] == ["PL001"]
    # non-fatal findings are returned, not raised
    diags = planlint.preflight(CASES["robustness_negative"](PORT))
    assert [d.code for d in diags] == ["PL011"]
    assert planlint.preflight(CASES["no_client_invoke"](PORT),
                              strict=False)


def test_core_preflight_records_the_report():
    t = core.preflight(core.prepare_test(CASES["robustness_knobs"](PORT)))
    codes = [d["code"] for d in t["analysis"]["plan"]["diagnostics"]]
    assert codes == ["PL011", "PL011"]
    with pytest.raises(planlint.PlanLintError):
        core.preflight(core.prepare_test(CASES["no_client_invoke"](PORT)))
    # opted out: nothing runs, nothing recorded
    t = core.preflight(core.prepare_test(
        dict(CASES["no_client_invoke"](PORT), **{"preflight?": False})))
    assert "analysis" not in t


def test_readable_trend_baseline_raises_not_implemented(tmp_path):
    """The trend gate's fingerprint check needed obs.trend, and this case
    held the raise until it was ported (ROADMAP.md A.11(d2)); now a
    readable baseline lints as the JAX package's does: its records'
    fingerprints are compared with this host's, and a record without
    one lints clean."""
    baseline = tmp_path / "trend.jsonl"
    baseline.write_text("{}\n")
    t = CASES["clean"](PORT)
    t["trend-baseline"] = str(baseline)
    assert [d for d in planlint.lint_plan(t) if d.code == "PL022"] == []
    baseline.write_text('{"t": 0, "fingerprint": {"hostname": "x"}, '
                        '"rungs": {}}\n')
    assert [(d.code, d.severity) for d in planlint.lint_plan(t)
            if d.code == "PL022"] == [("PL022", "warning")]
