"""The port's histlint (jepsen_tpu_torch/analysis/histlint.py) and the
history lint ``checker.core.check`` runs, against the JAX package's.

The cases of ``tests/test_analysis.py``'s histlint section, each run
through both packages on the same input: the diagnostics (code,
severity, message, location, fix hint) are equal, and the code lists
are the reference test's. ``core.check`` writes
``test["analysis"]["history"]`` equal to the JAX package's."""

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu.analysis import histlint as jhl
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu.checker import core as jcc
from jepsen_tpu.models import base as jmbase
from jepsen_tpu_torch import analysis
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.analysis import histlint
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as cc
from jepsen_tpu_torch.models import base as mbase

ROWS = [("invoke", 0, "write", 1),
        ("invoke", 1, "read", None),
        ("ok", 0, "write", 1),
        ("ok", 1, "read", 1),
        ("invoke", 0, "cas", [1, 2]),
        ("fail", 0, "cas", [1, 2]),
        ("invoke", 1, "read", None),
        ("info", 1, "read", None)]


def valid_history():
    return h.parse_history_edn_like(ROWS)


def _fields(diags):
    return [(d.code, d.severity, d.message, d.location, d.fix_hint)
            for d in diags]


def _both(make, **kw):
    """Lint ``make()``'s events in both packages; the diagnostics must be
    equal. Returns the port's."""
    mine = histlint.lint_history(make(), **kw)
    ref = jhl.lint_history([dict(o) if isinstance(o, dict) else o
                            for o in make()], **kw)
    assert _fields(mine) == _fields(ref)
    return mine


def codes(diags):
    return [d.code for d in diags]


def error_codes(diags):
    return [d.code for d in analysis.errors(diags)]


def _overlapping():
    hist = valid_history()
    hist.insert(5, h.op("invoke", 0, "read", None))
    return h.index(hist)


def _nonmonotonic():
    hist = valid_history()
    hist[3]["index"] = 1
    return hist


CASES = [
    ("clean", valid_history, {}, []),
    ("dangling", lambda: valid_history()[:-1], {}, ["HL001"]),
    ("overlapping", _overlapping, {}, None),
    ("bare-completion",
     lambda: h.index([h.op("ok", 3, "read", 7)]), {}, ["HL003"]),
    ("nemesis-info",
     lambda: h.index([h.op("info", "nemesis", "start", None)]), {}, []),
    ("mismatched-f",
     lambda: h.index([h.op("invoke", 0, "write", 1),
                      h.op("ok", 0, "read", 1)]), {}, ["HL003"]),
    ("unknown-type",
     lambda: h.index([h.op("explode", 0, "read", None)]), {}, ["HL004"]),
    ("nonmonotonic", _nonmonotonic, {}, None),
    ("unknown-f", valid_history, {"model_fs": {"read", "write"}},
     ["HL006"]),
    ("missing-fields",
     lambda: [{"type": "invoke"}, 42, {"type": "ok", "process": None}],
     {}, ["HL007", "HL007", "HL007"]),
]


@pytest.mark.parametrize("name,make,kw,want", CASES,
                         ids=[c[0] for c in CASES])
def test_histlint_equals_jax(name, make, kw, want):
    diags = _both(make, **kw)
    if name == "overlapping":
        assert "HL002" in error_codes(diags)
    elif name == "nonmonotonic":
        assert "HL005" in error_codes(diags)
    elif name == "dangling":
        assert codes(diags) == want and diags[0].severity == "warning"
    elif name == "unknown-f":
        assert error_codes(diags) == want and "cas" in diags[0].message
    elif want == []:
        assert diags == []
    else:
        assert error_codes(diags) == want


def test_histlint_encoded_tensors_equal_jax():
    spec = mbase.model_spec("cas-register")
    jspec = jmbase.model_spec("cas-register")

    def pair():
        return (spec.encode(valid_history())[0],
                jspec.encode(jh.parse_history_edn_like(ROWS))[0])

    e, je = pair()
    assert histlint.lint_encoded(e) == [] == jhl.lint_encoded(je)
    seen = []
    for corrupt in (
            lambda x: x.return_idx.__setitem__(0, x.invoke_idx[0] - 1),
            lambda x: x.return_idx.__setitem__(int(x.is_ok.argmax()),
                                               h.INF_TIME),
            lambda x: x.invoke_idx.__setitem__(
                slice(0, 2), x.invoke_idx[[1, 0]])):
        e, je = pair()
        corrupt(e)
        corrupt(je)
        mine = histlint.lint_encoded(e)
        assert _fields(mine) == _fields(jhl.lint_encoded(je))
        seen += codes(mine)
    assert {"HL010", "HL011", "HL012"} <= set(seen)


def test_model_op_set_walks_checkers():
    checker = cc.compose({"lin": ck.linearizable({"model": "cas-register"}),
                          "noop": cc.noop()})
    jchecker_ = jchecker.compose({
        "lin": jck.linearizable({"model": "cas-register"}),
        "noop": jchecker.noop()})
    fs = histlint.model_op_set({"checker": checker})
    assert fs == {"read", "write", "cas"} \
        == jhl.model_op_set({"checker": jchecker_})
    assert histlint.model_op_set({"checker": cc.noop()}) is None


def test_core_check_lints_once_like_jax():
    """``core.check`` lints the history once per test map, before the
    checker runs: ``analysis.history`` equals the JAX package's, an
    opted-out test gets none, a second check keeps the first report."""
    rows = ROWS[:-2]
    bad = rows + [("invoke", 1, "cas", [1, 2]), ("invoke", 1, "read", None)]
    for hist_rows in (rows, bad):
        test, jtest = {"certify?": False}, {"certify?": False}
        cc.check(cc.unbridled_optimism(), test,
                 h.parse_history_edn_like(hist_rows))
        jcc.check(jchecker.unbridled_optimism(), jtest,
                  jh.parse_history_edn_like(hist_rows))
        assert test["analysis"]["history"] == jtest["analysis"]["history"]
        report = test["analysis"]["history"]
        cc.check(cc.noop(), test, h.parse_history_edn_like(rows[:2]))
        assert test["analysis"]["history"] is report
    assert [d["code"] for d in report["diagnostics"]] == ["HL002", "HL001"]
    off = {"analysis?": False}
    cc.check(cc.noop(), off, h.parse_history_edn_like(rows))
    assert "analysis" not in off
