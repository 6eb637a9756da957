"""The failure render (jepsen_tpu_torch/checker/linear_report.py) on the
CPU with matplotlib, against tests/test_reports.py:80-102: an invalid
verdict writes ``linear.png``, a valid one writes nothing, an analysis
without a witness op draws nothing, nor does a test map without a
store directory. Also where the file lands: the
checker's own ``opts`` name the subdirectory, so a per-key file lands
in the key's directory, which the JAX package's render does not do for
"jax-wgl" (ROADMAP.md C.5); and what the render's containment absorbs:
a plotting failure, never a search fault."""

import logging
import os

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import independent, store
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import linear_report, torch_wgl

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    base = str(tmp_path / "store")
    monkeypatch.setattr(store, "base_dir", base)
    monkeypatch.setattr(jstore, "base_dir", base)


def _test_map():
    return {"name": "clocky", "start-time": "20260730T000000.000000+0000",
            "nodes": ["n1.foo.com", "n2.foo.com"]}


def _invalid_register_history():
    """Write 1 completes, then a read sees 2: not linearizable."""
    ms = 1_000_000
    return [
        {"type": "invoke", "process": 0, "f": "write", "value": 1,
         "time": 0, "index": 0},
        {"type": "ok", "process": 0, "f": "write", "value": 1,
         "time": 1 * ms, "index": 1},
        {"type": "invoke", "process": 1, "f": "read", "value": None,
         "time": 2 * ms, "index": 2},
        {"type": "ok", "process": 1, "f": "read", "value": 2,
         "time": 3 * ms, "index": 3},
    ]


@pytest.mark.parametrize("algorithm", ["wgl", "linear", "jax-wgl"])
def test_linearizable_failure_renders_witness(algorithm):
    test = _test_map()
    checker = ck.linearizable({"model": "register", "algorithm": algorithm,
                               "engine_opts": dict(CPU)})
    res = checker.check(test, _invalid_register_history())
    assert res["valid"] is False
    p = store.path(test, "linear.png")
    assert os.path.exists(p)
    assert os.path.getsize(p) > 1000


def test_render_analysis_returns_none_without_witness():
    assert linear_report.render_analysis(
        _test_map(), _invalid_register_history(), {"valid": False}) is None
    assert linear_report.render_analysis(
        _test_map(), [], {"valid": False, "op": {"f": "read"}}) is None


def test_linearizable_valid_renders_nothing():
    test = _test_map()
    hist = _invalid_register_history()
    hist[3] = dict(hist[3], value=1)
    checker = ck.linearizable({"model": "register", "algorithm": "wgl"})
    res = checker.check(test, hist)
    assert res["valid"] is True
    assert not os.path.exists(store.path(test, "linear.png"))


def test_render_draws_the_same_window_as_the_jax_render(monkeypatch):
    """Both renders resolve the same path for the same analysis (the
    figure itself is matplotlib's)."""
    from jepsen_tpu.checker import linear_report as jreport
    test = _test_map()
    hist = [h.Op(o) for o in _invalid_register_history()]
    analysis = ck.linearizable({"model": "register", "algorithm": "wgl"}
                               ).check({}, hist)
    opts = {"subdirectory": ["independent", 5]}
    got = linear_report.render_analysis(test, hist, analysis, opts)
    want = jreport.render_analysis(test, [dict(o) for o in hist], analysis,
                                   opts)
    assert got == want == store.path(test, "independent", 5, "linear.png")


def test_per_key_render_lands_in_the_key_subdirectory():
    """C.5: with the checker's own opts, an invalid key's linear.png
    lands where ``independent``'s subdirectory names it. The JAX
    package's "jax-wgl" render shadows those opts with its engine opts
    and writes to the test root."""
    key = 3
    opts = {"subdirectory": [independent.DIR, key], "history-key": key}
    want = store.path(_test_map(), independent.DIR, key, "linear.png")
    test = _test_map()
    r = ck.linearizable({"model": "register", "algorithm": "jax-wgl",
                         "engine_opts": dict(CPU)}).check(
        test, _invalid_register_history(), opts)
    assert r["valid"] is False
    assert os.path.exists(want)
    assert not os.path.exists(store.path(test, "linear.png"))
    # the reference fault, for the record
    jtest = dict(_test_map(), name="jax")
    jck.linearizable({"model": "register", "algorithm": "jax-wgl"}).check(
        jtest, _invalid_register_history(), opts)
    assert os.path.exists(jstore.path(jtest, "linear.png"))
    assert not os.path.exists(jstore.path(jtest, independent.DIR, key,
                                          "linear.png"))


def test_independent_renders_each_invalid_key_in_its_directory():
    """Through ``independent.checker``, per key: the invalid key's file
    is in its own directory, the valid key has none."""
    good = _invalid_register_history()
    good[3] = dict(good[3], value=1)
    hist = []
    for k, sub in ((0, good), (1, _invalid_register_history())):
        for o in sub:
            o = dict(o, process=o["process"] + 10 * k, index=len(hist),
                     value=independent.tuple_(k, o["value"]))
            hist.append(o)
    test = _test_map()
    r = independent.checker(ck.linearizable(
        {"model": "register", "algorithm": "wgl"})).check(test, hist)
    assert r["failures"] == [1]
    assert os.path.exists(store.path(test, independent.DIR, 1,
                                     "linear.png"))
    assert not os.path.exists(store.path(test, independent.DIR, 0,
                                         "linear.png"))
    assert not os.path.exists(store.path(test, "linear.png"))


def test_missing_matplotlib_is_logged_and_the_verdict_stands(monkeypatch,
                                                            caplog):
    """The card's machine has no matplotlib: the render raises
    ModuleNotFoundError, which is logged, and the verdict is returned
    unchanged; no file is written."""
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ModuleNotFoundError("No module named 'matplotlib'",
                                      name="matplotlib")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    test = _test_map()
    with caplog.at_level(logging.WARNING):
        r = ck.linearizable({"model": "register", "algorithm": "jax-wgl",
                             "engine_opts": dict(CPU)}).check(
            test, _invalid_register_history())
    assert r["valid"] is False and r["valid?"] is False
    assert not os.path.exists(store.path(test, "linear.png"))
    recs = [x for x in caplog.records
            if x.getMessage() == "couldn't render linear.png"]
    assert len(recs) == 1
    assert isinstance(recs[0].exc_info[1], ModuleNotFoundError)


@pytest.mark.parametrize("test", [{}, {"name": "n"},
                                  {"start-time": "t"}, None])
def test_no_store_directory_renders_nothing(test, caplog):
    """A test map without a store directory has nowhere to render to:
    the verdict comes back and nothing is tried or logged."""
    with caplog.at_level(logging.WARNING):
        r = ck.linearizable({"model": "register", "algorithm": "wgl"}).check(
            test, _invalid_register_history())
    assert r["valid"] is False
    assert "couldn't render" not in caplog.text
    assert not os.path.exists(store.base_dir)


def test_a_search_fault_is_not_contained(monkeypatch):
    """The containment wraps the render only: a fault of the search
    raises out of the check."""
    def broken(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(torch_wgl, "check_encoded", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        ck.linearizable({"model": "register", "algorithm": "jax-wgl",
                         "engine_opts": dict(CPU)}).check(
            {"searchplan?": False}, _invalid_register_history())
