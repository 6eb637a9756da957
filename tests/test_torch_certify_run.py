"""The port's disk-path certifier (``analysis.certify.certify_run``,
VC012) against the JAX package's, on run directories written by the
port's ``store``.

``tests/test_certify.py``'s clean / tampered / unreadable run, plus a
device-engine run and a keyed (independent) run: the port's
``certify_run`` and the JAX package's, each on the same directory, give
the same summary and the same diagnostics. The port's ``core.check``
persists ``analysis.json`` (history lint, plan report, certificate
findings) beside the certificate, equal to the JAX run's."""

import json
import os

import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import store as jstore
from jepsen_tpu.analysis import certify as jcertify
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu.checker import core as jcc
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import independent, store
from jepsen_tpu_torch.analysis import certify
from jepsen_tpu_torch.checker import checkers as ck
from jepsen_tpu_torch.checker import core as ccore
from jepsen_tpu_torch.checker.checkers import Linearizable
from jepsen_tpu_torch.models import base as mbase

SPEC = mbase.model_spec("register")
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jstore"))


def _pairs(ops):
    """Sequential invoke/ok pairs: [(f, value), ...]."""
    ev, idx = [], 0
    for f, v in ops:
        ev.append({"index": idx, "type": "invoke", "process": 0,
                   "f": f, "value": None if f == "read" else v})
        idx += 1
        ev.append({"index": idx, "type": "ok", "process": 0,
                   "f": f, "value": v})
        idx += 1
    return ev


def invalid_sequential():
    return _pairs([("write", 1), ("write", 2), ("read", 1), ("read", 2)])


def _codes(diags):
    return sorted({d.code for d in diags})


def _persisted_run(checker, hist, name="certrun"):
    test = {"name": name, "start-time": store.local_time(),
            "history": h.ensure_indexed(hist), "checker": checker}
    r = ccore.check(checker, test, test["history"])
    test["results"] = r
    store.save_2(test)
    return test, store.path(test)


def _same(run_dir):
    """Both packages' certify_run on one directory: equal summaries and
    diagnostics. Returns the port's."""
    summary, diags = certify.certify_run(run_dir)
    jsummary, jdiags = jcertify.certify_run(run_dir)
    assert summary == jsummary
    assert [d.to_dict() for d in diags] == [d.to_dict() for d in jdiags]
    return summary, diags


def test_certify_run_clean_and_tampered():
    _, run_dir = _persisted_run(Linearizable(SPEC, algorithm="linear"),
                                invalid_sequential())
    summary, diags = _same(run_dir)
    assert summary["certified"] and diags == []

    p = os.path.join(run_dir, "certificate.json")
    cert = json.load(open(p))
    cert["verdict"] = True
    cert["witness"]["verdict"] = True
    json.dump(cert, open(p, "w"))
    _, diags = _same(run_dir)
    codes = _codes(diags)
    assert "VC012" in codes and "VC004" in codes

    # unreadable certificate: VC012, never a crash
    open(p, "w").write("{not json")
    _, diags = _same(run_dir)
    assert "VC012" in _codes(diags)

    # unreadable results: VC012 and no summary
    open(os.path.join(run_dir, "results.json"), "w").write("{")
    summary, diags = _same(run_dir)
    assert summary is None and _codes(diags) == ["VC012"]


def test_certify_run_device_engine_and_analysis_json():
    """A device-engine run certifies clean from disk, and its
    analysis.json (history lint, plan report, certificate findings)
    equals the JAX package's run of the same history."""
    lin = ck.linearizable({"model": "cas-register", "algorithm": "jax-wgl",
                           "engine_opts": CPU})
    hist = _pairs([("write", 1), ("read", 1), ("write", 2), ("read", 2)])
    test, run_dir = _persisted_run(lin, hist, "devrun")
    assert test["results"]["valid"] is True
    summary, diags = _same(run_dir)
    assert summary["certified"] and summary["engine"] == "jax-wgl"
    assert diags == []

    jlin = jck.linearizable({"model": "cas-register",
                             "algorithm": "jax-wgl"})
    jtest = {"name": "devrun", "start-time": jstore.local_time(),
             "history": jh.ensure_indexed(hist), "checker": jlin}
    jtest["results"] = jcc.check(jlin, jtest, jtest["history"])
    jstore.save_2(jtest)
    mine = json.load(open(os.path.join(run_dir, "analysis.json")))
    ref = json.load(open(os.path.join(jstore.path(jtest),
                                      "analysis.json")))
    for a in (mine, ref):
        a["searchplan"]["summary"].pop("built_s")
    assert mine == ref
    assert set(mine) == {"history", "searchplan", "certify"}


def test_certify_run_keyed():
    """A keyed run: the certificate proves one key's verdict; the disk
    path re-derives that key's subhistory from history.jsonl."""
    t = independent.tuple_
    hist = []
    for k, ops in ((0, [("write", 1), ("read", 1)]),
                   (1, [("write", 1), ("write", 2), ("read", 1),
                        ("read", 2)])):
        for o in _pairs(ops):
            hist.append({**o, "value": t(k, o["value"]),
                         "index": len(hist)})
    lin = ck.linearizable({"model": "register", "algorithm": "jax-wgl",
                           "engine_opts": CPU})
    test, run_dir = _persisted_run(independent.checker(lin), hist, "keyed")
    assert test["results"]["valid"] is False
    assert test["certificate"]["context"]["key"] == 1
    summary, diags = _same(run_dir)
    assert summary["certified"] and summary["verdict"] is False
    assert diags == []
