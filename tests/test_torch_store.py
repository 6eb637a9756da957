"""The port's store (jepsen_tpu_torch/store.py) against the JAX package's
(jepsen_tpu/store.py) on the CPU: what either package writes --
``results.json``, ``history.txt``/``history.jsonl``, ``trace.jsonl``,
``metrics.json``, ``test.json`` and the crash journals -- the other
reads back equal, and the layout (paths, symlinks, browsing, reserved
directories, campaign folds) is the JAX package's. ``base_dir`` points
at a temporary directory in every case. Tolerance: equality."""

import json
import os

import numpy as np
import pytest

from jepsen_tpu import obs as jobs
from jepsen_tpu import store as jstore
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs, store

START = "20260730T000000.000000+0000"
PACKAGES = {"port": (store, obs), "jax": (jstore, jobs)}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    base = str(tmp_path / "store")
    monkeypatch.setattr(store, "base_dir", base)
    monkeypatch.setattr(jstore, "base_dir", base)
    return base


def _history():
    return [h.invoke_op(0, "write", 1, time=0, index=0),
            h.ok_op(0, "write", 1, time=5, index=1),
            h.invoke_op(1, "read", time=6, index=2),
            h.ok_op(1, "read", 1, time=9, index=3),
            h.info_op(2, "cas", [1, 2], time=10, index=4,
                      error="timeout")]


def _test(name="storey", **kw):
    t = {"name": name, "start-time": START, "history": _history(),
         "results": {"valid": True, "count": np.int64(3),
                     "keys": {2, 1}, "ok?": np.bool_(True)},
         "checker": object(), "nodes": ["n1", "n2"]}
    t.update(kw)
    return t


def _with_obs(test, mod):
    """A run's obs pair with a few events and series, parked on the test
    map as ``run_scope`` parks it."""
    with mod.run_scope(test):
        with mod.span("checker.Linearizable", cat="checker"):
            mod.instant("wgl.heartbeat.jax-wgl", cat="search", frontier=3)
        mod.inc("checker.checks", checker="Linearizable", valid="True")
        mod.observe("checker.check_s", 0.25, checker="Linearizable")
        mod.set_gauge("wgl.table_load", 0.125, engine="jax-wgl")
    return test


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_run_artifacts_round_trip_across_packages(writer, reader):
    wstore, wobs = PACKAGES[writer]
    rstore, robs = PACKAGES[reader]
    test = _with_obs(_test(), wobs)
    wstore.save_1(test)
    wstore.save_2(test)
    wstore.write_obs(test, final=True)
    loaded = rstore.load(test["name"], START)
    assert loaded["results"] == {"valid": True, "count": 3,
                                 "keys": [1, 2], "ok?": True}
    assert loaded["history"] == [dict(o) for o in _history()]
    assert "checker" not in loaded and "obs" not in loaded
    assert loaded["nodes"] == ["n1", "n2"]
    run = rstore.path(test)
    tr = test["obs"]["tracer"]
    assert rstore.load_run_trace(run) == robs.load_trace(
        os.path.join(run, "trace.jsonl"))
    assert [e["name"] for e in rstore.load_run_trace(run)] == \
        ["trace_meta"] + [e["name"] for e in tr.events()]
    assert rstore.load_run_metrics(run) == \
        test["obs"]["registry"].snapshot()
    with open(os.path.join(run, "history.txt")) as f:
        assert f.read().splitlines()[-1] == "2\tinfo\tcas\t[1, 2]\t'timeout'"
    # the final write retired the telemetry journals
    assert not os.path.exists(os.path.join(run, store.TRACE_JOURNAL_FILE))


def test_the_same_test_writes_the_same_bytes(tmp_path, monkeypatch):
    """results.json, history.txt, history.jsonl and test.json are byte for
    byte the JAX package's."""
    names = ("results.json", "history.txt", "history.jsonl", "test.json")
    got = {}
    for name, (mod, _o) in PACKAGES.items():
        base = str(tmp_path / name)
        monkeypatch.setattr(mod, "base_dir", base)
        mod.save_2(_test())
        got[name] = {f: open(mod.path(_test(), f), "rb").read()
                     for f in names}
    assert got["port"] == got["jax"]


def test_paths_and_make_path():
    t = {"name": "n", "start-time": START}
    assert store.path(t, ["independent", 3], None, "linear.png") == \
        jstore.path(t, ["independent", 3], None, "linear.png") == \
        os.path.join(store.base_dir, "n", START, "independent", "3",
                     "linear.png")
    p = store.make_path(t, "a", "b.txt")
    assert os.path.isdir(os.path.dirname(p))
    with pytest.raises(AssertionError):
        store.path({"start-time": START})
    with pytest.raises(AssertionError):
        store.path({"name": "n"})
    assert store.DEFAULT_NONSERIALIZABLE_KEYS == \
        jstore.DEFAULT_NONSERIALIZABLE_KEYS
    t2 = dict(t, **{"nonserializable-keys": ["secret"], "secret": 1})
    assert "secret" not in store.serializable_test(t2)


def test_history_journal_salvage_read_by_both(store_tmpdir):
    """A run killed before finalize leaves only the journal; a torn last
    line is dropped by either package's loader."""
    t = {"name": "j", "start-time": START}
    j = store.open_journal(t)
    for o in _history():
        j.append(o)
    j.close()
    j.append(_history()[0])                 # after close: a no-op
    with open(store.path(t, store.JOURNAL_FILE), "a") as f:
        f.write('{"type": "ok", "proc')
    want = [dict(o) for o in _history()]
    assert store.load_history(t) == jstore.load_history(t) == want
    t["history"] = _history()
    t["journal"] = j
    store.write_history(t)
    assert not os.path.exists(store.path(t, store.JOURNAL_FILE))
    assert jstore.load_history(t) == want


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_obs_journals_survive_a_crash(writer):
    """open_obs_journals mirrors the run's telemetry to journals; before
    the final write the other package reads the trace and the metrics
    back from them."""
    wstore, wobs = PACKAGES[writer]
    rstore = PACKAGES["jax" if writer == "port" else "port"][0]
    test = {"name": "crash", "start-time": START,
            "telemetry-flush-ms": 1}
    with wobs.run_scope(test):
        wstore.open_obs_journals(test)
        wobs.inc("wgl.chunks", engine="jax-wgl")
        wobs.instant("wgl.heartbeat.jax-wgl", cat="search")
        wobs.flush()
        wstore.write_obs(test)               # journaling: no dump yet
        run = rstore.path(test)
        assert not os.path.exists(os.path.join(run, "trace.jsonl"))
        assert [e["name"] for e in rstore.load_run_trace(run)] == \
            ["trace_meta", "wgl.heartbeat.jax-wgl"]
        assert rstore.load_run_metrics(run)["counters"] == \
            {"wgl.chunks{engine=jax-wgl}": 1}
        test["obs"]["tracer"].close_journal()
        test["obs"]["registry"].close_journal()


def test_telemetry_flush_interval():
    for ms, want in ((None, 0.5), (250, 0.25), (-1, 0.5), ("x", 0.5),
                     (True, 0.5)):
        t = {} if ms is None else {"telemetry-flush-ms": ms}
        assert store.telemetry_flush_s(t) == jstore.telemetry_flush_s(t) \
            == want


def test_write_obs_is_contained_and_skips_unbound_tests(caplog):
    store.write_obs({"name": "none", "start-time": START})    # no obs
    assert not os.path.exists(os.path.join(store.base_dir, "none"))
    test = _with_obs({"name": None, "start-time": START}, obs)
    store.write_obs(test, final=True)        # no name: logged, not raised
    assert "couldn't write obs artifacts" in caplog.text


def test_browsing_symlinks_and_delete():
    for name, t in (("a", "20260101T000000.000000+0000"),
                    ("a", "20260102T000000.000000+0000"),
                    ("b", "20260103T000000.000000+0000")):
        store.save_2({"name": name, "start-time": t, "history": [],
                      "results": {"valid": True}})
    os.makedirs(store.campaign_path("c1"), exist_ok=True)
    assert store.test_names() == jstore.test_names() == ["a", "b"]
    assert sorted(store.tests("a")) == sorted(jstore.tests("a"))
    assert store.tests()["a"]["20260101T000000.000000+0000"]()[
        "results"] == {"valid": True}
    assert store.latest()["name"] == jstore.latest()["name"] == "b"
    store.delete("a", "20260101T000000.000000+0000")
    assert list(store.tests("a")) == ["20260102T000000.000000+0000"]
    store.delete("b")
    assert store.test_names() == ["a"]
    store.delete()
    assert store.test_names() == []


def test_campaign_records_fold_like_the_jax_store():
    cid = "camp"
    os.makedirs(store.campaign_path(cid), exist_ok=True)
    with open(store.campaign_path(cid, "campaign.json"), "w") as f:
        json.dump({"id": cid}, f)
    recs = [{"cell": "x", "status": "aborted"},
            {"event": "lease", "cell": "x"},
            {"cell": "y", "status": "ok"},
            {"cell": "x", "status": "ok"}]
    with open(store.campaign_path(cid, "cells.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in recs) + '\n{"torn"\n')
    assert store.campaigns() == jstore.campaigns() == [cid]
    assert store.latest_campaign() == cid
    assert store.load_campaign(cid) == jstore.load_campaign(cid)
    assert store.latest_campaign_records(cid) == \
        jstore.latest_campaign_records(cid) == [recs[3], recs[2]]
    assert store.campaign_events(cid) == [recs[1]]
    assert store.load_campaign("nope") is None
    assert store.compile_ledger_path("l.jsonl") == \
        jstore.compile_ledger_path("l.jsonl")
    assert store.sync_tmp_path("x") == jstore.sync_tmp_path("x")


def test_memoized_results_and_per_test_logging():
    t = {"name": "logs", "start-time": START, "history": [],
         "results": {"valid": False}}
    store.save_2(t)
    assert store.memoized_load_results("logs", START) == {"valid": False}
    handler = store.start_logging(dict(t, **{"logging-json?": True}))
    import logging
    logging.getLogger("jepsen_tpu_torch.test").warning("hello %d", 7)
    store.stop_logging(handler)
    store.stop_logging(handler)               # idempotent
    with open(store.path(t, "jepsen.log")) as f:
        line = json.loads(f.read().splitlines()[-1])
    assert line["message"] == "hello 7" and line["level"] == "WARNING"
