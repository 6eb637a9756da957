"""The port's command line (``jepsen_tpu_torch.cli``, ``__main__``,
``demo``) against the JAX package's.

The option helpers and the exit-code maps are held against the JAX
package's on the same inputs; the parsers have the JAX package's
``dest``s plus ``device``. Runs go through ``__main__.main(argv)`` in
process with ``--device cpu`` and a temporary store, as the JAX
package's ``tests/test_cli.py`` runs its CLI in a subprocess; one
subprocess proves ``hard_main`` at the real process boundary. A dirty-read
run's stored history is decided by the JAX package's own
``linearizable_register`` checker ("wgl", its CPU engine), which must
agree with the port's verdict, and ``analyze`` re-checks it to the same
verdict. Tolerance: equality."""

import argparse
import logging
import os
import re
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import __main__ as jmain
from jepsen_tpu import cli as jcli
from jepsen_tpu import independent as jindependent
from jepsen_tpu import store as jstore
from jepsen_tpu.tests import linearizable_register as jlr
from jepsen_tpu_torch import __main__ as tmain
from jepsen_tpu_torch import cli, store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU searches run small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "store"))


def _call(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return (type(exc).__name__, str(exc))


OPT_BASE = {"node": None, "nodes": None, "nodes-file": None,
            "username": "admin", "password": "pw", "no-ssh": True,
            "strict-host-key-checking": False, "ssh-private-key": None,
            "concurrency": "2n", "leave-db-running": True,
            "logging-json": False, "test-count": 1, "time-limit": 60}

HELPERS = {
    "parse_concurrency": [("parse_concurrency", v, n)
                          for v in ("10", "3n", "1n", "n3", "3x", "0n")
                          for n in (["a", "b"], ["a"] * 5)],
    "parse_nodes": [("parse_nodes", o) for o in (
        {}, {"node": ["a", "b"]}, {"nodes": "x, y,z"},
        {"nodes": "x", "node": ["a"]})],
    "test_opt_fn": [("test_opt_fn", dict(OPT_BASE, **kw)) for kw in (
        {}, {"monitor": True, "monitor-chunk": 8},
        {"monitor-chunk": 8}, {"profile": True, "profile-max-s": 3.0},
        {"no-searchplan": True, "searchplan-partitions": "per-key, x"},
        {"hard-time-limit": 4.0, "op-timeout-ms": 2000.0,
         "abort-grace": 1.0, "lint": True},
        {"concurrency": "bad"})],
    "_exit_for_valid": [("_exit_for_valid", v)
                        for v in (True, False, "unknown", None, 1, 0)],
    "test_all_exit_code": [("test_all_exit_code", r) for r in (
        {True: ["a"]}, {True: ["a"], False: ["b"]}, {"unknown": ["a"]},
        {"crashed": ["a"], False: ["b"]}, {"aborted": ["x"]},
        {"True": ["a"], "False": ["b"]}, {})],
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_match_jax(name, tmp_path):
    nodes_file = tmp_path / "nodes.txt"
    nodes_file.write_text("h1\nh2\n\n")
    cases = HELPERS[name] + ([("parse_nodes", {"nodes-file": str(nodes_file),
                                               "node": ["a"]})]
                             if name == "parse_nodes" else [])
    for fn, *args in cases:
        ours = _call(getattr(cli, fn), *args)
        theirs = _call(getattr(jcli, fn), *args)
        assert ours == theirs, (fn, args)
    assert cli.DEFAULT_NODES == jcli.DEFAULT_NODES


def _dests(mod, main_mod, which):
    parser = argparse.ArgumentParser()
    if which == "serve":
        mod.serve_cmd()["serve"]["opt-spec"](parser)
    else:
        mod.add_test_opts(parser)
        if which == "test":
            main_mod._add_demo_opts(parser)
        elif which == "test-all":
            mod.test_all_cmd({"tests-fn": None, "opt-spec":
                              main_mod._add_demo_opts})["test-all"][
                "opt-spec"](parser)
        else:
            mod.campaign_cmd({"test-fn": None, "opt-spec":
                              main_mod._add_demo_opts})["campaign"][
                "opt-spec"](parser)
    return {a.dest: (a.default, a.choices) for a in parser._actions
            if a.dest != "help"}


@pytest.mark.parametrize("which", ["test", "test-all", "campaign", "serve"])
def test_parsers_have_jax_dests_plus_device(which):
    ours = _dests(cli, tmain, which)
    theirs = _dests(jcli, jmain, which)
    assert ours.pop("device") == (None, ["cuda", "cpu"])
    assert ours == theirs


def _main(argv):
    with pytest.raises(SystemExit) as exc:
        tmain.main(argv)
    return exc.value.code


def test_noop_exits_0_with_the_store_layout(tmp_path):
    assert _main(["test", "--workload", "noop", "--no-ssh",
                  "--time-limit", "1", "--device", "cpu"]) == 0
    assert (tmp_path / "store" / "demo-noop").is_dir()
    assert (tmp_path / "store" / "latest").is_symlink()


DIRTY = ["--workload", "register", "--no-ssh", "--bug", "dirty-read",
         "--per-key-limit", "8", "--time-limit", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def dirty_run(tmp_path_factory):
    """One dirty-read run's store directory and exit code."""
    base = str(tmp_path_factory.mktemp("dirty") / "store")
    saved = store.base_dir
    store.base_dir = base
    try:
        code = _main(["test"] + DIRTY)
    finally:
        store.base_dir = saved
    return base, code


def test_dirty_read_exits_1_and_agrees_with_jax(dirty_run, monkeypatch):
    base, code = dirty_run
    assert code == 1
    monkeypatch.setattr(store, "base_dir", base)
    monkeypatch.setattr(jstore, "base_dir", base)
    d = os.path.join(base, "demo-register-dirty-read")
    runs = [p for p in os.listdir(d) if not os.path.islink(
        os.path.join(d, p))]
    assert len(runs) == 1
    assert {"history.txt", "history.jsonl", "results.json", "test.json",
            "jepsen.log"} <= set(os.listdir(os.path.join(d, runs[0])))
    ours = store.latest()
    assert ours["results"]["valid"] is False
    stored = jstore.latest()
    # the stored [k, v] pairs become the JAX package's keyed values again
    hist = [dict(o, value=jindependent.tuple_(*o["value"]))
            for o in stored["history"]]
    theirs = jlr.test({"nodes": stored["nodes"], "algorithm": "wgl"})[
        "checker"].check({}, hist, {})
    assert theirs["valid"] == ours["results"]["workload"]["valid"]


def test_analyze_rechecks_the_stored_history(dirty_run, monkeypatch):
    """``analyze`` re-checks the dirty-read run's stored history and
    exits 1 with the same verdict (the JAX package's analyze finds no
    key in the reloaded history and exits 0: ROADMAP.md, deliberate
    divergences)."""
    base, _ = dirty_run
    monkeypatch.setattr(store, "base_dir", base)
    before = store.latest()["results"]["workload"]["failures"]
    assert _main(["analyze"] + DIRTY) == 1
    assert store.latest()["results"]["workload"]["failures"] == before


def test_unknown_command_exits_254(capsys):
    assert _main(["frobnicate"]) == 254
    assert "jepsen_tpu_torch" in capsys.readouterr().out


@pytest.mark.parametrize("argv,code", [
    (["serve", "--host", "127.0.0.1", "--device", "cpu",
      "--capacity-plan", "capacity_plan.json"], 254),
    (["campaign", "--no-ssh", "--seeds", "1", "--capacity", "plan",
      "--workload", "noop", "--time-limit", "1", "--device", "cpu"], 0),
])
def test_unported_routes_exit_255(argv, code, capsys):
    """The capacity planner's routes exit as the reference's: ``serve
    --capacity-plan`` naming an unreadable plan is refused by PL021
    before anything listens (254), and ``campaign --capacity plan``
    runs, persists ``capacity_plan.json`` and reports its oracle."""
    from jepsen_tpu_torch.fleet import service
    assert _main(argv) == code
    out = capsys.readouterr().out
    assert "PL021" in out if argv[0] == "serve" else "PL021" not in out
    assert service.coalescer() is None
    if argv[0] == "campaign":
        cid = store.latest_campaign()
        assert os.path.isfile(store.campaign_path(cid,
                                                  "capacity_plan.json"))
        from jepsen_tpu_torch.campaign.journal import CampaignJournal
        rep = CampaignJournal(cid).load_report()
        assert rep["capacity"]["oracle"]["error_frac"] == 0.0
    else:
        assert store.campaigns() == []


@pytest.mark.parametrize("argv", [
    ["campaign", "--no-ssh", "--seeds", "2", "--workers", "local,local",
     "--workload", "noop", "--time-limit", "1"],
    ["test-all", "--no-ssh", "--parallel", "2", "--backends", "cpu",
     "--time-limit", "1", "--campaign-id", "ta"],
])
def test_ported_fleet_routes_exit_as_the_reference(argv, tmp_path,
                                                   monkeypatch, capsys):
    """The fleet's command-line routes run in both packages and exit
    alike: a two-worker fleet campaign, and test-all's scheduler route
    with a backend ladder. The port's cells carry ``device: "cpu"``
    (``_jsonable_options`` ships it to each worker process)."""
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    with pytest.raises(SystemExit) as exc:
        jmain.main(argv)
    theirs = exc.value.code
    capsys.readouterr()
    assert _main(argv + ["--device", "cpu"]) == theirs == 0
    out = capsys.readouterr().out
    cid = store.campaigns()[0]
    recs = store.latest_campaign_records(cid)
    assert recs and all(r["outcome"] is True for r in recs)
    jrecs = jstore.latest_campaign_records(jstore.campaigns()[0])
    assert sorted(r["cell"] for r in recs) == \
        sorted(r["cell"] for r in jrecs)
    assert sorted(r.get("backend") is not None for r in recs) == \
        sorted(r.get("backend") is not None for r in jrecs)
    if "--workers" in argv:
        assert {r["worker"] for r in recs} <= {"local", "local#2"}
        assert "# Campaign" in out


def test_register_without_device_exits_255_naming_cuda(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.CRITICAL):
        assert _main(["test", "--workload", "register", "--no-ssh",
                      "--time-limit", "1"]) == 255
    assert "CUDA" in caplog.text


@pytest.mark.parametrize("extra", [
    [], ["--monitor-chunk", "8"], ["--searchplan-partitions", "bogus"],
    ["--profile", "--profile-max-s", "0"], ["--monitor", "--lint"]])
def test_lint_matches_jax(extra, capsys):
    argv = ["test", "--workload", "register", "--no-ssh", "--lint"] + extra
    ours = _main(argv + ["--device", "cpu"])
    our_out = capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        jmain.main(argv)
    their_out = capsys.readouterr().out
    assert ours == exc.value.code
    assert sorted(re.findall(r"PL\d{3}", our_out)) \
        == sorted(re.findall(r"PL\d{3}", their_out))


def test_hard_main_at_the_process_boundary(tmp_path):
    # one intra-op thread, as the in-process tests run
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "test", "--workload",
         "noop", "--no-ssh", "--time-limit", "1", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "store" / "demo-noop").is_dir()
    assert (tmp_path / "store" / "latest").is_symlink()


def test_monitor_aborts_the_dirty_read_run_mid_run():
    """``--monitor --monitor-chunk 8`` on the dirty-read demo: the
    monitor's checks keep up with 50 busy workers (they run at the short
    switch interval) and abort the run long before its 15 s limit."""
    assert _main(["test"] + DIRTY[:-4] + [
        "--time-limit", "15", "--device", "cpu", "--monitor",
        "--monitor-chunk", "8"]) == 1
    r = store.latest()["results"]
    assert r["abort-reason"] == "monitor-violation" and r["salvaged"]
    assert r["valid"] is False and r["monitor"]["verdict"] is False
    assert r["monitor"]["time_to_first_verdict_s"] < 10
    assert isinstance(r["monitor"]["detected_at_index"], int)
