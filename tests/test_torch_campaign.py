"""The port's campaign runner (``jepsen_tpu_torch.campaign``, HA's
journal half, the ``campaign`` and ``test-all`` routes of ``cli``)
against the JAX package's.

Every case feeds the same inputs to both packages and compares at
tolerance zero. Masked fields, and why:

* ``wall_s`` (wall clock), ``writer`` (``host:pid``, equal within one
  process but not a property of the code) and the per-cell
  ``compile-cache`` delta of a journal record (its counts depend on
  which plan shapes each package's engines noted before the cell);
* ``path``: the run directory's start-time stamp differs run to run, so
  a path is compared as its test name (``<name>/<stamp>`` ->
  ``<name>``), and absolute store roots are never compared;
* report ``compile_cache`` blocks: compared only where the same
  searches ran (``test_compile_cache_*``); both carry their disk
  ledger's stats besides (``test_the_port_keeps_the_compile_ledger``).

The ported cases of ``tests/test_campaign.py`` and ``tests/test_phases.py``
(the parts that need no fleet, service or web) run against both
packages as parametrized cases."""

import json
import logging
import os
import random
import re
import threading
import time
import types

import pytest
import torch

from jepsen_tpu import checker as jchecker_pkg
from jepsen_tpu import cli as jcli
from jepsen_tpu import client as jclient
from jepsen_tpu import generator as jgen
from jepsen_tpu import store as jstore
from jepsen_tpu import tests as jtst
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu.campaign import journal as jjournal
from jepsen_tpu.campaign import plan as jplan
from jepsen_tpu.campaign import report as jreport
from jepsen_tpu.campaign import scheduler as jscheduler
from jepsen_tpu.checker import core as jchecker_core
from jepsen_tpu.fleet import ha as jha
from jepsen_tpu.robust import AbortLatch as JLatch
from jepsen_tpu_torch import checker as tchecker_pkg
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import tests as ttst
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.campaign import journal as tjournal
from jepsen_tpu_torch.campaign import plan as tplan
from jepsen_tpu_torch.campaign import report as treport
from jepsen_tpu_torch.campaign import scheduler as tscheduler
from jepsen_tpu_torch.checker import core as tchecker_core
from jepsen_tpu_torch.fleet import ha as tha
from jepsen_tpu_torch.robust import AbortLatch as TLatch

JAX = types.SimpleNamespace(
    name="jax", store=jstore, cli=jcli, plan=jplan, journal=jjournal,
    report=jreport, scheduler=jscheduler, cc=jcc, ha=jha,
    checker=jchecker_pkg, checker_core=jchecker_core, client=jclient,
    gen=jgen, tst=jtst, Latch=JLatch)
TORCH = types.SimpleNamespace(
    name="torch", store=tstore, cli=tcli, plan=tplan, journal=tjournal,
    report=treport, scheduler=tscheduler, cc=tcc, ha=tha,
    checker=tchecker_pkg, checker_core=tchecker_core, client=tclient,
    gen=tgen, tst=ttst, Latch=TLatch)
SIDES = (JAX, TORCH)

#: the port's engine labels for the JAX package's (the plan-shape
#: counter's label map; ROADMAP.md, deliberate divergences)
LABELS = {"jax-wgl": "torch-wgl", "jax-wgl-batch": "torch-wgl-batch",
          "jax-wgl-sharded": "torch-wgl-sharded",
          "streamlin": "torch-streamlin",
          "streamlin-batch": "torch-streamlin-batch"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    """Each package's store in a directory of its own (the campaign ids
    of a case are the same on both sides); compile caches reset."""
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "torch"))
    jcc.reset()
    tcc.reset()
    yield
    jcc.reset()
    tcc.reset()


def _diags(diags):
    return [dict(vars(d)) for d in diags]


def _mask_path(p):
    if not p:
        return p
    return os.path.basename(os.path.dirname(str(p)))


def _mask_record(rec):
    out = {k: v for k, v in rec.items()
           if k not in ("wall_s", "writer", "compile-cache")}
    if "path" in out:
        out["path"] = _mask_path(out["path"])
    if "error" in out:
        # a traceback names its package's files: keep its last line
        out["error"] = str(out["error"]).strip().splitlines()[-1]
    return out


def _mask_report(rep):
    rep = json.loads(json.dumps(rep, default=str))
    rep.pop("compile_cache", None)
    rep["cells"] = sorted((_mask_record(r) for r in rep["cells"]),
                          key=lambda r: str(r["cell"]))
    for fl in rep.get("flakes") or []:
        for c in fl["cells"]:
            c["path"] = _mask_path(c["path"])
    rep["results"] = {k: sorted(({"cell": e["cell"],
                                  "path": _mask_path(e["path"])}
                                 for e in v), key=lambda e: e["cell"])
                      for k, v in rep["results"].items()}
    fa = rep.get("fleet_analysis")
    if fa:
        fa["path"] = os.path.basename(fa["path"] or "")
    cert = rep.get("certification")
    if cert:
        for r in cert["runs"]:
            r["path"] = _mask_path(r["path"])
    return rep


# ---------------------------------------------------------------------------
# test cells, built alike in each package

def _ok_client(side):
    class OkClient(side.client.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            return dict(op, type="ok")

    return OkClient()


def dummy_test(side, **kw):
    t = side.tst.noop_test()
    t["ssh"] = {"dummy?": True}
    t["obs?"] = False
    t.update(kw)
    return t


def quick_cell(side, name, valid=True, ops=3):
    checker = side.checker.noop() if valid else side.checker_core.FnChecker(
        lambda t, h, o: {"valid": False}, "nope")
    return dummy_test(
        side, name=name, nodes=["n1"], concurrency=1,
        client=_ok_client(side), checker=checker,
        generator=side.gen.clients(side.gen.limit(
            ops, side.gen.repeat({"f": "read"}))))


def outcome_map(rep):
    return {r["cell"]: r["outcome"] for r in rep["cells"]}


# ---------------------------------------------------------------------------
# plan: expand, ids, groups, PL012

MATRICES = [
    {"base": {"time-limit": 5}, "axes": {"workload": ["a", "b"],
                                         "concurrency": [2, 4]}},
    {"axes": {"workload": ["a"], "seed": [0, 1]}},
    {"workload": ["a"], "seeds": 3, "time-limit": 9},
    {},
    {"axes": {}},
    {"axes": {"workload": []}},
    {"axes": {"workload": ["a b", "a_b"]}},
    {"axes": {"seed": [1, 1]}},
    {"base": {"op-timeout-ms": 99000},
     "axes": {"time-limit-s": [60, 120]}},
    {"axes": {"nemesis": ["none", "partition/halves"], "x": [1.5, "q"]},
     "seeds": 2},
    {"base": {"op-timeout-ms": 99000},
     "axes": {"time-limit-s": list(range(1, 12))}},
]


@pytest.mark.parametrize("matrix", MATRICES,
                         ids=[f"m{i}" for i in range(len(MATRICES))])
def test_plan_expand_ids_groups_and_pl012_equal(matrix):
    assert tplan.normalize(matrix) == jplan.normalize(matrix)
    cells = tplan.expand(matrix)
    assert cells == jplan.expand(matrix)
    names = sorted(tplan.normalize(matrix)["axes"])
    for c in cells:
        assert tplan.cell_id(c["params"], names) == \
            jplan.cell_id(c["params"], names) == c["id"]
        assert tplan.group_id(c["params"], names) == \
            jplan.group_id(c["params"], names) == c["group"]
    assert _diags(tplan.lint(matrix)) == _diags(jplan.lint(matrix))
    try:
        jplan.validate(matrix)
        want = None
    except jplan.CampaignPlanError as e:
        want = str(e)
    if want is None:
        assert tplan.validate(matrix)[0] == cells
    else:
        with pytest.raises(tplan.CampaignPlanError) as ei:
            tplan.validate(matrix)
        assert str(ei.value) == want


# ---------------------------------------------------------------------------
# journal and report

RECORDS = [
    {"cell": "seed=0,w=a", "group": "w=a", "outcome": True,
     "valid": True, "path": "s/a/1"},
    {"cell": "seed=1,w=a", "group": "w=a", "outcome": False,
     "valid": False, "path": "s/a/2"},
    {"cell": "seed=0,w=b", "group": "w=b", "outcome": True,
     "valid": True},
    {"cell": "seed=1,w=b", "group": "w=b", "outcome": True,
     "valid": True},
    {"cell": "seed=2,w=b", "group": "w=b", "outcome": "aborted",
     "valid": "unknown", "abort-reason": "SIGINT"},
    {"cell": "c1", "outcome": "crashed",
     "error": "Traceback ...\nRuntimeError: boom"},
    {"cell": "c2", "outcome": "crashed",
     "error": "Traceback ...\nRuntimeError: boom"},
    {"cell": "c3", "outcome": "unknown", "valid": "unknown"},
    {"cell": "seed=2,w=b", "group": "w=b", "outcome": True,
     "valid": True},
]


def test_journal_records_equal():
    """The same appends (a torn tail between them) give the same
    records, latest fold, completed set and meta in both packages; the
    writer stamp is ``writer_id()`` in both."""
    out = {}
    for side in SIDES:
        jr = side.journal.CampaignJournal("j")
        jr.write_meta({"status": "running", "cells": ["a", "b"]})
        for rec in RECORDS[:4]:
            jr.append_cell(rec)
        with open(jr.cells_path, "a") as f:
            f.write('{"cell": "torn", "outc')
        jr.append_event({"event": "lease", "cell": "a", "worker": "w"})
        jr.epoch = 3
        for rec in RECORDS[4:]:
            jr.append_cell(rec)
        jr.write_report({"x": 1})
        assert jr.writer == side.journal.writer_id()
        out[side.name] = (jr.records(), jr.events(), jr.latest(),
                          jr.completed(), jr.load_meta(),
                          jr.load_report())
    assert out["torch"] == out["jax"]
    # and each package reads the other's journal
    jr = tjournal.CampaignJournal("j")
    jr.dir = os.path.join(jstore.base_dir, "campaigns", "j")
    assert jr.load_meta() == out["jax"][4]


@pytest.mark.parametrize("kw", [
    {},
    {"meta": {"id": "c"}, "skipped": 2},
    {"aborted": True, "abort_reason": "SIGINT",
     "compile_cache": {"hits": 1, "misses": 2}},
])
def test_report_summarize_and_render_equal(kw):
    for recs in (RECORDS, RECORDS[:1], []):
        theirs = jreport.summarize(recs, **kw)
        ours = treport.summarize(recs, **kw)
        assert ours == theirs
        assert treport.render_text(ours) == jreport.render_text(theirs)
        assert treport.flakes(recs) == jreport.flakes(recs)
        assert treport.triage(recs) == jreport.triage(recs)
        assert treport.results_map(recs) == jreport.results_map(recs)


# ---------------------------------------------------------------------------
# the scheduler against the reference's

def _four_cells(side):
    return [{"id": "ok-1", "test": quick_cell(side, "ok-1")},
            {"id": "ok-2", "test": quick_cell(side, "ok-2")},
            {"id": "bad-1", "test": quick_cell(side, "bad-1", valid=False)},
            {"id": "bad-2", "test": quick_cell(side, "bad-2", valid=False)},
            {"id": "bogus", "build": lambda params: "not a test",
             "params": {}}]


@pytest.mark.parametrize("parallel", [1, 3])
def test_run_cells_equal_to_the_reference(parallel):
    reps = {}
    for side in SIDES:
        reps[side.name] = side.scheduler.run_cells(
            _four_cells(side), campaign_id="par", parallel=parallel)
    ours, theirs = reps["torch"], reps["jax"]
    assert outcome_map(ours) == outcome_map(theirs) == {
        "ok-1": True, "ok-2": True, "bad-1": False, "bad-2": False,
        "bogus": "crashed"}
    assert _mask_report(ours) == _mask_report(theirs)
    assert tcli.campaign_exit_code(ours) == \
        jcli.campaign_exit_code(theirs) == 255
    meta = {}
    for side in SIDES:
        with open(side.store.campaign_path("par", "campaign.json")) as f:
            m = json.load(f)
        meta[side.name] = {k: v for k, v in m.items()
                           if k not in ("created", "updated")}
        assert side.store.campaigns() == ["par"]
        assert "campaigns" not in side.store.test_names()
    assert meta["torch"] == meta["jax"]


def _aborting_cells(side, latch, counter):
    class AbortingClient(side.client.Client):
        def __init__(self, after):
            self.after = after
            self.n = 0

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            self.n += 1
            if self.n == self.after:
                latch.set("SIGINT")
            return dict(op, type="ok")

    cells = []
    for i in range(4):
        name = f"cell-{i}"

        def mk(params, name=name, i=i):
            counter.append(name)
            client = AbortingClient(3) if i == 1 else _ok_client(side)
            return dummy_test(
                side, name=name, nodes=["n1"], concurrency=1,
                client=client, checker=side.checker.noop(),
                generator=side.gen.clients(side.gen.limit(
                    6, side.gen.repeat({"f": "read"}))))

        cells.append({"id": name, "build": mk, "params": {}})
    return cells


def test_abort_then_resume_runs_only_unjournaled_cells_as_the_reference():
    got = {}
    for side in SIDES:
        latch = side.Latch()
        ran, ran2 = [], []
        rep = side.scheduler.run_cells(
            _aborting_cells(side, latch, ran), campaign_id="abrt",
            parallel=1, latch=latch)
        jr = side.journal.CampaignJournal("abrt")
        done = sorted(jr.completed())
        rep2 = side.scheduler.run_cells(
            _aborting_cells(side, side.Latch(), ran2), campaign_id="abrt",
            parallel=1, resume=True, latch=side.Latch())
        got[side.name] = (_mask_report(rep), ran, done, _mask_report(rep2),
                          sorted(ran2), side.cli.campaign_exit_code(rep),
                          side.cli.campaign_exit_code(rep2))
    assert got["torch"] == got["jax"]
    rep, ran, done, rep2, ran2, code, code2 = got["torch"]
    assert rep["status"] == "aborted" and ran == ["cell-0", "cell-1"]
    assert done == ["cell-0"] and code == 2
    assert ran2 == ["cell-1", "cell-2", "cell-3"]
    assert rep2["status"] == "complete" and code2 == 0
    assert rep2["summary"]["skipped-resumed"] == 1


def _error_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    "duplicate-ids", "no-such-campaign", "nothing-to-resume",
    "existing-without-resume", "unknown-cells-on-resume",
    "stale-aborted-cell", "corrupt-journal"])
def test_campaign_errors_equal(case):
    got = {}
    for side in SIDES:
        S = side.scheduler

        def cell(cid, side=side):
            return {"id": cid, "test": quick_cell(side, cid)}

        if case == "duplicate-ids":
            fn = lambda: S.run_cells([cell("a"), cell("a")],  # noqa: E731
                                     campaign_id="d")
        elif case == "no-such-campaign":
            fn = lambda: S.run_cells([], campaign_id="nope",  # noqa: E731
                                     resume=True)
        elif case == "nothing-to-resume":
            fn = lambda: S.run_cells([], resume=True)  # noqa: E731
        elif case in ("existing-without-resume",
                      "unknown-cells-on-resume"):
            S.run_cells([cell("a")], campaign_id="g1")
            if case == "existing-without-resume":
                fn = lambda: S.run_cells([cell("a")],  # noqa: E731
                                         campaign_id="g1")
            else:
                fn = lambda: S.run_cells([cell("b")],  # noqa: E731
                                         campaign_id="g1", resume=True)
        elif case == "stale-aborted-cell":
            jr = side.journal.CampaignJournal("stale")
            jr.write_meta({"status": "aborted", "cells": ["old", "keep"]})
            jr.append_cell({"cell": "old", "outcome": "aborted"})
            fn = lambda: S.run_cells([cell("keep")],  # noqa: E731
                                     campaign_id="stale", resume=True)
        else:
            jr = side.journal.CampaignJournal("corrupt")
            jr.write_meta({"status": "aborted", "cells": ["a"]})
            jr.append_cell({"cell": "a", "outcome": True})
            jr.append_cell({"cell": "a", "outcome": False})
            fn = lambda: S.run_cells(  # noqa: E731
                [{"id": "a", "test": {}}], campaign_id="corrupt",
                resume=True, run_fn=lambda t: t)
        got[side.name] = _error_of(fn)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "CampaignError"


def test_resume_without_an_id_picks_the_latest_like_the_reference():
    got = {}
    for side in SIDES:
        side.scheduler.run_cells(
            [{"id": "a", "test": quick_cell(side, "a")}], campaign_id="g1")
        rep = side.scheduler.run_cells(
            [{"id": "a", "test": quick_cell(side, "a")}], resume=True)
        got[side.name] = _mask_report(rep)
    assert got["torch"] == got["jax"]
    assert got["torch"]["campaign"] == "g1"
    assert got["torch"]["summary"]["skipped-resumed"] == 1


def test_hard_abort_finalizes_like_the_reference():
    got = {}
    for side in SIDES:
        def ki_run(test):
            if test["campaign"]["cell"] == "k-1":
                raise KeyboardInterrupt("hard abort")
            return {**test, "results": {"valid": True}}

        cells = [{"id": f"k-{i}", "test": quick_cell(side, f"k-{i}")}
                 for i in range(3)]
        with pytest.raises(KeyboardInterrupt):
            side.scheduler.run_cells(cells, campaign_id="hard",
                                     run_fn=ki_run)
        jr = side.journal.CampaignJournal("hard")
        rep = jr.load_report()
        got[side.name] = (jr.load_meta()["status"], _mask_report(rep),
                          [r["cell"] for r in jr.records()],
                          side.cli.campaign_exit_code(rep))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "aborted" and got["torch"][3] == 2


def test_own_deadline_abort_is_terminal_like_the_reference():
    got = {}
    for side in SIDES:
        class SlowClient(side.client.Client):
            def open(self, test, node):
                return self

            def invoke(self, test, op):
                time.sleep(0.05)
                return dict(op, type="ok")

        t = dummy_test(
            side, name="deadline", nodes=["n1"], concurrency=1,
            client=SlowClient(), checker=side.checker.noop(),
            **{"time-limit-s": 0.3, "abort-grace-s": 0.5},
            generator=side.gen.clients(side.gen.repeat({"f": "read"})))
        rep = side.scheduler.run_cells([{"id": "d", "test": t}],
                                       campaign_id="dl")
        got[side.name] = (_mask_report(rep),
                          sorted(side.journal.CampaignJournal(
                              "dl").completed()))
    assert got["torch"] == got["jax"]
    rec = got["torch"][0]["cells"][0]
    assert rec["outcome"] is True and rec["abort-reason"] == "time-limit"


def test_cell_test_map_carries_the_campaign_like_the_reference():
    got = {}
    for side in SIDES:
        t = quick_cell(side, "serial")
        rep = side.scheduler.run_cells([{"id": "c", "test": t}],
                                       campaign_id="ser")
        with open(os.path.join(rep["cells"][0]["path"], "test.json")) as f:
            saved = json.load(f)
        got[side.name] = saved["campaign"]
    assert got["torch"] == got["jax"] == {"id": "ser", "cell": "c",
                                          "params": {}}
    assert tscheduler._unique_start_time("dup") != \
        tscheduler._unique_start_time("dup")


# ---------------------------------------------------------------------------
# device slots

class _SlotProbe:
    """A stub checker that records when it enters and leaves."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active = 0
        self.peak = 0
        self.entered = 0

    def check(self, test, hist, opts):
        with self.lock:
            self.active += 1
            self.entered += 1
            self.peak = max(self.peak, self.active)
        time.sleep(0.05)
        with self.lock:
            self.active -= 1
        return {"valid": True}


@pytest.mark.parametrize("slots", [1, 2])
def test_device_slots_bound_concurrent_checks(slots):
    probe = _SlotProbe()
    cells = [{"id": f"c{i}", "test": quick_cell(TORCH, f"c{i}")}
             for i in range(4)]
    for c in cells:
        c["test"]["checker"] = tchecker_core.FnChecker(probe.check, "slow")
    rep = tscheduler.run_cells(cells, campaign_id="slots", parallel=4,
                               device_slots=slots)
    assert all(o is True for o in outcome_map(rep).values())
    assert probe.entered == 4 and 1 <= probe.peak <= slots
    with open(tstore.campaign_path("slots", "metrics.json")) as f:
        waits = json.load(f)["histograms"]["campaign.device_wait_s"]
    assert waits["count"] == 4


def test_monitored_cells_get_the_slots_and_checkers_keep_their_names():
    seen = {}

    def run_fn(test):
        seen[test["campaign"]["cell"]] = (
            test.get("monitor-device-sem"), test["checker"])
        return {**test, "results": {"valid": True}}

    mon = quick_cell(TORCH, "mon")
    mon["monitor"] = {"chunk": 8}
    tscheduler.run_cells([{"id": "mon", "test": mon},
                          {"id": "plain", "test": quick_cell(TORCH, "p")}],
                         campaign_id="sem", run_fn=run_fn, device_slots=1)
    sem, chk = seen["mon"]
    assert seen["plain"][0] is None
    assert chk.name == jscheduler._DeviceSlotChecker(
        jchecker_pkg.noop(), threading.Semaphore(), None).name
    assert chk.sem is sem
    # one slot: a second holder waits
    assert sem.acquire(blocking=False)
    assert not sem.acquire(blocking=False)
    sem.release()


class _RecordingSlot:
    """A one-slot semaphore that counts its holders."""

    def __init__(self):
        self.sem = threading.BoundedSemaphore(1)
        self.acquired = 0

    def acquire(self, blocking=True, timeout=None):
        got = self.sem.acquire(blocking, timeout if blocking else None)
        self.acquired += bool(got)
        return got

    def release(self):
        self.sem.release()


@pytest.mark.parametrize("chunk", [4, 16])
def test_txn_monitor_checks_hold_the_device_slot(chunk):
    """The port's txn monitor holds the campaign's device slot around
    each chunk check (the reference's takes none: ROADMAP.md, deliberate
    divergences) and answers as the reference's does."""
    from jepsen_tpu.monitor import txn as jtxn
    from jepsen_tpu.robust import ChainedLatch as JChained
    from jepsen_tpu_torch import simulate
    from jepsen_tpu_torch.monitor import txn as ttxn
    from jepsen_tpu_torch.robust import ChainedLatch as TChained
    hist = simulate.txn_wr_history(random.Random(2), 90, 8)
    slot = _RecordingSlot()
    mon = ttxn.TxnMonitor(TChained(), chunk=chunk, workload="wr",
                          device="cpu", device_sem=slot)
    jmon = jtxn.TxnMonitor(JChained(), chunk=chunk, workload="wr")
    for m in (mon, jmon):
        done = 0
        for op in hist:
            m.offer(op)
            if op.get("type") != "invoke":
                done += 1
                if done % chunk == 0:
                    m._step()
        m._step()
    time_fields = ("time_to_first_verdict_s",)
    got, want = ({k: v for k, v in m.summary().items()
                  if k not in time_fields} for m in (mon, jmon))
    assert got == want and got["verdict"] is True
    assert slot.acquired == mon.checks > 0
    assert slot.acquire(blocking=False)     # every hold was released
    slot.release()


def test_install_txn_hands_the_campaign_slot_to_the_monitor():
    from jepsen_tpu_torch.monitor import txn as ttxn
    slot = _RecordingSlot()
    test = {"monitor-device-sem": slot}
    mon = ttxn.install_txn(test, {"chunk": 2, "workload": "append",
                                  "engine-opts": {"device": "cpu"}})
    mon.stop()
    assert mon.device_sem is slot


# ---------------------------------------------------------------------------
# later sub-slices raise before anything runs

@pytest.mark.parametrize("kw,item", [
    ({"capacity_plan": {"cells": []}}, r"A\.11\(d5\)"),
])
def test_later_slice_branches_raise_before_any_state(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tscheduler.run_cells([{"id": "a", "test": quick_cell(TORCH, "a")}],
                             campaign_id="later", **kw)
    assert not os.path.exists(tstore.campaign_path("later"))
    assert tstore.campaigns() == []


@pytest.mark.parametrize("backends", [["gpu", "cpu"], "cpu"])
def test_backends_degrade_cells_as_the_reference(backends, monkeypatch):
    """``run_cells(backends=...)`` with the gpu probe stubbed down: both
    packages journal the cpu tier on every cell and count it."""
    from jepsen_tpu.fleet import backends as jb
    from jepsen_tpu_torch.fleet import backends as tb
    for mod in (jb, tb):
        monkeypatch.setattr(mod, "as_failover",
                            lambda x, mod=mod: mod.Failover(
                                ladder=[x] if isinstance(x, str)
                                else list(x),
                                probe_fn=lambda t, timeout_s=None:
                                None if t == "cpu" else "down"))
    out = {}
    for side in SIDES:
        rep = side.scheduler.run_cells(
            [{"id": c, "test": quick_cell(side, c)} for c in ("a", "b")],
            campaign_id="bk", backends=backends)
        with open(side.store.campaign_path("bk", "metrics.json")) as f:
            counters = json.load(f)["counters"]
        out[side.name] = (
            sorted((r["cell"], r["backend"]) for r in
                   side.store.latest_campaign_records("bk")),
            _mask_report(rep)["summary"],
            {k: v for k, v in counters.items()
             if k.startswith("fleet.backend_cells")})
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [("a", "cpu"), ("b", "cpu")]


def test_resuming_an_ha_journal_raises_naming_the_fleet():
    """Both packages refuse with a CampaignError that sends the user to
    the fleet path, before any cell runs."""
    for side in SIDES:
        jr = side.journal.CampaignJournal("hares")
        jr.write_meta({"status": "running", "mode": "fleet",
                       "cells": ["a"]})
        jr.append_event({"event": side.ha.LEASE_EVENT, "epoch": 1,
                         "lease-s": 5.0, "t": side.store.local_time()})
    ran = []
    with pytest.raises(jscheduler.CampaignError, match="coordinator-HA"):
        jscheduler.run_cells([{"id": "a", "test": quick_cell(JAX, "a")}],
                             campaign_id="hares", resume=True,
                             run_fn=ran.append)
    with pytest.raises(tscheduler.CampaignError,
                       match="coordinator-HA.*fleet mode") as ei:
        tscheduler.run_cells([{"id": "a", "test": quick_cell(TORCH, "a")}],
                             campaign_id="hares", resume=True,
                             run_fn=ran.append)
    assert not isinstance(ei.value, NotImplementedError)
    assert ran == []


def test_a_finalize_not_implemented_error_is_not_contained(monkeypatch):
    from jepsen_tpu_torch.analysis import fleetlint

    def unported(*a, **kw):
        raise NotImplementedError("ROADMAP.md A.11(d5)")

    monkeypatch.setattr(fleetlint, "audit", unported)
    with pytest.raises(NotImplementedError):
        tscheduler.run_cells([{"id": "a", "test": quick_cell(TORCH, "a")}],
                             campaign_id="ni")
    # the report was written before the audit ran
    assert tjournal.CampaignJournal("ni").load_report()["status"] == \
        "complete"


# ---------------------------------------------------------------------------
# HA's journal half

HA_RECORDS = [
    {"event": "coordinator-lease", "epoch": 1, "writer": "a:1"},
    {"event": "coordinator-lease", "epoch": 1, "writer": "a:1"},
    {"event": "coordinator-takeover", "epoch": 2, "prev-epoch": 1,
     "writer": "b:2"},
    {"event": "coordinator-takeover", "epoch": 3, "prev-epoch": 1,
     "writer": "c:3"},
    {"event": "coordinator-lease", "epoch": 1, "writer": "a:1"},
    {"cell": "a", "outcome": True},
    {"event": "coordinator-lease", "epoch": True, "writer": "x:1"},
]


def test_ha_journal_half_equal():
    for n in range(len(HA_RECORDS) + 1):
        recs = HA_RECORDS[:n]
        assert tha.coordinator_state(recs) == jha.coordinator_state(recs)
        assert tha.current_epoch(recs) == jha.current_epoch(recs)
        assert tha.last_lease(recs) == jha.last_lease(recs)
    assert tha.coordinator_state(None) == (0, None)
    for name in ("LEASE_EVENT", "TAKEOVER_EVENT",
                 "DEFAULT_COORDINATOR_LEASE_S", "DEFAULT_TAKEOVER_GRACE_S",
                 "RENEW_FRACTION"):
        assert getattr(tha, name) == getattr(jha, name)
    # the fence: the same takeover record, and the compare-and-swap guard
    out = {}
    for side in SIDES:
        jr = side.journal.CampaignJournal("fence")
        jr.write_meta({"status": "running", "cells": ["a"]})
        jr.append_event({"event": "coordinator-lease", "epoch": 1,
                         "lease-s": 5.0, "t": "20260101T000000.000000+0000",
                         "writer": "coord:1"})
        won = side.ha.fence(jr, reason="manual", forced=True,
                            skew_allowance_s=0.25)
        lost = side.ha.fence(jr, expect_epoch=1)
        rec = [r for r in jr.records()
               if r.get("event") == side.ha.TAKEOVER_EVENT]
        out[side.name] = (won, lost, [{k: v for k, v in r.items()
                                       if k not in ("t", "fence-id")}
                                      for r in rec])
        assert os.path.basename(side.ha.takeover_marker("fence")) == \
            "chaos-coordinator-kill"
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (2, None)


@pytest.mark.parametrize("cls", ["CoordinatorLease", "Standby"])
def test_ha_lease_and_standby_take_the_references_arguments(cls):
    import inspect
    ours, theirs = getattr(tha, cls), getattr(jha, cls)
    assert str(inspect.signature(ours)) == str(inspect.signature(theirs))
    assert sorted(n for n in vars(ours) if not n.startswith("__")) == \
        sorted(n for n in vars(theirs) if not n.startswith("__"))


@pytest.mark.parametrize("name,item", [("service", "d4")])
def test_unported_fleet_modules_raise_naming_their_sub_slice(name, item):
    import jepsen_tpu_torch.fleet as tfleet
    with pytest.raises(NotImplementedError,
                       match=rf"A\.11\({item}\)"):
        getattr(tfleet, name)


@pytest.mark.parametrize("name", [
    "dispatch", "worker", "sync", "chaos", "backends", "ledger", "ha",
    "run_fleet", "FleetError", "parse_workers"])
def test_ported_fleet_names_resolve_as_the_reference(name):
    import jepsen_tpu.fleet as jfleet
    import jepsen_tpu_torch.fleet as tfleet
    ours, theirs = getattr(tfleet, name), getattr(jfleet, name)
    if name in ("run_fleet", "parse_workers"):
        import inspect
        assert list(inspect.signature(ours).parameters) == \
            list(inspect.signature(theirs).parameters)
    elif name == "FleetError":
        assert issubclass(ours, tscheduler.CampaignError)
    else:
        assert ours.__name__ == f"jepsen_tpu_torch.fleet.{name}"
        # every public name but the JAX-only ones
        jax_only = {"enable_jax_cache", "JAX_CACHE_DIR", "tier_env"}
        assert set(theirs.__all__) - jax_only <= set(ours.__all__)


# ---------------------------------------------------------------------------
# plan-shape counter, floor

NOTES = [("e", ("spec", 64, 2, 4)), ("e", ("spec", 64, 2, 4)),
         ("e", ("spec", 128, 2, 4)), ("f", ("spec", 64, 2, 4)),
         ("e", ("spec", 128, 2, 4)), ("f", ("s", (1, 2), 3))]


@pytest.mark.parametrize("notes", [NOTES, NOTES[::-1]],
                         ids=["forward", "reversed"])
def test_compile_cache_notes_equal(notes):
    out = {}
    for side in SIDES:
        side.cc.reset()
        hits = [side.cc.note(e, k) for e, k in notes]
        out[side.name] = (hits, side.cc.stats(),
                          side.cc.delta({"hits": 1, "misses": 0}))
        side.cc.reset()
    assert out["torch"] == out["jax"]
    assert out["torch"][0].count(True) == 2


def test_the_port_keeps_the_compile_ledger():
    """Both campaigns persist their compile ledger by default: the same
    ledger file layout, the same stats event and report block (the port
    notes plan-shape sightings; it compiles nothing per shape), and no
    ``jax_cache`` beside the port's (ROADMAP.md, deliberate
    divergences)."""
    out = {}
    for side in SIDES:
        rep = side.scheduler.run_cells(
            [{"id": "a", "test": quick_cell(side, "a")}],
            campaign_id="led")
        led = rep["compile_cache"]["ledger"]
        with open(led["path"]) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        out[side.name] = ({k: v for k, v in led.items()
                           if k not in ("path", "warm_wall_s")},
                          [sorted(ln) for ln in lines],
                          [ln["stats"]["hits"] for ln in lines],
                          side.report.render_text(
                              side.journal.CampaignJournal("led")
                              .load_report()))
    assert out["torch"] == out["jax"]
    assert os.path.isdir(jstore.compile_ledger_path("jax_cache"))
    assert os.listdir(tstore.compile_ledger_path()) == ["ledger.jsonl"]


@pytest.mark.parametrize("counts", [
    [70, 300, 900, 1100, 2500, 5000],
    [1, 63, 64, 65],
    [900, 1100, 4097, 9000, 17000, 40000, 70000],
])
def test_n_floor_pads_as_the_reference_at_its_default(counts):
    """The port's floor is the reference's default, fixed (ROADMAP.md,
    deliberate divergences): the single search's buckets and JX007's
    shape count equal the reference's."""
    from jepsen_tpu.analysis import jaxlint
    from jepsen_tpu.checker import jax_wgl
    from jepsen_tpu_torch.analysis import shapelint
    from jepsen_tpu_torch.checker import torch_wgl
    assert torch_wgl._n_floor() == jax_wgl._n_floor() == 64
    for n in counts:
        assert torch_wgl._bucket(n, torch_wgl._n_floor()) == \
            jax_wgl._bucket(n, jax_wgl._n_floor()) == jcc.bucket_for(n)
    assert _diags(shapelint.lint_searchplan_shapes(counts)) == \
        _diags(jaxlint.lint_searchplan_shapes(counts))


def _register_pairs(spec, seeds, n_ops):
    from jepsen_tpu import simulate as jsim
    return [spec.encode(jsim.random_history(random.Random(s),
                                            "cas-register", n_procs=3,
                                            n_ops=n_ops, crash_p=0.0))
            for s in seeds]


def _spy(monkeypatch, cc):
    """Record every (engine, key) a package's engines note."""
    seen = []
    note = cc.note

    def spy(engine, key):
        seen.append((engine, tuple(key)))
        return note(engine, key)

    monkeypatch.setattr(cc, "note", spy)
    return seen


def test_compile_cache_counts_equal_for_the_same_searches(monkeypatch):
    """The same sequence of single-key searches (two of one shape, one of
    another) notes the same keys under the label map and counts the same
    hits and misses; the key batch notes the reference's batch key."""
    from jepsen_tpu.checker import jax_wgl
    from jepsen_tpu.models import cas_register_spec as jspec
    from jepsen_tpu.parallel import keyshard as jkeyshard
    from jepsen_tpu_torch.checker import torch_wgl
    from jepsen_tpu_torch.models import cas_register_spec as tspec
    from jepsen_tpu_torch.parallel import keyshard as tkeyshard
    jseen, tseen = _spy(monkeypatch, jcc), _spy(monkeypatch, tcc)
    seq = [(0, 20), (1, 20), (2, 40)]
    jpairs = [_register_pairs(jspec, [s], n)[0] for s, n in seq]
    for (e, st) in jpairs:
        r = jax_wgl.check_encoded(jspec, e, st)
        assert r["valid"] is True
    from jepsen_tpu import simulate as jsim
    tpairs = [tspec.encode(jsim.random_history(
        random.Random(s), "cas-register", n_procs=3, n_ops=n,
        crash_p=0.0)) for s, n in seq]
    for (e, st) in tpairs:
        r = torch_wgl.check_encoded(tspec, e, st, device="cpu")
        assert r["valid"] is True
    assert tseen == [(LABELS[e], k) for e, k in jseen]
    js, ts = jcc.stats(), tcc.stats()
    assert (ts["hits"], ts["misses"], ts["shapes"]) == \
        (js["hits"], js["misses"], js["shapes"])
    assert ts["by_engine"] == {LABELS[e]: v
                               for e, v in js["by_engine"].items()}
    # the key batch: the same batch key, n_pad the default floor's
    del jseen[:], tseen[:]
    jkeyshard.check_batch_encoded(jspec, jpairs[:2], max_configs=64,
                                  chunk_iters=1)
    tkeyshard.check_batch_encoded(tspec, tpairs[:2], max_configs=64,
                                  chunk_iters=1, device="cpu")
    (jkey,), (tkey,) = jseen, tseen
    assert tkey == (LABELS[jkey[0]], jkey[1])
    assert tkey[1][3] == 64             # n_pad


def test_stream_check_pads_as_the_reference():
    """``StreamCheck``'s starting frontier and its growth equal the JAX
    StreamCheck's: F, frontier_grows and the verdicts (a history whose
    frontier outgrows 64 rows, checked every 8 completions)."""
    from jepsen_tpu.models import base as jbase
    from jepsen_tpu.monitor.wgl_stream import StreamCheck as JStream
    from jepsen_tpu_torch.models import base as tbase
    from jepsen_tpu_torch.monitor.wgl_stream import StreamCheck as TStream
    from test_monitor import _history
    sc = TStream(tbase.model_spec("cas-register"), device="cpu")
    jsc = JStream(jbase.model_spec("cas-register"),
                  opts={"coalesce?": False})
    n = 0
    for i, op in enumerate(_history(falsify_at=None)):
        done = sc.offer(op, i)
        assert jsc.offer(op, i) == done
        n += bool(done)
        if done and n % 8 == 0:
            assert sc.check()["valid"] == jsc.check()["valid"]
            assert (sc.F, sc.frontier_grows) == \
                (jsc.F, jsc.frontier_grows)
    assert sc.check()["valid"] == jsc.check()["valid"]
    assert (sc.F, sc.frontier_grows) == (jsc.F, jsc.frontier_grows)
    assert sc.F >= 64


# ---------------------------------------------------------------------------
# the command line

def _main(side, argv):
    if side is JAX:
        from jepsen_tpu import __main__ as m
    else:
        from jepsen_tpu_torch import __main__ as m
    with pytest.raises(SystemExit) as ei:
        m.main(argv)
    return ei.value.code


@pytest.mark.parametrize("argv,code", [
    (["campaign", "--no-ssh", "--seeds", "2", "--lint"], 0),
    (["campaign", "--no-ssh", "--lint"], 1),
    (["campaign", "--no-ssh", "--axis", "workload=a b,a_b", "--lint"], 1),
    (["campaign", "--no-ssh", "--axis", "time-limit-s=60,120",
      "--op-timeout-ms", "99000", "--seeds", "2", "--lint"], 0),
    (["campaign", "--no-ssh", "--seeds", "2", "--fleetlint", "strict",
      "--lint"], 1),
    (["campaign", "--no-ssh", "--seeds", "1", "--coalesce-window-ms",
      "-1", "--lint"], 1),
    (["campaign", "--no-ssh", "--seeds", "1", "--takeover-grace-s", "0",
      "--lint"], 1),
    (["campaign", "--no-ssh", "--seeds", "1", "--telemetry-flush-ms",
      "0", "--lint"], 1),
])
def test_campaign_lint_output_and_exit_equal(argv, code, capsys):
    outs = {}
    for side in SIDES:
        assert _main(side, argv) == code
        outs[side.name] = capsys.readouterr().out
        assert side.store.campaigns() == []
    assert outs["torch"] == outs["jax"]


def _noop_campaign(extra=()):
    return ["campaign", "--no-ssh", "--time-limit", "1", "--workload",
            "noop", "--axis", "concurrency=1,2", "--seeds", "2",
            "--campaign-id", "cl", *extra]


def test_cli_campaign_equal_then_resume_and_audit(capsys, caplog):
    reports = {}
    for side in SIDES:
        assert _main(side, _noop_campaign(["--parallel", "2"])) == 0
        capsys.readouterr()
        with open(side.store.campaign_path("cl", "report.json")) as f:
            reports[side.name] = _mask_report(json.load(f))
        # a resume with everything journaled runs nothing
        assert _main(side, _noop_campaign(["--resume"])) == 0
        assert len(side.store.load_campaign_records("cl")) == 4
        # the audit of the existing campaign exits 0
        assert _main(side, ["campaign", "--no-ssh", "--lint",
                            "--campaign-id", "cl"]) == 0
        assert "fleetlint audit: cl" in capsys.readouterr().out
        # starting afresh over it is a usage error
        with caplog.at_level(logging.ERROR):
            assert _main(side, _noop_campaign()) == 254
    assert reports["torch"] == reports["jax"]
    assert reports["torch"]["summary"]["outcomes"] == {"True": 4}
    assert reports["torch"]["fleet_analysis"]["counts"]["error"] == 0


def test_cli_register_campaign_on_the_cpu_equals_the_reference(capsys):
    """The acceptance shape: ``campaign --no-ssh --axis workload=register
    --seeds 2 --parallel 2 --device cpu`` against the JAX package's
    campaign of the same matrix (its register checker on its CPU
    backend), outcome for outcome; then a campaign interrupted after its
    first cell, resumed through the command line, runs only the
    unjournaled cell."""
    argv = ["campaign", "--no-ssh", "--axis", "workload=register",
            "--seeds", "2", "--time-limit", "2", "--per-key-limit", "8"]
    outs = {}
    for side in SIDES:
        extra = ["--device", "cpu"] if side is TORCH else []
        assert _main(side, argv + ["--parallel", "2", "--campaign-id",
                                   "reg"] + extra) == 0
        with open(side.store.campaign_path("reg", "report.json")) as f:
            rep = json.load(f)
        outs[side.name] = (outcome_map(rep), rep["summary"],
                           rep["fleet_analysis"]["counts"],
                           rep["certification"]["counts"])
    capsys.readouterr()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == {"seed=0,workload=register": True,
                                "seed=1,workload=register": True}
    # interrupted after the first cell, then resumed from the CLI
    from jepsen_tpu_torch import demo
    latch = TLatch()
    cells = tplan.expand({"axes": {"workload": ["register"],
                                   "seed": [0, 1]}})

    def run_fn(test):
        from jepsen_tpu_torch import core
        out = core.run(test)
        latch.set("SIGINT")
        return out

    opts = tcli.test_opt_fn({"no-ssh": True, "time-limit": 2,
                             "per-key-limit": 8, "device": "cpu",
                             "concurrency": "1n"})
    rep = tscheduler.run_cells(
        [dict(c, build=lambda p: demo.demo_test({**opts, **p}))
         for c in cells], campaign_id="int", latch=latch, run_fn=run_fn)
    assert rep["status"] == "aborted"
    assert len(rep["cells"]) == 1
    assert _main(TORCH, argv + ["--campaign-id", "int", "--resume",
                                "--device", "cpu"]) == 0
    with open(tstore.campaign_path("int", "report.json")) as f:
        rep = json.load(f)
    assert rep["summary"]["skipped-resumed"] == 1
    assert outcome_map(rep) == outs["torch"][0]
    assert len(tstore.load_campaign_records("int")) == 2


def test_test_all_campaign_route_equal(capsys):
    outs = {}
    for side in SIDES:
        cmd = side.cli.test_all_cmd({
            "tests-fn": lambda o, side=side: [quick_cell(side, "ta-1"),
                                              quick_cell(side, "ta-2")]})
        codes = []
        for opts in ({"parallel": 2, "device-slots": 1,
                      "campaign-id": "ta", "resume": False},
                     {"parallel": 1, "device-slots": 1,
                      "campaign-id": None, "resume": True},
                     {"parallel": 1, "device-slots": 1,
                      "campaign-id": "ta2", "resume": False}):
            with pytest.raises(SystemExit) as ei:
                cmd["test-all"]["run"](opts)
            codes.append(ei.value.code)
        out = capsys.readouterr().out
        outs[side.name] = (codes, len(side.store.load_campaign_records(
            "ta")), len(side.store.load_campaign_records("ta2")),
            "[ta-1]" in out and "[ta-2]" in out)
    assert outs["torch"] == outs["jax"] == ([0, 0, 0], 2, 2, True)


@pytest.mark.parametrize("fn,args", [
    ("campaign_exit_code", ({"status": "aborted",
                             "results": {True: [{"cell": "a"}]}},)),
    ("campaign_exit_code", ({"status": "aborted",
                             "results": {"True": [{"cell": "a"}],
                                         "False": [{"cell": "b"}]}},)),
    ("campaign_exit_code", ({"status": "aborted",
                             "results": {"crashed": [{"cell": "a"}]}},)),
    ("campaign_exit_code", ({"status": "complete",
                             "results": {True: [{"cell": "a"}]}},)),
    ("parse_axes", (["workload=a,b", "concurrency=2,4", "x=1.5,q"], 2)),
    ("parse_axes", (["oops"],)),
    ("parse_axes", (["=1"],)),
    ("_coerce_axis_value", ("3",)),
    ("_coerce_axis_value", ("3.5",)),
    ("_coerce_axis_value", ("3n",)),
    ("_jsonable_options", ({"workers": "local,local", "lease": 5.0,
                            "time-limit": 3, "device": "cpu",
                            "ssh": {"dummy?": True}, "nodes": ["n1"],
                            "argv": ["campaign"], "test-fn": len,
                            "standby": True, "workload": "register"},)),
])
def test_cli_helpers_equal(fn, args):
    def call(f):
        try:
            return ("ok", f(*args))
        except Exception as e:  # noqa: BLE001 - compared across packages
            return (type(e).__name__, str(e))

    assert call(getattr(tcli, fn)) == call(getattr(jcli, fn))


@pytest.mark.parametrize("argv,item", [
    (["--serve"], "d4"),
    (["--capacity", "plan"], "d5"),
    (["--device-mem-budget", "16G"], "d5"),
    (["--device-slots", "auto"], "d5"),
])
def test_later_slice_options_exit_255_naming_their_sub_slice(
        argv, item, caplog):
    with caplog.at_level(logging.CRITICAL):
        assert _main(TORCH, ["campaign", "--no-ssh", "--seeds", "1",
                             "--device", "cpu"] + argv) == 255
    assert "NotImplementedError" in caplog.text
    assert f"A.11({item})" in caplog.text
    assert tstore.campaigns() == []


@pytest.mark.parametrize("argv", [
    ["--workers", "local,local"],
    ["--standby"],
    ["--standby", "--workers", "local"],
    ["--coordinator-lease-s", "5"],
    ["--coordinator-lease-s", "5", "--workers", "local"],
    ["--backends", "gpu,cpu"],
    ["--chaos-profile", "soak:7", "--workers", "local"],
    ["--chaos-profile", "coordinator-kill", "--workers", "local"],
    ["--workers", "local", "--lease", "0"],
    ["--workers", "a=local,a=local"],
    ["--workers", "local", "--lint"],
])
def test_fleet_options_lint_as_the_reference(argv, capsys):
    """The fleet options lint as the reference's do: the same exit code
    and PL codes from ``--lint``."""
    out = {}
    for side in SIDES:
        base = ["campaign", "--no-ssh", "--seeds", "1", "--lint"] + \
            [a for a in argv if a != "--lint"]
        code = _main(side, base + (["--device", "cpu"]
                                   if side is TORCH else []))
        text = capsys.readouterr().out
        out[side.name] = (code, sorted(set(re.findall(r"PL\d{3}", text))))
    # PL016 is the service's (ROADMAP.md A.11(d4)): the reference runs it
    # beside PL014 under --workers
    theirs = (out["jax"][0], [c for c in out["jax"][1] if c != "PL016"])
    assert out["torch"] == theirs
    assert tstore.campaigns() == []


def test_test_all_backends_runs_as_the_reference(capsys):
    """test-all's scheduler route with ``--backends cpu`` journals the
    cpu tier on every cell, in both packages."""
    outs = {}
    for side in SIDES:
        cmd = side.cli.test_all_cmd({
            "tests-fn": lambda o, side=side: [quick_cell(side, "tb-1"),
                                              quick_cell(side, "tb-2")]})
        with pytest.raises(SystemExit) as ei:
            cmd["test-all"]["run"]({"parallel": 2, "device-slots": 1,
                                    "campaign-id": "tb", "resume": False,
                                    "backends": "cpu"})
        capsys.readouterr()
        outs[side.name] = (ei.value.code, sorted(
            (r["cell"], r["backend"], r["outcome"]) for r in
            side.store.latest_campaign_records("tb")))
    assert outs["torch"] == outs["jax"] == (
        0, [("tb-1", "cpu", True), ("tb-2", "cpu", True)])


# ---------------------------------------------------------------------------
# certify_campaign

def test_certify_campaign_equal(tmp_path):
    """Both certifiers over the same campaign records (run directories
    written by the port's register workload on the CPU): the same
    sample and findings."""
    from jepsen_tpu.analysis import certify as jcertify
    from jepsen_tpu_torch.analysis import certify as tcertify
    argv = ["campaign", "--no-ssh", "--axis", "workload=register,noop",
            "--seeds", "3", "--time-limit", "1", "--per-key-limit", "6",
            "--campaign-id", "cert", "--device", "cpu"]
    assert _main(TORCH, argv) == 0
    recs = tstore.latest_campaign_records("cert")
    # a record whose run directory is gone is left out of the sample
    recs = recs + [{"cell": "gone", "path": str(tmp_path / "gone")}]
    for sample in (0, 1, 2, 4, 10):
        theirs = jcertify.certify_campaign(recs, sample=sample)
        ours = tcertify.certify_campaign(recs, sample=sample)
        assert ours == theirs
    assert ours["sampled"] == 6 and ours["counts"]["error"] == 0
    assert tcertify.certify_campaign([]) == jcertify.certify_campaign([])


def test_axis_concurrency_suffix_syntax_like_the_reference():
    """A concurrency axis may use the documented '3n' form: the value
    lands after test_opt_fn ran, so the build re-parses it."""
    seen = {}
    for side in SIDES:
        got = seen.setdefault(side.name, [])

        def tf(o, side=side, got=got):
            got.append(o["concurrency"])
            return quick_cell(side, f"c{o['concurrency']}")

        cmd = side.cli.campaign_cmd({"test-fn": tf})
        with pytest.raises(SystemExit) as ei:
            cmd["campaign"]["run"]({"axis": ["concurrency=2n,3n"],
                                    "seeds": None, "parallel": 1,
                                    "device-slots": 1,
                                    "campaign-id": "cnx", "resume": False,
                                    "nodes": ["n1", "n2"]})
        assert ei.value.code == 0
    assert sorted(seen["torch"]) == sorted(seen["jax"]) == [4, 6]


def test_compile_cache_hits_across_shape_identical_cells():
    """Two cells with the same deterministic register history: the
    second cell's search is a repeat (a hit), in the campaign's report, its
    metrics.json gauges and the second cell's own run metrics (the
    reference's case, with the port's label)."""
    class RegClient(tclient.Client):
        def __init__(self):
            self.value = None

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            out = dict(op, type="ok")
            if op["f"] == "write":
                self.value = op["value"]
            else:
                out["value"] = self.value
            return out

    from jepsen_tpu_torch.checker import checkers

    def lin_cell(name):
        ops = []
        for i in range(4):
            ops += [{"type": "invoke", "f": "write", "value": i},
                    {"type": "invoke", "f": "read", "value": None}]
        it = iter(ops)
        t = dummy_test(TORCH, name=name, nodes=["n1"], concurrency=1,
                       client=RegClient(),
                       checker=checkers.linearizable(
                           {"model": "register", "algorithm": "jax-wgl",
                            "engine_opts": {"device": "cpu"}}),
                       generator=tgen.clients(
                           lambda test, ctx: next(it, None)))
        t["obs?"] = True
        t["searchplan?"] = False
        return t

    rep = tscheduler.run_cells([{"id": "lin-1", "test": lin_cell("lin-1")},
                                {"id": "lin-2", "test": lin_cell("lin-2")}],
                               campaign_id="cc")
    assert outcome_map(rep) == {"lin-1": True, "lin-2": True}
    assert rep["compile_cache"]["hits"] >= 1
    assert rep["compile_cache"]["misses"] >= 1
    with open(tstore.campaign_path("cc", "metrics.json")) as f:
        assert json.load(f)["gauges"]["campaign.compile_cache.hits"] >= 1
    with open(os.path.join(tstore.base_dir, "lin-2", "latest",
                           "metrics.json")) as f:
        counters = json.load(f)["counters"]
    assert sum(v for k, v in counters.items()
               if k.startswith("campaign.compile_cache.hits")
               and "engine=torch-wgl" in k) >= 1
