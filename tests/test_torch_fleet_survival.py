"""The port's fleet survival plane (``jepsen_tpu_torch/fleet/chaos.py``,
``fleet/sync.py``, the dispatcher's sync, steal and strike paths)
against the JAX package's.

The chaos schedules are pure functions of ``(profile, seed, worker)``:
every profile is drawn at several seeds on both sides and compared
whole. The sync checks feed both packages' ``manifest`` and
``pull_run`` the same run directory through the same faulty transport
and compare results (minus wall clocks). The dispatch cases run real
loopback worker processes of the port (``device: "cpu"``); where a case
compares with the reference, the reference runs the same cells under
``JAX_PLATFORMS=cpu`` in a store of its own. Tolerance: equality."""

import dataclasses
import json
import os
import shlex
import signal
import subprocess

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu.campaign import compile_cache as jcc
from jepsen_tpu.campaign import plan as jplan
from jepsen_tpu.control import remotes as jremotes
from jepsen_tpu.fleet import chaos as jchaos
from jepsen_tpu.fleet import dispatch as jdispatch
from jepsen_tpu.fleet import ledger as jledger
from jepsen_tpu.fleet import sync as jsync
from jepsen_tpu.robust import RetryPolicy as JRetry
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.campaign import compile_cache as tcc
from jepsen_tpu_torch.campaign.journal import CampaignJournal
from jepsen_tpu_torch.control import remotes as tremotes
from jepsen_tpu_torch.fleet import backends as tbackends
from jepsen_tpu_torch.fleet import chaos as tchaos
from jepsen_tpu_torch.fleet import dispatch as tdispatch
from jepsen_tpu_torch.fleet import ledger as tledger
from jepsen_tpu_torch.fleet import sync as tsync
from jepsen_tpu_torch.robust import RetryPolicy as TRetry

NOOP = {"nodes": ["n1"], "concurrency": 1, "ssh": {"dummy?": True},
        "time-limit": 1, "workload": "noop"}
TNOOP = dict(NOOP, device="cpu")


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "torch"))
    for m in (jcc, tcc):
        m.reset()
    for m in (jsync, tsync):
        m.clear_pending()
    yield
    for m in (jcc, tcc):
        m.reset()
    for m in (jsync, tsync):
        m.clear_pending()


def _cells(n=2):
    return jplan.expand({"axes": {"seed": list(range(n)),
                                  "workload": ["noop"]}})


def _seed_run_dir(root, name="demo-noop/20260101T000000.000000+0000"):
    """A fake completed run directory with a few artifacts."""
    d = os.path.join(str(root), name)
    os.makedirs(d)
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump({"valid": True}, f)
    with open(os.path.join(d, "history.jsonl"), "w") as f:
        f.write('{"type": "invoke"}\n' * 200)
    with open(os.path.join(d, "jepsen.log"), "w") as f:
        f.write("fin\n")
    return d, name


def _terminal(cid):
    return [r for r in tstore.load_campaign_records(cid)
            if not r.get("event")]


# ---------------------------------------------------------------------------
# chaos: the same schedules as the reference, profile by profile


SEEDS = (0, 1, 7, 42, 1234567)
WORKERS = ("local", "local#2", "w1", "db1:22")
CELLS = [f"seed={i},workload=w{i % 3}" for i in range(7)]


def _schedule(mod, spec, worker, n=40):
    faults = mod.parse(spec).faults_for(worker)
    return [faults(kind) for kind in ("execute", "download", "upload")
            for _ in range(n)]


@pytest.mark.parametrize("name", sorted(jchaos.PROFILES))
def test_chaos_schedules_equal_for_every_profile_and_seed(name):
    assert sorted(tchaos.PROFILES) == sorted(jchaos.PROFILES)
    for seed in SEEDS:
        spec = f"{name}:{seed}"
        tp, jp = tchaos.parse(spec), jchaos.parse(spec)
        assert tp.describe() == jp.describe()
        assert tp.skew_bound_s() == jp.skew_bound_s()
        for w in WORKERS:
            assert _schedule(tchaos, spec, w) == _schedule(jchaos, spec, w)
            assert tp.skew_for(w) == jp.skew_for(w)
        for n in (0, 1, 2, len(CELLS)):
            assert tp.plan_kills(CELLS[:n]) == jp.plan_kills(CELLS[:n])
            assert tp.plan_coordinator_kill(CELLS[:n]) == \
                jp.plan_coordinator_kill(CELLS[:n])


@pytest.mark.parametrize("fields", [
    {"kills": 3, "seed": 5}, {"coordinator_kill": 1, "seed": 9},
    {"clock_skew_p": 0.5, "clock_skew_max_s": 10.0, "seed": 3},
    {"exec_exit255_p": 1.0, "exec_exit255_max": 2, "hang_p": 1.0,
     "hang_max": 1, "download_partial_p": 1.0, "download_partial_max": 1,
     "upload_fail_p": 1.0, "upload_fail_max": 1, "seed": 11}])
def test_custom_profiles_draw_the_same_faults(fields):
    tp, jp = tchaos.ChaosProfile(**fields), jchaos.ChaosProfile(**fields)
    for w in WORKERS:
        tf, jf = tp.faults_for(w), jp.faults_for(w)
        assert [tf(k) for k in ("execute", "download", "upload") * 9] == \
            [jf(k) for k in ("execute", "download", "upload") * 9]
        assert tp.skew_for(w) == jp.skew_for(w)
    assert tp.plan_kills(CELLS) == jp.plan_kills(CELLS)
    assert tp.plan_coordinator_kill(CELLS) == \
        jp.plan_coordinator_kill(CELLS)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("spec", ["cyclone", "soak:abc", "soak:4.5",
                                  ":3"])
def test_chaos_parse_rejects_as_the_reference(spec):
    with pytest.raises(ValueError) as t:
        tchaos.parse(spec)
    with pytest.raises(ValueError) as j:
        jchaos.parse(spec)
    assert str(t.value) == str(j.value)


def test_chaos_parse_specs():
    for mod in (tchaos, jchaos):
        assert mod.parse(None) is None
        p = mod.parse("soak")
        assert p.name == "soak" and p.seed == 0
        assert mod.parse("soak:42").seed == 42
        assert mod.parse(p) is p


def test_tear_ledger_tail_equal_and_tolerated():
    out = {}
    for name, st, chaos, fl in (("jax", jstore, jchaos, jledger),
                                ("torch", tstore, tchaos, tledger)):
        led = fl.Ledger(st.compile_ledger_path())
        led.record("e", ("good", 1))
        chaos.tear_ledger_tail(led)
        with open(led.path, "rb") as f:
            raw = f.read()
        after = fl.Ledger(led.dir)
        after.record("e", ("after", 2))
        out[name] = (raw.split(b"\n")[-1], sorted(after.refresh()),
                     after.stats()["shapes"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == b'{"key": ["chaos-torn'


# ---------------------------------------------------------------------------
# artifact sync: manifest, atomicity, torn copies


def _conn(remotes):
    return remotes.LocalRemote().connect({"host": "local"})


def test_manifest_equal_and_rejects_empty(tmp_path):
    src, _ = _seed_run_dir(tmp_path / "remote")
    man = tsync.manifest(_conn(tremotes), src)
    assert man == jsync.manifest(_conn(jremotes), src)
    assert set(man) == {"results.json", "history.jsonl", "jepsen.log"}
    empty = tmp_path / "empty"
    empty.mkdir()
    for sync, rem in ((tsync, tremotes), (jsync, jremotes)):
        with pytest.raises(sync.SyncError, match="empty manifest"):
            sync.manifest(_conn(rem), str(empty))


def test_faulty_remote_partial_download_truncates_largest(tmp_path):
    src, _ = _seed_run_dir(tmp_path / "remote")
    sizes = []
    for rem in (tremotes, jremotes):
        faults = iter(["partial"])
        conn = rem.FaultyRemote(_conn(rem),
                                lambda kind, f=faults: next(f, None))
        dest = str(tmp_path / f"copy-{rem.__name__}")
        r = conn.download({}, src, dest)
        assert r["exit"] == 0          # the torn copy REPORTS success
        sizes.append({n: os.path.getsize(os.path.join(dest, n))
                      for n in os.listdir(dest)})
    assert sizes[0] == sizes[1]
    assert sizes[0]["history.jsonl"] == os.path.getsize(
        os.path.join(src, "history.jsonl")) // 2


def _pull_both(tmp_path, faults_for, **kw):
    src, _ = _seed_run_dir(tmp_path / "remote")
    out = {}
    for name, sync, rem, retry in (("jax", jsync, jremotes, JRetry),
                                   ("torch", tsync, tremotes, TRetry)):
        faults = faults_for()
        conn = rem.FaultyRemote(_conn(rem),
                                lambda kind, f=faults: f(kind))
        dest = str(tmp_path / name / "demo-noop" / "t1")
        try:
            info = sync.pull_run(conn, src, dest,
                                 policy=retry(tries=3, base_s=0.01), **kw)
            info.pop("wall_s")
            out[name] = ("ok", info, sorted(os.listdir(dest)))
        except sync.SyncError as e:
            out[name] = ("error", str(e), e.attempts,
                         os.path.exists(dest))
    return out, src


def test_pull_run_catches_a_torn_copy_that_reports_success(tmp_path):
    """The crash-consistency core: a torn copy that reports success is
    caught by manifest verification and retried, and the partial copy
    is never visible at the destination."""
    def once():
        it = iter(["partial"])
        return lambda kind: next(it, None) if kind == "download" else None
    out, src = _pull_both(tmp_path, once)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "ok" and out["torch"][1]["attempts"] == 2
    assert out["torch"][1]["manifest"]["history.jsonl"] == \
        os.path.getsize(os.path.join(src, "history.jsonl"))


def test_pull_run_terminal_failure_leaves_no_partial(tmp_path):
    def always():
        return lambda kind: "partial" if kind == "download" else None
    out, _ = _pull_both(tmp_path, always)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "error" and out["torch"][3] is False
    assert "partial download" in out["torch"][1]
    assert not os.path.isdir(tstore.sync_tmp_path()) \
        or not os.listdir(tstore.sync_tmp_path())


def test_pull_run_mirrors_atomically_and_once(tmp_path):
    src, name = _seed_run_dir(tmp_path / "remote")
    dest = tstore.path({"name": "demo-noop",
                        "start-time": name.split("/")[1]})
    info = tsync.pull_run(_conn(tremotes), src, dest)
    assert info["files"] == 3 and info["attempts"] == 1
    assert json.load(open(os.path.join(dest, "results.json")))["valid"]
    assert tsync.pull_run(_conn(tremotes), src, dest).get("already")
    assert not os.path.isdir(tstore.sync_tmp_path()) \
        or not os.listdir(tstore.sync_tmp_path())


def test_fetch_on_demand_pulls_registered_runs(tmp_path):
    src, _ = _seed_run_dir(tmp_path / "wstore")
    rel = "demo-noop/t3"
    tsync.register_pending(rel, kind="local", conn_spec={"host": "local"},
                           remote_dir=src)
    assert rel in tsync.pending()
    assert tsync.fetch_on_demand(rel + "/results.json") is True
    assert os.path.isdir(os.path.join(os.path.abspath(tstore.base_dir),
                                      rel))
    assert rel not in tsync.pending()
    assert tsync.fetch_on_demand("demo-noop/unknown") is False


def test_resolve_remote_equal():
    for kind in ("local", "ssh", "docker", None):
        t, j = tsync.resolve_remote(kind), jsync.resolve_remote(kind)
        assert (t and t.__name__) == (j and j.__name__)


# ---------------------------------------------------------------------------
# dispatch + sync end to end (the port's real loopback workers)


def test_fleet_sync_with_isolated_worker_store(tmp_path):
    """Workers write into their OWN store; every run directory is
    mirrored into the coordinator store and journaled, as the
    reference's are."""
    out = {}
    for name, st, disp, opts, builder in (
            ("jax", jstore, jdispatch, NOOP, "jepsen_tpu.demo:demo_test"),
            ("torch", tstore, tdispatch, TNOOP,
             "jepsen_tpu_torch.demo:demo_test")):
        wstore = str(tmp_path / f"wstore-{name}")
        rep = disp.run_fleet(
            _cells(2), disp.parse_workers("local,local"),
            campaign_id="sync", base_options=opts, lease_s=120,
            sync_timeout_s=60, worker_store_dir=wstore, builder=builder)
        recs = st.latest_campaign_records("sync")
        for r in recs:
            assert r["synced"] is True
            assert r["path"].startswith(os.path.abspath(st.base_dir))
            assert os.path.exists(os.path.join(r["path"], "results.json"))
            assert r["worker-path"].startswith(os.path.abspath(wstore))
        evs = [e for e in st.campaign_events("sync")
               if e["event"] == "artifact-sync"]
        out[name] = (rep["summary"],
                     sorted((e["cell"], e["status"], sorted(e["manifest"]))
                            for e in evs),
                     rep["fleet_analysis"]["counts"])
    assert out["torch"] == out["jax"]
    assert not os.path.isdir(tstore.sync_tmp_path()) \
        or not os.listdir(tstore.sync_tmp_path())


def test_fleet_sync_failure_keeps_verdict_then_resume_resyncs(tmp_path):
    """Terminal sync failure: the verdict is kept (synced: false), the
    run is registered for on-demand fetch, and --resume re-SYNCS with a
    different worker list, without re-running the cell."""
    wstore = str(tmp_path / "wstore")
    broken = tchaos.ChaosProfile(
        name="torn", seed=1, download_partial_p=1.0,
        download_partial_max=10 ** 6)
    cells = _cells(1)
    rep = tdispatch.run_fleet(
        cells, tdispatch.parse_workers("local"), campaign_id="resync",
        base_options=TNOOP, lease_s=120, max_leases=1, sync_timeout_s=5,
        worker_store_dir=wstore, chaos=broken)
    assert rep["summary"]["outcomes"] == {"True": 1}
    rec = tstore.latest_campaign_records("resync")[0]
    assert rec["synced"] is False and rec["outcome"] is True
    assert not os.path.exists(rec["path"])
    assert tsync.pending()
    assert rec["worker-kind"] == "local"
    assert rec["worker-conn"]["host"] == "local"
    rep2 = tdispatch.run_fleet(
        cells, tdispatch.parse_workers("w2=localhost"),
        campaign_id="resync", resume=True, base_options=TNOOP,
        lease_s=120, sync_timeout_s=60, worker_store_dir=wstore)
    assert rep2["summary"]["skipped-resumed"] == 1
    assert os.path.exists(os.path.join(rec["path"], "results.json"))
    ok = [e for e in tstore.campaign_events("resync")
          if e["event"] == "artifact-sync" and e["status"] == "ok"]
    assert len(ok) == 1 and len(_terminal("resync")) == 1


class _KilledMidDownload:
    """A transport whose download really dies by SIGKILL partway
    through copying the run directory (a killed scp) for its first
    ``times`` downloads, then delegates to the clean transport."""

    def __init__(self, inner, times):
        self.inner = inner
        self.left = times
        self.exits = []

    def execute(self, ctx, action):
        return self.inner.execute(ctx, action)

    def upload(self, ctx, local_paths, remote_path):
        return self.inner.upload(ctx, local_paths, remote_path)

    def download(self, ctx, remote_paths, local_path):
        if self.left <= 0:
            return self.inner.download(ctx, remote_paths, local_path)
        self.left -= 1
        p = subprocess.run(
            ["sh", "-c",
             f"cp -rp {shlex.quote(str(remote_paths))} "
             f"{shlex.quote(str(local_path))} && "
             f"rm -f {shlex.quote(str(local_path))}/results.json && "
             "kill -9 $$"])
        self.exits.append(p.returncode)
        return {"cmd": "download", "out": "", "err": "Killed",
                "exit": p.returncode}


def test_worker_killed_mid_download_no_partials_requeued(tmp_path):
    """The worker side dies mid-download often enough that lease 1's
    sync fails: no partial run directory is ever visible, the cell is
    re-queued, and exactly one terminal record lands, mirrored."""
    workers = tdispatch.parse_workers("local")
    real_connect = workers[0].connect
    conns = []

    def connect():
        conns.append(_KilledMidDownload(real_connect(), times=4))
        return conns[-1]

    workers[0].connect = connect
    rep = tdispatch.run_fleet(
        _cells(1), workers, campaign_id="midkill", base_options=TNOOP,
        lease_s=120, max_leases=3, sync_timeout_s=3,
        worker_store_dir=str(tmp_path / "wstore"))
    assert rep["summary"]["outcomes"] == {"True": 1}
    assert any(e == -signal.SIGKILL for c in conns for e in c.exits)
    terminal = _terminal("midkill")
    assert len(terminal) == 1
    rec = terminal[0]
    assert rec["synced"] is True and rec["attempt"] >= 2
    assert os.path.exists(os.path.join(rec["path"], "results.json"))
    assert any(e["event"] == "lease-failed"
               and "artifact sync failed" in e["error"]
               for e in tstore.campaign_events("midkill"))
    for name in tstore.test_names():
        for t in tstore.tests(name):
            assert os.path.exists(os.path.join(
                tstore.base_dir, name, t, "results.json")), (name, t)


def test_chaos_soak_acceptance(tmp_path):
    """Two loopback workers under the seeded soak profile (exec
    exit-255, a transport hang, a partial download, one worker kill -9,
    a torn ledger tail) with isolated worker stores: every cell lands
    terminal exactly once, mirrored, and the audit is clean."""
    prof = tchaos.PROFILES["soak"].with_seed(42)
    cells = _cells(2)
    rep = tdispatch.run_fleet(
        cells, tdispatch.parse_workers("local,local"),
        campaign_id="soak", base_options=TNOOP, lease_s=60,
        max_leases=5, sync_timeout_s=30,
        worker_store_dir=str(tmp_path / "wstore"), chaos=prof)
    assert rep["status"] == "complete"
    assert rep["summary"]["outcomes"] == {"True": 2}
    meta = CampaignJournal("soak").load_meta()
    assert meta["chaos"] == jchaos.parse("soak:42").describe()
    per_cell = {}
    for r in _terminal("soak"):
        per_cell[r["cell"]] = per_cell.get(r["cell"], 0) + 1
        assert r["synced"] is True and os.path.isdir(r["path"])
    assert per_cell == {c["id"]: 1 for c in cells}
    assert prof.plan_kills([c["id"] for c in cells]) == \
        jchaos.parse("soak:42").plan_kills([c["id"] for c in cells])
    evs = tstore.campaign_events("soak")
    assert sum(1 for e in evs if e["event"] == "lease") > 2
    assert any(e["event"] == "lease-failed" for e in evs)
    fa = rep["fleet_analysis"]
    assert fa["counts"]["error"] == 0, fa
    assert fa["counts"]["warning"] == 0, fa
    assert fa["checks"]["runs_audited"] == 2, fa


# ---------------------------------------------------------------------------
# lease budget, dead workers, the backends argument


def test_fleet_lease_budget_exhaustion(tmp_path):
    """max_leases=1: the cell that kills its worker journals as
    crashed instead of looping forever."""
    cells = _cells(1)
    cells[0]["params"]["die-once-marker"] = str(tmp_path / "die-once")
    rep = tdispatch.run_fleet(
        cells, tdispatch.parse_workers("local"), campaign_id="exh",
        base_options=TNOOP, lease_s=120, max_leases=1)
    recs = tstore.latest_campaign_records("exh")
    assert recs[0]["outcome"] == "crashed"
    assert "lease budget exhausted" in recs[0]["error"]
    assert rep["summary"]["outcomes"] == {"crashed": 1}


def test_fleet_dead_worker_probe_and_exhaustion():
    ws = tdispatch.parse_workers("local,local")
    ws[1].probe = lambda timeout_s=30: "host unreachable"
    rep = tdispatch.run_fleet(_cells(2), ws, campaign_id="dead",
                              base_options=TNOOP,
                              lease_s=120)
    assert rep["summary"]["outcomes"] == {"True": 2}
    assert any(e["event"] == "worker-dead" and e["worker"] == "local#2"
               for e in tstore.campaign_events("dead"))
    ws = tdispatch.parse_workers("local")
    ws[0].probe = lambda timeout_s=30: "down"
    rep = tdispatch.run_fleet(_cells(1), ws, campaign_id="alldead",
                              base_options=TNOOP,
                              lease_s=120)
    assert rep["status"] == "aborted"
    assert rep["abort-reason"] == "workers-exhausted"


def test_a_comma_string_ladder_is_linted_by_tier():
    """The command line hands ``run_fleet`` the ``--backends`` string.
    The reference's PL014 reads it per character and refuses every
    fleet campaign with ``--backends``; the port lints its tier names
    (ROADMAP.md C.10) and runs."""
    backends = "gpu,cpu"
    with pytest.raises(jdispatch.FleetError,
                       match=r"unknown backend tier name\(s\) \['g'"):
        jdispatch.run_fleet(_cells(1), jdispatch.parse_workers("local"),
                            campaign_id="s", base_options=NOOP,
                            backends=backends)
    assert tbackends.ladder_of(backends) == backends.split(",")
    assert tbackends.ladder_of(True) == ["gpu", "cpu"]
    assert tbackends.ladder_of(tbackends.Failover(ladder=["cpu"])) == \
        ["cpu"]
    with pytest.raises(tdispatch.FleetError, match="PL014"):
        tdispatch.run_fleet(_cells(1), tdispatch.parse_workers("local"),
                            campaign_id="s2", backends="gpu,warp")
    rep = tdispatch.run_fleet(
        _cells(1), tdispatch.parse_workers("local"), campaign_id="s",
        base_options=dict(NOOP, device="cpu"), lease_s=120,
        backends=tbackends.Failover(
            ladder=backends.split(","),
            probe_fn=lambda t, timeout_s=None:
            None if t == "cpu" else "down"))
    assert rep["summary"]["outcomes"] == {"True": 1}
    assert [r["backend"] for r in tstore.latest_campaign_records("s")] \
        == ["cpu"]
