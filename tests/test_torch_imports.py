"""The port stands alone: every module of jepsen_tpu_torch (and
chip_smoke.py) imports with ``jax`` and ``jepsen_tpu`` blocked, and its
entry points refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
import jepsen_tpu_torch
names = ["jepsen_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__,
                                          "jepsen_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
leaked = sorted(m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith("jax.") or m == "jepsen_tpu"
    or m.startswith("jepsen_tpu.")))
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax_or_jepsen_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 100   # every module of the slices


def test_entry_points_default_to_cuda(monkeypatch):
    from jepsen_tpu_torch import history as h
    from jepsen_tpu_torch import models, resolve_device
    from jepsen_tpu_torch.checker import checkers, torch_wgl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hist = h.parse_history_edn_like([
        ("invoke", 0, "write", 1), ("ok", 0, "write", 1),
        ("invoke", 1, "read", None), ("ok", 1, "read", 1)])
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_wgl.check_history(models.register_spec, hist)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkers.linearizable({"model": "register"}).check({}, hist)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    r = torch_wgl.check_history(models.register_spec, hist, device="cpu")
    assert r["valid"] is True


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['chip_smoke.py']; import chip_smoke; "
         "sys.exit(chip_smoke.main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode != 0
    assert out.stdout == ""


def test_key_batch_and_queue_modules_import_without_jax():
    """The key batch, the independent checker, the queue models, the
    checker combinators and the utilities stand alone too, and
    ``parallel`` and ``independent`` export their entry points."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import independent, parallel, util
from jepsen_tpu_torch.checker import core
from jepsen_tpu_torch.models import queues
from jepsen_tpu_torch import models
assert callable(parallel.check_batch_encoded)
assert callable(parallel.check_batch_histories)
assert callable(independent.checker) and callable(independent.tuple_)
assert models.model_spec("fifo-queue") is queues.fifo_queue_spec
assert models.model_spec("unordered-queue") is queues.unordered_queue_spec
for name in ("check", "check_safe", "compose", "noop",
             "unbridled_optimism", "merge_valid", "valid_prio"):
    assert name in core.__all__, name
assert callable(util.bounded_pmap) and callable(util.op_str)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_monitor_and_cycle_modules_import_without_jax():
    """The streaming fold and StreamCheck, the txn closure and its
    checkers, the linear engine and the buckets stand alone and export
    their entry points."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import cycle, monitor, txn, util
from jepsen_tpu_torch.checker import linear, streamlin
from jepsen_tpu_torch.cycle import append, wr
from jepsen_tpu_torch.monitor import engine, stream, wgl_stream
from jepsen_tpu_torch.monitor.txn import TxnCheck
assert monitor.StreamCheck is wgl_stream.StreamCheck
assert monitor.TxnCheck is TxnCheck
assert monitor.StreamEncoder is stream.StreamEncoder
for f in (streamlin.solo_fold, streamlin.batch_fold,
          streamlin.check_encoded, linear.check_encoded,
          engine.check_prefix, engine.check_txn_prefix,
          cycle.transitive_closure, cycle.batch_closure_probe,
          cycle.check_graph, append.check, wr.check, txn.ext_reads,
          util.bucket):
    assert callable(f)
assert engine.ENGINES == ("jax-wgl", "linear", "wgl", "streamlin")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_monitor_entry_points_default_to_cuda(monkeypatch):
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.monitor import StreamCheck, TxnCheck
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamCheck(models.register_spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        TxnCheck()
    assert StreamCheck(models.register_spec, device="cpu").device.type \
        == TxnCheck(device="cpu").device.type == "cpu"


def test_gate_modules_import_without_jax():
    """The planner, the certifier and the gate stand alone too: the
    default algorithm is "competition", and ``analysis`` exports the
    execution half of the planner and the in-memory certifier."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import analysis
from jepsen_tpu_torch.analysis import certify, searchplan
from jepsen_tpu_torch.checker import checkers, core, torch_wgl
from jepsen_tpu_torch.parallel import keyshard
for f in (searchplan.plan_segments, searchplan.merge_segment_results,
          searchplan.stream_cut, certify.certify_with_diagnostics,
          core.certify_verdict, checkers.join_racers,
          torch_wgl.write_snapshot, torch_wgl.read_snapshot,
          analysis.render_text, analysis.to_json):
    assert callable(f)
assert checkers.Linearizable("register").algorithm == "competition"
assert certify.DEVICE_ENGINES[0] == "jax-wgl"
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_obs_and_store_modules_import_without_jax():
    """The obs core (trace, metrics, the facade, search and phase
    sessions), the store, the failure render and the analyzer runner
    stand alone too, and export what the JAX package's do."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import analysis, obs, store
from jepsen_tpu_torch.checker import linear_report, perf
from jepsen_tpu_torch.obs import metrics, phases, search, trace
for name in ("bind", "run_scope", "sink_scope", "current_sinks",
             "run_config", "live_registries", "enabled", "span",
             "instant", "complete", "inc", "observe", "set_gauge",
             "max_gauge", "flush", "load_trace", "trace_meta",
             "load_metrics_journal", "render_prometheus"):
    assert name in obs.__all__ and callable(getattr(obs, name)), name
for f in (search.capture, phases.capture, phases.note_wait,
          store.write_obs, store.write_results, store.write_history,
          store.load_history, store.make_path, linear_report.render_analysis,
          perf._out_path, analysis.run_analyzer, trace.load_trace,
          metrics.load_metrics_journal):
    assert callable(f)
assert store.base_dir == "store"
assert "matplotlib" not in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_mesh_and_checking_front_modules_import_without_jax():
    """The multi-device search (the mesh helpers, the sharded single
    search, the collective counter) and the checking front of a run
    (histlint, the plan report of record with JX007 and the gate walk,
    ``certify_run``) stand alone too; building a mesh is not needed to
    import them."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import analysis, parallel
from jepsen_tpu_torch.analysis import certify, histlint, searchplan, shapelint
from jepsen_tpu_torch.checker import core, torch_wgl
from jepsen_tpu_torch.monitor import core as mcore
from jepsen_tpu_torch.parallel import keyshard, searchshard
for f in (parallel.check_encoded_sharded, parallel.check_history_sharded,
          parallel.check_batch_encoded, keyshard.mesh_group,
          keyshard.mesh_device, keyshard.block_rows, keyshard.gather_rows,
          keyshard.mesh_table_stats, histlint.lint_history,
          histlint.lint_encoded, histlint.model_op_set,
          histlint.lint_test_history, analysis.lint_history,
          shapelint.lint_searchplan_shapes, mcore.find_linearizable,
          searchplan.build_plan, searchplan.per_key_parts,
          searchplan.per_value_parts, searchplan.estimate_configs,
          core.lint_history, core.plan_history, certify.certify_run,
          certify.find_linearizable_result):
    assert callable(f)
assert searchshard.ENGINE in certify.DEVICE_ENGINES
assert torch_wgl.collective_calls == 0
assert searchplan.SearchPlan([], [], []).summary()["subsearches"] == 0
assert mcore.find_linearizable(core.noop()) == (None, False)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_run_loop_modules_import_without_jax():
    """The run loop (``core.run`` with its generators, interpreter,
    clients, nemeses, control plane, robustness core, the preflight lint,
    the timeline and the register workload) stands alone too."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import (client, core, db, generator, independent,
                              interpreter, monitor, nemesis, net, robust,
                              util)
from jepsen_tpu_torch import os as jos
from jepsen_tpu_torch import tests
from jepsen_tpu_torch.analysis import planlint
from jepsen_tpu_torch.checker import timeline
from jepsen_tpu_torch.control import core as ccore, net as cnet
from jepsen_tpu_torch.control import remotes, util as cutil
from jepsen_tpu_torch.generator import testing
from jepsen_tpu_torch.nemesis import _grudges
from jepsen_tpu_torch.obs import profile
from jepsen_tpu_torch.robust import leases, retry, watchdog
from jepsen_tpu_torch.tests import linearizable_register
for f in (core.run, core.analyze, core.salvage, core.prepare_test,
          core.preflight, core.synchronize, core.primary, core.run_case,
          interpreter.run, generator.testing.simulate, testing.quick,
          independent.concurrent_generator,
          independent.sequential_generator, planlint.lint_plan,
          planlint.preflight, monitor.install, monitor.finalize,
          monitor.config, profile.scope, timeline.html, nemesis.partitioner,
          nemesis.partition_random_halves, _grudges.complete_grudge,
          util.with_relative_time, util.timeout_call, util.majority,
          robust.signal_scope, linearizable_register.test, tests.noop_test,
          cutil.exists, ccore.escape, cnet.ip, jos.noop.setup,
          remotes.DummyRemote, db.cycle, net.iptables.drop_all):
    assert callable(f)
assert issubclass(robust.RetryPolicy, object) and watchdog.WATCHDOG_FIRED
assert leases.LeaseTable and retry.RetryPolicy and client.noop
assert monitor.install({}) is None and monitor.finalize(None, {}) is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_monitored_run_and_workload_modules_import_without_jax():
    """The monitored run (``Monitor``, ``TxnMonitor``, their installers
    and certifiers) and the workload library (the cycle workloads, bank,
    long-fork, causal, causal-reverse, adya, the perf and clock
    checkers) stand alone too."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import core, monitor
from jepsen_tpu_torch.analysis import certify
from jepsen_tpu_torch.checker import clock, perf
from jepsen_tpu_torch.monitor import core as mcore, txn as mtxn
from jepsen_tpu_torch.tests import (adya, bank, causal, causal_reverse,
                                    long_fork)
from jepsen_tpu_torch.tests import cycle
from jepsen_tpu_torch.tests.cycle import append, wr
for f in (monitor.Monitor, monitor.TxnMonitor, mtxn.install_txn,
          mcore.install, mcore.finalize, core._certify_monitor_verdict,
          certify.certify_monitor, certify.certify_txn_verdict,
          certify.certify_cycle_witness, cycle.checker, cycle.txn_generator,
          append.test, wr.test, perf.perf, perf.latency_graph,
          perf.rate_graph_checker, perf.shade_nemeses, clock.clock_plot,
          bank.test, bank.plotter, long_fork.workload, causal.test,
          causal_reverse.workload, adya.workload):
    assert callable(f)
assert mcore.ABORT_REASON == "monitor-violation"
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_fault_plane_and_cli_modules_import_without_jax():
    """The fault plane on nodes (the OS installers, faketime, charybdefs,
    the clock, membership and combined nemeses with their C resources),
    the run's profiler capture, the command line (``cli``, ``__main__``,
    ``demo``, the etcd and txn suites) and its monitor A/B stand alone
    too."""
    probe = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import __main__ as main, charybdefs, cli, demo, faketime
from jepsen_tpu_torch import monitor_ab, nemesis
from jepsen_tpu_torch.checker import checkers
from jepsen_tpu_torch.nemesis import combined, membership, time as nt
from jepsen_tpu_torch.obs import profile
from jepsen_tpu_torch.os import centos, debian, smartos, ubuntu
from jepsen_tpu_torch.suites import etcd, txn
for f in (debian.install, debian.installed, debian.maybe_update,
          debian.add_repo, ubuntu.os.setup, centos.install,
          centos.install_start_stop_daemon, smartos.install,
          faketime.install, faketime.script, faketime.wrap, faketime.unwrap,
          faketime.rand_factor, charybdefs.install_thrift,
          charybdefs.install, charybdefs.break_all,
          charybdefs.break_one_percent, charybdefs.clear, nt.compile_c,
          nt.compile_tools, nt.install, nt.parse_time, nt.clock_offset,
          nt.current_offset, nt.reset_time, nt.bump_time, nt.strobe_time,
          nt.clock_nemesis, nt.reset_gen_select, nt.bump_gen_select,
          nt.strobe_gen_select, nt.clock_gen, membership.initial_fields,
          membership.resolve_ops, membership.resolve, membership.package,
          combined.db_nodes, combined.node_specs, combined.db_generators,
          combined.db_package, combined.perf_spec, combined.grudge,
          combined.partition_specs, combined.partition_package,
          combined.clock_package, combined.f_map_perf, combined.f_map,
          combined.compose_packages, combined.nemesis_packages,
          combined.nemesis_package, nemesis.compose, profile.available,
          profile.scope, profile.profile_dir_for, checkers.stats,
          checkers.unhandled_exceptions, checkers.set_checker,
          cli.add_test_opts, cli.parse_concurrency, cli.parse_nodes,
          cli.test_opt_fn, cli.single_test_cmd, cli.test_all_run_tests,
          cli.test_all_print_summary, cli.test_all_exit_code,
          cli.test_all_cmd, cli.campaign_cmd, cli.serve_cmd, cli.run,
          cli.hard_main, main.main, demo.demo_test, demo.nemesis_axis,
          etcd.etcd_test, etcd.all_tests, etcd.main, txn.txn_test,
          txn.skew_bound_from_history, txn.main, monitor_ab.main,
          monitor_ab.run_once, checkers.short_switch):
    assert callable(f)
for cls in (nt.ClockNemesis, membership.State, membership.Nemesis,
            membership.Generator, combined.DbNemesis,
            combined.PartitionNemesis, etcd.EtcdDB, demo.DemoDB):
    assert isinstance(cls, type)
assert os.path.isfile(os.path.join(nt._RESOURCE_DIR, "bump-time.c"))
assert combined.DEFAULT_INTERVAL == 10 and cli.CliError
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_campaign_and_fleet_modules_import_without_jax():
    """The campaign runner (``campaign/*``), the fleet
    (``fleet/{ledger,backends,chaos,sync,worker,dispatch,ha}``), the
    control-plane audit (``analysis/fleetmodel``, ``analysis/fleetlint``)
    and the campaign folds and trend gate (``obs/merge``,
    ``obs/bubbles``, ``obs/trend``) stand alone too; the fleet's one
    unported submodule (the service) raises naming its sub-slice."""
    probe = r"""
import sys
sys.modules["jax"] = None
sys.modules["jepsen_tpu"] = None
from jepsen_tpu_torch import campaign, cli, fleet
from jepsen_tpu_torch.analysis import certify, fleetlint, fleetmodel, planlint
from jepsen_tpu_torch.campaign import (compile_cache, journal, plan, report,
                                       scheduler)
from jepsen_tpu_torch.fleet import (backends, chaos, dispatch, ha, ledger,
                                    sync, worker)
from jepsen_tpu_torch.obs import bubbles, merge, trend
for f in (campaign.run_cells, compile_cache.note, compile_cache.stats,
          compile_cache.delta, compile_cache.reset, plan.normalize,
          plan.cell_id, plan.group_id, plan.expand, plan.lint,
          plan.validate, journal.writer_id, report.summarize, report.flakes,
          report.triage, report.results_map, report.render_text,
          scheduler.run_cells, scheduler.new_campaign_id, ha.last_lease, ha.coordinator_state, ha.current_epoch, ha.fence,
          ha.takeover_marker, fleetmodel.parse_t, fleetlint.lint_campaign,
          fleetlint.audit, fleetlint.preflight, fleetlint.load_report,
          planlint.lint_campaign, planlint.lint_fleetlint,
          planlint.lint_coalesce, planlint.lint_ha, planlint.lint_trend,
          certify.certify_campaign, merge.worker_offsets, merge.clock_offset,
          merge.merge_campaign, merge.fold_campaign_metrics,
          merge.introspection_summary, bubbles.fold_events,
          bubbles.fold_run, bubbles.fold_campaign, bubbles.dumps,
          trend.fingerprint, trend.record, trend.load, trend.compare,
          trend.mini_bench, trend.main, cli.campaign_exit_code,
          cli.parse_axes, cli.refuse_later_slices, cli._jsonable_options,
          ledger.attach, ledger.attached, ledger.detach, ledger.canon_key,
          ledger.fold_walls, backends.probe, backends.apply,
          backends.as_failover, backends.tier_options, chaos.parse,
          chaos.tear_ledger_tail, sync.resolve_remote, sync.manifest,
          sync.pull_run, sync.register_pending, sync.fetch_on_demand,
          worker.run_cell_spec, worker.parse_result, worker.main,
          dispatch.parse_workers, dispatch.run_fleet, fleet.run_fleet,
          fleet.parse_workers, planlint.lint_fleet,
          compile_cache.set_ledger, compile_cache.get_ledger):
    assert callable(f)
for cls in (ledger.Ledger, backends.Failover, chaos.ChaosProfile,
            sync.SyncError, dispatch.Worker, dispatch.FleetError,
            fleet.FleetError, ha.CoordinatorLease, ha.Standby):
    assert callable(f)
for cls in (campaign.CampaignError, journal.CampaignJournal,
            fleetmodel.CampaignModel,
            fleetmodel.RunTrace, plan.CampaignPlanError):
    assert isinstance(cls, type)
assert issubclass(fleet.FleetError, campaign.CampaignError)
assert worker.RESULT_MARKER == "JEPSEN-FLEET-RESULT:"
assert set(chaos.PROFILES) >= {"soak", "coordinator-kill"}
assert backends.DEFAULT_LADDER == ("gpu", "cpu")
assert fleet.UNPORTED == {"service": "A.11(d4)"}
try:
    fleet.service
except NotImplementedError as e:
    assert "A.11(d4)" in str(e)
else:
    raise AssertionError("service")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
