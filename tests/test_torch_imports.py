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
    assert int(out.stdout.strip()) >= 49    # every module of the slices


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
