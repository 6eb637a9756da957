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
    assert int(out.stdout.strip()) >= 15    # every module of the slice


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
