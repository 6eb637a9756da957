"""Build the port's CUDA kernels at first use.

Each ``checker/csrc/*.cu`` source is compiled by ``nvcc`` into its own
shared library with a plain ``extern "C"`` launcher (no PyTorch headers,
so a build takes seconds) and loaded with ``ctypes``. Libraries go to
``build/jepsen_tpu_torch/`` beside the package, named by a hash of the
source and flags, so an edited source rebuilds and an unchanged one is
reused. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "checker", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "jepsen_tpu_torch")

#: every kernel source of the port (name -> file under checker/csrc)
SOURCES = {"rollout": "rollout.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}
#: seconds each library took to build in this process (0.0 when reused)
build_seconds = {}


class BuildError(RuntimeError):
    """nvcc failed; the message carries its stderr."""


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise BuildError("nvcc not found on PATH or under /usr/local/cuda")


def _target(src):
    stem = os.path.splitext(os.path.basename(src))[0]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _start(src):
    """Start nvcc for ``src`` unless its library exists; returns
    (process or None, tmp path, final path)."""
    out = _target(src)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name, src, proc, tmp, out, t0):
    import time
    if proc is not None:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise BuildError(
                f"nvcc failed on {os.path.basename(src)} (exit "
                f"{proc.returncode}):\n{err}")
        os.replace(tmp, out)
    build_seconds[name] = time.monotonic() - t0 if proc else 0.0
    _libs[name] = ctypes.CDLL(out)


def build_all():
    """Build every kernel source at once, one nvcc each, all started
    together; returns {name: seconds}."""
    import time
    with _lock:
        t0 = time.monotonic()
        todo = [(n, os.path.join(CSRC, SOURCES[n])) for n in SOURCES
                if n not in _libs]
        started = [(n, src, *_start(src)) for n, src in todo]
        errors = []
        for name, src, proc, tmp, out in started:
            try:   # every nvcc is waited for before any error is raised
                _finish(name, src, proc, tmp, out, t0)
            except BuildError as exc:
                errors.append(str(exc))
        if errors:
            raise BuildError("\n".join(errors))
    return dict(build_seconds)


def loaded(name):
    """Whether kernel source ``name``'s library is loaded in this
    process (a search that launches it would otherwise build or load it
    first)."""
    return name in _libs


def library(name):
    """The loaded ctypes library of kernel source ``name``, built on
    first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def library_of(src):
    """The loaded library of a CUDA source outside the package, such as
    an earlier version of one of its kernels to time against, built as
    the package's own are."""
    import time
    src = os.path.abspath(src)
    with _lock:
        if src not in _libs:
            _finish(src, src, *_start(src), time.monotonic())
    return _libs[src]
