"""The fold kernel's CUDA source (jepsen_tpu_torch/checker/csrc/fold.cu)
compiled for the CPU with g++ under host stand-ins for the CUDA built-ins
(tests/cuda_host/cuda_runtime.h: a std::thread per CUDA thread, a
std::barrier per block, a per-warp exchange for shuffles, ballots and
__match_any_sync), at 256 threads a block, and launched through
``fold_kernel._launch`` on CPU tensors: every output equal to
``fold_kernel.plain`` on cases of ``checker/fold_cases.py``, with the
kernel's statistics on, and each branch case raising its own statistic
(``fold_cases.BRANCHES``); then two bench keys, whose rows are 8
words. The shared pool is cut to the block's sort tile (``JF_T *
JF_IPT``, 1,024 entries), so the pool case's large passes take the
global scratch and its multi-tile sort. This checks the kernel's logic
on the CPU; its speed, and what only the card does, are
``chip_smoke.py``'s. Tolerance: equality (all integers)."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from jepsen_tpu_torch import _build
from jepsen_tpu_torch.checker import (fold_ab, fold_cases, fold_kernel,
                                      streamlin)

HERE = os.path.dirname(os.path.abspath(__file__))
THREADS, ITEMS = 256, 4
CASES = ("violation", "overflow mid-fold", "n_open > C", "mutex",
         "multi-register-3 corrupted", "rows out of order",
         "pool past shared memory", "h1 collision")
NAMES = ("lin", "st", "live", "open_w", "status", "viol", "passes",
         "steps", "n_live")


def translate(src):
    """fold.cu with the launch syntax and the dynamic shared array
    rewritten as calls of the host stand-ins."""
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?unsigned char "
                 r"(\w+)\[\];", r"unsigned char* \1 = jf_host_dyn_smem();",
                 src)

    def launch(m):
        cfg = [x.strip() for x in m.group(2).split(",")]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"jf_host_launch({cfg[0]}, {cfg[1]}, {smem}, [&] "
                f"{{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"(\w+)\s*<<<([^>]*)>>>\s*\(([^;]*)\);", launch, src,
                  flags=re.S)


def _build_host(d):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel source for the CPU")
    src = d / "fold_host.cpp"
    with open(os.path.join(_build.CSRC, _build.SOURCES["fold"])) as f:
        src.write_text(translate(f.read()))
    lib = d / "libfold_host.so"
    out = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         f"-DJF_T={THREADS}", "-w",
         "-I", os.path.join(HERE, "cuda_host"), "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_host(tmp_path_factory.mktemp("fold_host"))


@pytest.fixture(scope="module")
def cases():
    return {c.name: c for c in fold_cases.cases("cpu")}


def _run(lib, case, monkeypatch, args=None):
    """The host build of the kernel on ``case`` (or on the fold arguments
    ``args``), held against plain: returns the statistics summed over its
    lanes."""
    monkeypatch.setitem(_build._libs, "fold", lib)
    monkeypatch.setattr(fold_kernel, "SMEM_POOL", THREADS * ITEMS)
    step, arrays, kinds, slots, C = args or streamlin.fold_inputs(case.jobs)
    K = arrays["lin"].shape[0]
    clocks = torch.zeros((K, fold_kernel.STATS), dtype=torch.int64)
    before = fold_kernel.launches
    got = fold_kernel._launch(fold_kernel.gate(step), arrays, kinds, slots,
                              C, clocks, None)
    assert fold_kernel.launches == before + 1
    fold_kernel.launches = before
    want = fold_kernel.plain(step, arrays, kinds, slots, C)
    for n, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), n
    stats = dict(zip(fold_kernel.STAT_NAMES, clocks.sum(0).tolist()))
    assert stats["passes"] == int(want[6].sum())
    return stats


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_on_the_cpu_equals_plain(host_lib, cases, name,
                                               monkeypatch):
    stats = _run(host_lib, cases[name], monkeypatch)
    if name in fold_cases.BRANCHES:
        assert stats[fold_cases.BRANCHES[name]] > 0, stats


def test_kernel_source_on_two_bench_keys_equals_plain(host_lib,
                                                      monkeypatch):
    """Two of ``simulate.bench_histories``' 200-op cas-register keys as one
    lane batch at 512 rows: 8 bitset words a row, so the compaction moves
    rows 16 bytes at a time (the cases' rows are 2 words), and runs of
    equal h1's top bits that the fix-up orders."""
    stats = _run(host_lib, None, monkeypatch,
                 fold_ab.batch_inputs(2, 512, torch.device("cpu")))
    assert stats["fixup_passes"] > 0, stats
