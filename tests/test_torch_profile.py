"""The port's profile summaries (jepsen_tpu_torch/profile_main.py) on
hand-made events, its shape bucket (jepsen_tpu_torch/util.py) against
the JAX package's (jepsen_tpu/campaign/compile_cache.py), and the run's
``--profile`` capture (jepsen_tpu_torch/obs/profile.py) on the CPU
activity, its markers held to the JAX package's keys. Tolerance:
equality, or 1e-12 on sums of microseconds."""

import json
import os
import time

import pytest
import torch

from jepsen_tpu.campaign import compile_cache
from jepsen_tpu.obs import profile as jprofile
from jepsen_tpu_torch import core, store, util
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import tests as tst
from jepsen_tpu_torch.checker import checkers
from jepsen_tpu_torch.obs import profile as obs_profile
from jepsen_tpu_torch.checker import torch_wgl
from jepsen_tpu_torch.profile_main import kernel_stats, split

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU searches run small tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: (start_us, end_us, name, is_kernel): host events around three
#: kernels, two of them the rollout kernel
EVENTS = [(0.0, 100.0, "aten::copy_", False),
          (10.0, 30.0, "jt_rollout_kernel<1>", True),
          (40.0, 45.0, "sort_kernel", True),
          (50.0, 80.0, "jt_rollout_kernel<1>", True),
          (90.0, 200.0, "cudaDeviceSynchronize", False)]


def test_kernel_stats_counts_kernels_only():
    got = kernel_stats(EVENTS, 200e-6, top=1)
    assert got["kernel_launches"] == 3
    assert got["device_busy_s"] == pytest.approx(55e-6, abs=1e-12)
    assert got["device_idle_share"] == pytest.approx(1 - 55 / 200,
                                                     abs=1e-12)
    assert got["top_kernels"] == [{"name": "jt_rollout_kernel<1>",
                                   "device_s": pytest.approx(50e-6),
                                   "count": 2}]
    assert kernel_stats([], 0.0)["device_idle_share"] is None


def test_split_shares_kernel_stats():
    got = split(EVENTS, 5)
    assert {k: got[k] for k in ("kernel_launches", "device_busy_s",
                                "device_idle_share", "top_kernels")} \
        == kernel_stats(EVENTS, 200e-6)
    assert got["search_loop_s"] == pytest.approx(70e-6, abs=1e-12)
    assert got["kernel_launches_per_iteration"] == 3 / 5
    assert got["rollout_share_of_busy"] == pytest.approx(50 / 55)


@pytest.mark.parametrize("lo", [1, 8, 64])
def test_bucket_matches_jax(lo):
    for x in list(range(0, 130)) + [1000, 4096, 4097, 65535]:
        assert util.bucket(x, lo) == compile_cache.bucket(x, lo)
    assert util.DEFAULT_N_FLOOR == compile_cache.DEFAULT_N_FLOOR
    assert torch_wgl.DEFAULT_N_FLOOR == util.DEFAULT_N_FLOOR


# ---------------------------------------------------------------------------
# the --profile capture (obs/profile.py), the JAX package's
# tests/test_introspection.py cases on the port, with torch.profiler

def _marker(path):
    with open(path) as f:
        return json.load(f)


def _torch_work():
    x = torch.randn(64, 64)
    for _ in range(5):
        x = x @ x / 64
    return x


def test_profile_scope_unavailable_is_contained(tmp_path, monkeypatch):
    """JEPSEN_NO_PROFILER forces the profiler unavailable, the body still
    runs, and the marker records why, with the JAX package's keys."""
    monkeypatch.setenv("JEPSEN_NO_PROFILER", "1")
    assert not obs_profile.available() and not jprofile.available()
    ran, keys = [], []
    for side, mod in (("torch", obs_profile), ("jax", jprofile)):
        pdir = str(tmp_path / side / "profile")
        with mod.scope({"profile?": True, "profile-dir": pdir}) as got:
            ran.append(got)
        marker = _marker(tmp_path / side / "profile.json")
        assert marker["status"] == "unavailable"
        keys.append(sorted(marker))
    assert ran == [None, None]
    assert keys[0] == keys[1]


def test_profile_scope_captures_the_cpu_activity(tmp_path):
    assert obs_profile.available()
    pdir = str(tmp_path / "prof" / "profile")
    with obs_profile.scope({"profile?": True, "profile-dir": pdir,
                            "profile-max-s": 30, "device": "cpu"}) as got:
        assert got == pdir
        started = _marker(tmp_path / "prof" / "profile.json")
        _torch_work()
    marker = _marker(tmp_path / "prof" / "profile.json")
    # the JAX package's start and stop keys, plus the trace's name and
    # the activities
    assert sorted(started) == ["dir", "max_s", "started", "status"]
    assert started["status"] == "capturing"
    assert sorted(marker) == ["activities", "dir", "files", "status",
                              "stopped_by", "trace", "wall_s"]
    assert marker["status"] == "done" and marker["activities"] == ["CPU"]
    assert marker["stopped_by"] == "scope-exit"
    trace = _marker(os.path.join(pdir, marker["trace"]))
    assert any(e.get("name") == "aten::mm"
               for e in trace["traceEvents"])


def test_profile_scope_never_raises_on_bad_dir():
    for mod in (obs_profile, jprofile):
        with mod.scope({"profile?": True,
                        "profile-dir": "/proc/definitely/not/writable/x"}):
            pass  # must not raise whatever the profiler did


def test_profile_max_s_stops_the_capture(tmp_path):
    """The bound takes effect at the scope boundary: the trace keeps
    only the events that began within it."""
    pdir = str(tmp_path / "prof" / "profile")
    with obs_profile.scope({"profile?": True, "profile-dir": pdir,
                            "profile-max-s": 0.2, "device": "cpu"}):
        _torch_work()
        time.sleep(0.5)
        _torch_work()
    marker = _marker(tmp_path / "prof" / "profile.json")
    assert marker["status"] == "done"
    assert marker["stopped_by"] == "max-s-bound"
    assert marker["events_dropped"] > 0
    ts = [e["ts"] for e in _marker(os.path.join(pdir, marker["trace"]))[
        "traceEvents"] if isinstance(e.get("ts"), (int, float))]
    assert max(ts) - min(ts) <= 0.2e6


def test_a_second_capture_is_refused(tmp_path):
    outer = str(tmp_path / "a" / "profile")
    inner = str(tmp_path / "b" / "profile")
    with obs_profile.scope({"profile?": True, "profile-dir": outer,
                            "device": "cpu"}):
        with obs_profile.scope({"profile?": True, "profile-dir": inner,
                                "device": "cpu"}) as got:
            assert got is None
    assert _marker(tmp_path / "b" / "profile.json")["status"] == "skipped"
    assert _marker(tmp_path / "a" / "profile.json")["status"] == "done"


def test_core_run_profile_writes_the_marker_and_the_trace(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    state = tst.Atom(None)
    t = tst.noop_test()
    t.update({"name": "profiled", "ssh": {"dummy?": True},
              "db": tst.atom_db(state), "client": tst.atom_client(state),
              "concurrency": 5, "profile?": True, "device": "cpu",
              "checker": checkers.linearizable(
                  {"model": "register", "algorithm": "jax-wgl",
                   # the atom db starts the register at 0
                   "init-ops": [{"f": "write", "value": 0}],
                   "engine_opts": {"device": "cpu"}}),
              "generator": gen.clients(gen.limit(6, gen.mix([
                  lambda: {"f": "read"},
                  lambda: {"f": "write", "value": 1}])))})
    done = core.run(t)
    assert done["results"]["valid"] is True
    marker = _marker(store.path(done, obs_profile.MARKER_FILE))
    assert marker["status"] == "done"
    assert marker["dir"] == store.path(done, obs_profile.PROFILE_DIR)
    trace = os.path.join(marker["dir"], marker["trace"])
    assert os.path.getsize(trace) > 0
    assert os.path.exists(store.path(done, "trace.jsonl"))
