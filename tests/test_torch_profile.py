"""The port's profile summaries (jepsen_tpu_torch/profile_main.py) on
hand-made events, and its shape bucket (jepsen_tpu_torch/util.py)
against the JAX package's (jepsen_tpu/campaign/compile_cache.py).
Tolerance: equality, or 1e-12 on sums of microseconds."""

import pytest

from jepsen_tpu.campaign import compile_cache
from jepsen_tpu_torch import util
from jepsen_tpu_torch.checker import torch_wgl
from jepsen_tpu_torch.profile_main import kernel_stats, split

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
