"""``python -m jepsen_tpu_torch.profile_main``'s rung 0 and ``--keys``
(the shapes of the JAX package's ``tools/profile_kernel.py``) on the
CPU: rung 0's history equals ``jepsen_tpu.simulate.random_history`` at
``profile_kernel.py``'s seed, here at a reduced op count; the argument
parsing of ``--rung`` and ``--keys``; the phase-plane split; and the
rung-0 row's plumbing at a small size, with the profiled window's
events marked as kernels (the CPU has none). Times here are CPU times
and are not checked."""

import random

import pytest
import torch

from jepsen_tpu import simulate as jsimulate
from jepsen_tpu_torch import profile_main


@pytest.mark.parametrize("n_ops", [200, 2_000])
def test_rung0_history_equals_the_jax_package_s(n_ops):
    want = jsimulate.random_history(random.Random(77000 + 80000),
                                    "cas-register", 64, n_ops, 0.05)
    assert profile_main.rung0_history(n_ops) == want
    assert profile_main.RUNG0["seed"] == 77000 + 80000
    assert (profile_main.RUNG0["n_ops"], profile_main.RUNG0["timeout_s"],
            profile_main.RUNG0["chunk_iters"]) == (80_000, 120, 32)


@pytest.mark.parametrize("argv,want", [
    ([], (False, None, 256)),
    (["--rung", "0"], (False, 0, 256)),
    (["--batch"], (True, None, 256)),
    (["--batch", "--keys", "64"], (True, None, 64)),
])
def test_parse_args(argv, want):
    a = profile_main.parse_args(argv)
    assert (a.batch, a.rung, a.keys) == want


@pytest.mark.parametrize("argv", [
    ["--rung", "2"], ["--rung", "0", "--batch"], ["--keys", "64"],
    ["--batch", "--keys", "0"], ["--rung", "0", "--keys", "8"]])
def test_parse_args_refuses(argv):
    with pytest.raises(SystemExit) as e:
        profile_main.parse_args(argv)
    assert e.value.code == 2


def test_batch_pairs_are_profile_kernel_s_keys():
    """``--keys K`` of at most 32 gives ``tools/profile_kernel.py``'s rung
    2 batch of K keys: drawn from ``random.Random(45100)``, every 8th
    corrupted."""
    from jepsen_tpu.models import cas_register_spec
    rng = random.Random(45100)
    want = []
    for k in range(16):
        h = jsimulate.random_history(rng, "cas-register", n_procs=8,
                                     n_ops=200, crash_p=0.02)
        want.append(cas_register_spec.encode(
            jsimulate.corrupt(rng, h) if k % 8 == 7 else h))
    _spec, pairs = profile_main.batch_pairs(16)
    assert len(pairs) == 16
    for (e, st), (je, jst) in zip(pairs, want):
        assert e.f.tolist() == je.f.tolist() and st == jst
        assert e.args.tolist() == je.args.tolist()
        assert e.ret.tolist() == je.ret.tolist()


def test_lap_split():
    ev = [{"cat": "phase", "name": f"wgl.phase.{n}", "ts": t, "dur": d}
          for n, t, d in (("encode", 0, 10), ("plan", 10, 5),
                          ("h2d", 15, 5), ("device", 20, 100),
                          ("host", 120, 3), ("device", 123, 50),
                          ("d2h", 173, 7), ("host", 180, 40))]
    ev.append({"cat": "op", "name": "read", "ts": 0, "dur": 1000})
    assert profile_main.lap_split(ev) == {
        "host_before_search_s": 20e-6, "search_s": 153e-6,
        "host_after_search_s": 47e-6}


def test_rung0_row_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    real = profile_main.profile_call

    def as_kernels(fn, host_ops=True):
        out, wall, ev = real(fn, host_ops)
        return out, wall, [(a, b, n, True) for a, b, n, _k in ev]

    monkeypatch.setattr(profile_main, "profile_call", as_kernels)
    row = profile_main.profile_rung0(n_ops=400, timeout_s=30, window_s=0.1,
                                     device="cpu")
    assert row["n_ops"] == 400 and row["valid"] is True
    assert row["n_padded"] == 512 and not row["timed_out"]
    assert row["peak_bytes"] is None and row["predicted_bytes"] > 0
    assert row["search_s"] > 0 and row["host_before_search_s"] > 0
    w = row["profiled_window"]
    assert w["chunks"] >= 1 and w["valid"] in (True, "unknown")
    assert "rollout_share_of_busy" in w
