"""The port's streaming txn check core (jepsen_tpu_torch/monitor/txn.py
``TxnCheck``) against the JAX package's on the CPU: at chunks of 1, 8
and 64 events every chunk's verdict dict, the squaring passes it cost
and the frontier's rebuilds equal the JAX package's, over the taxonomy
fixtures of tests/test_txn_monitor.py and a serial history of more
than 64 txns (so the frontier squares with torch, not on the host).
Tolerance: equality."""

import pytest
import torch

from jepsen_tpu import cycle as jcycle
from jepsen_tpu.monitor import txn as jtxnmon
from jepsen_tpu_torch import cycle, simulate
from jepsen_tpu_torch.monitor import engine as mengine
from jepsen_tpu_torch.monitor.txn import TxnCheck

from test_txn_monitor import P, R, _fixtures


def _drive(hist, chunk, **kw):
    """Feed both cores in ``chunk``-event slices; every cut's result,
    pass cost and rebuild count must agree. Returns the final result
    and the port's core."""
    workload = kw.pop("workload", "append")
    core = TxnCheck(workload=workload, device="cpu", **kw)
    jcore = jtxnmon.TxnCheck(workload=workload, **kw)
    res = None
    for i, op in enumerate(hist):
        core.offer(op)
        jcore.offer(op)
        if (i + 1) % chunk == 0 or i == len(hist) - 1:
            p0, j0 = cycle.closure_passes(), jcycle.closure_passes()
            res = core.check()
            jres = jcore.check()
            assert res == jres, (i, chunk)
            assert cycle.closure_passes() - p0 \
                == jcycle.closure_passes() - j0, (i, chunk)
            assert core.frontier.rebuilds == jcore.frontier.rebuilds
            assert core.n_txns == jcore.n_txns
    return res, core


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_incremental_matches_jax_across_taxonomy(chunk):
    for name, hist, want_valid, want_class, kw in _fixtures():
        res, _ = _drive(hist, chunk, **dict(kw))
        assert res["valid"] is want_valid, (name, chunk)
        if want_class is not None:
            assert want_class in res["anomaly_types"], (name, chunk)


@pytest.mark.parametrize("chunk", [8, 64])
def test_large_serial_history_on_the_torch_frontier(chunk):
    """130 txns: the frontier rebuilds past 64 and 128 nodes and squares
    with torch; the injected G1c copy is caught and classified alike."""
    res, core = _drive(simulate.txn_append_history(130, 2), chunk)
    assert res["valid"] is True and core.frontier.n_pad == 256
    assert isinstance(core.frontier._r, torch.Tensor)
    res, _ = _drive(simulate.txn_append_history(130, 2, g1c=(80, 96)),
                    chunk)
    assert res["valid"] is False and "G1c" in res["anomaly_types"]


def test_garbage_read_and_skew_bound_match_jax():
    res, _ = _drive(P((0, 10, [R("x", [5])])), 1)
    assert res["valid"] == "unknown"
    hist = P((0, 10_000_000_000, [R("x", [2])]),
             (40_000_000_000, 50_000_000_000, [["append", "x", 2]]))
    res, _ = _drive(hist, 1, skew_bound=30_500_000_000)
    assert res["valid"] is True
    res, _ = _drive(hist, 8)
    assert res["valid"] is False


def test_wr_workload_and_offline_dispatch():
    hist = simulate.txn_wr_history(__import__("random").Random(2), 90, 8)
    res, core = _drive(hist, 16, workload="wr")
    assert res["valid"] is True
    off = mengine.check_txn_prefix(hist, "wr", core._opts())
    assert off["valid"] is True
    with pytest.raises(ValueError):
        TxnCheck(workload="nope", device="cpu")
