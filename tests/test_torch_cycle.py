"""The port's txn cycle engine (jepsen_tpu_torch/cycle) against the JAX
package's (jepsen_tpu/cycle) on the CPU: closures, ``IncrementalClosure``
pass and rebuild counts and ``batch_closure_probe`` on random graphs of
65-512 nodes (so the torch squaring path, not the host path of n <= 64,
runs), and ``append``/``wr`` results -- validity, anomaly classes, cycle
witnesses -- on the golden histories of tests/test_cycle.py and on
seeded histories of more than 64 txns. Tolerance: equality."""

import random

import numpy as np
import pytest

from jepsen_tpu import cycle as jcycle
from jepsen_tpu import txn as jtxn
from jepsen_tpu.cycle import append as jap
from jepsen_tpu.cycle import wr as jwr
from jepsen_tpu_torch import cycle, simulate, txn
from jepsen_tpu_torch.cycle import append as ap
from jepsen_tpu_torch.cycle import wr

from test_cycle import H, P

A = lambda k, v: ["append", k, v]    # noqa: E731 - fixture shorthand
R = lambda k, v: ["r", k, v]         # noqa: E731


def _graph(n, seed, p=None):
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < (p if p is not None else 2.0 / n)
    np.fill_diagonal(adj, False)
    return adj


def _passes(fn):
    """(result, port passes, JAX passes) of ``fn`` (which runs both)."""
    p0, j0 = cycle.closure_passes(), jcycle.closure_passes()
    out = fn()
    return out, cycle.closure_passes() - p0, jcycle.closure_passes() - j0


@pytest.mark.parametrize("n", [65, 100, 200, 512])
def test_transitive_closure_matches_jax(n):
    for seed in range(2):
        adj = _graph(n, seed)
        (got, want), p, jp = _passes(lambda: (
            cycle.transitive_closure(adj, device="cpu"),
            jcycle.transitive_closure(adj)))
        assert got.dtype == want.dtype == bool
        assert np.array_equal(got, want) and p == jp > 0


def test_incremental_closure_matches_jax():
    """Growing graphs fold in chunk by chunk: every closure, each
    update's passes and the rebuilds (64 -> 128 -> 256 -> 512) equal."""
    full = _graph(300, 7, p=0.006)
    full |= np.triu(_graph(300, 8, p=0.01), 1)
    inc = cycle.IncrementalClosure(device="cpu")
    jinc = jcycle.IncrementalClosure()
    for n in (10, 40, 70, 90, 130, 200, 257, 300):
        adj = full[:n, :n]
        _, p, jp = _passes(lambda: (inc.update(adj), jinc.update(adj)))
        assert p == jp, n
        assert np.array_equal(inc.closure(), jinc.closure()), n
        assert inc.has_cycle() == jinc.has_cycle()
        assert inc.rebuilds == jinc.rebuilds and inc.n_pad == jinc.n_pad
    assert inc.rebuilds == 4 and inc.has_cycle()


def test_batch_closure_probe_matches_jax():
    adjs = [_graph(n, n) for n in (70, 90, 130, 200)]
    adjs.append(np.triu(_graph(150, 3, p=0.05), 1))      # a DAG
    (got, want), p, jp = _passes(lambda: (
        cycle.batch_closure_probe(adjs, device="cpu"),
        jcycle.batch_closure_probe(adjs)))
    assert got == want and p == jp > 0
    assert got[-1] is False and True in got


def test_txn_helpers_match_jax():
    t = [["r", "x", 1], ["w", "x", 2], ["w", "x", 3], ["r", "y", 0]]
    for f in ("ext_reads", "ext_writes", "int_write_mops"):
        assert getattr(txn, f)(t) == getattr(jtxn, f)(t)


def _append_cases():
    return {
        "valid-serial": H([A("x", 1)], [R("x", [1]), A("x", 2)],
                          [R("x", [1, 2])]),
        "G0": H([A("x", 1), A("y", 1)], [A("x", 2), A("y", 2)],
                [R("x", [1, 2]), R("y", [2, 1])]),
        "G1c": H([R("y", [1]), A("x", 1)], [R("x", [1]), A("y", 1)]),
        "G-single": H([A("x", 1), A("y", 1)], [R("x", []), R("y", [1])],
                      [R("x", [1])]),
        "G2": H([R("x", []), A("y", 1)], [R("y", []), A("x", 1)],
                [R("x", [1]), R("y", [1])]),
        "G1a": H(("fail", [A("x", 9)]), [R("x", [9])]),
        "G1b": H([A("x", 1), A("x", 2)], [R("x", [1])]),
        "incompatible-order": H([R("x", [1, 2])], [R("x", [2, 1])],
                                [A("x", 1)], [A("x", 2)]),
        "midorder-conflict": H([A("x", 1), A("x", 2)], [A("x", 3)],
                               [R("x", [1, 3])]),
        "duplicates": H([A("x", 1)], [R("x", [1, 1])]),
        "garbage": H([R("x", [5])]),
        "info-append": H(("info", [A("x", 1)]), [R("x", [1])]),
        "cyclic-versions": H([A("x", 1), A("x", 2), A("x", 1)]),
        "G1c-realtime": P((0, 10, [R("x", [2])]), (20, 30, [A("x", 2)])),
        "G0-realtime": P((0, 10, [A("x", 1)]), (20, 30, [A("x", 2)]),
                         (40, 50, [R("x", [2, 1])])),
        "G-single-realtime": P((0, 10, [A("x", 1)]),
                               (20, 30, [A("x", 2)]),
                               (40, 50, [R("x", [1])]),
                               (60, 70, [R("x", [1, 2])])),
        "G2-realtime": P((0, 100, [R("z", []), A("y", 1)]),
                         (90, 200, [R("y", []), A("x", 1)]),
                         (150, 160, [R("x", [])]),
                         (300, 310, [R("x", [1]), R("y", [1])])),
        "serial-100": simulate.txn_append_history(100, 3),
        "g1c-100": simulate.txn_append_history(100, 3, g1c=(16, 40)),
    }


APPEND_OPTS = [None, {"realtime": False},
               {"anomalies": list(jap.DEFAULT_ANOMALIES)
                + ["G-single-process", "G2-process", "G0-process",
                   "G1c-process"]}]


@pytest.mark.parametrize("name", sorted(_append_cases()))
def test_append_check_matches_jax(name):
    hist = _append_cases()[name]
    for opts in APPEND_OPTS:
        want = jap.check(hist, opts)
        got = ap.check(hist, opts, device="cpu")
        assert got == want, (name, opts)
    if name.startswith(("G", "g1c")):
        assert got["valid"] is False


def test_append_process_class_matches_jax():
    hist = H([A("x", 1)], [R("x", [1])], [R("x", [])])
    hist[0]["process"] = hist[2]["process"] = 1
    for anomalies in (jap.DEFAULT_ANOMALIES,
                      ("G-single-process", "G2-process")):
        want = jap.analyze(hist, anomalies=anomalies)
        assert ap.analyze(hist, anomalies=anomalies, device="cpu") == want
    assert want["anomaly_types"] == ["G-single-process"]


def _wr_cases():
    seq = H([A("x", 1)], [A("x", 2)], [R("x", 1)], [R("x", 2)],
            [R("x", 2)], [R("x", 1)])
    seq = [dict(o, value=[["w" if m[0] == "append" else "r", m[1], m[2]]
                          for m in o["value"]]) for o in seq]
    seq[2]["process"] = seq[3]["process"] = 4
    seq[4]["process"] = seq[5]["process"] = 5
    return {
        "G1c": (H([["r", "y", 1], ["w", "x", 1]],
                  [["r", "x", 1], ["w", "y", 1]]), None),
        "G1a": (H(("fail", [["w", "x", 5]]), [["r", "x", 5]]), None),
        "G1b": (H([["w", "x", 1], ["w", "x", 2]], [["r", "x", 1]]), None),
        "linearizable-keys-G-single": (
            H([["w", "x", 1]], [["w", "y", 2], ["w", "x", 2]],
              [["r", "y", 2], ["r", "x", 1]]), {"linearizable_keys": True}),
        "sequential-keys": (seq, {"sequential_keys": True}),
        "lost-update": (P((0, 10, [["w", "x", 1]]),
                          (20, 30, [["r", "x", 1], ["w", "x", 2]]),
                          (20, 31, [["r", "x", 1], ["w", "x", 3]])), None),
        "internal": (P((0, 10, [["w", "x", 1], ["r", "x", 2]]),), None),
        "G1c-realtime": (P((0, 10, [["r", "x", 2]]),
                           (20, 30, [["w", "x", 2]])), None),
        "dirty-update": ([
            {"type": "fail", "f": "txn", "process": 1, "time": 10,
             "index": 0, "value": [["w", "x", 1]]},
            {"type": "ok", "f": "txn", "process": 2, "time": 30,
             "index": 1, "value": [["r", "x", 1], ["w", "x", 2]]}], None),
        "garbage": (H([["r", "x", 99]]), None),
        "serial-120": (simulate.txn_wr_history(random.Random(3), 120, 16),
                       None),
    }


@pytest.mark.parametrize("name", sorted(_wr_cases()))
def test_wr_check_matches_jax(name):
    hist, opts = _wr_cases()[name]
    want = jwr.check(hist, opts)
    got = wr.check(hist, opts, device="cpu")
    assert got == want, name
    if name.startswith(("G", "lost", "internal", "dirty", "linear",
                        "sequential")):
        assert got["valid"] is False
    if name.startswith("serial"):
        assert got["valid"] is True


def test_check_graph_on_a_large_graph_matches_jax():
    """check_graph with every class requested on a 200-node random
    graph of all five edge types (torch closures throughout)."""
    rng = np.random.default_rng(5)
    g, jg = cycle.Graph(200), jcycle.Graph(200)
    for _ in range(500):
        i, j = (int(x) for x in rng.integers(0, 200, 2))
        kind = int(rng.choice([cycle.WW, cycle.WR, cycle.RW, cycle.RT,
                               cycle.PROC]))
        g.add(i, j, kind, f"e{i}-{j}")
        jg.add(i, j, kind, f"e{i}-{j}")
    ops = [{"index": i} for i in range(200)]
    anomalies = cycle.DEFAULT_ANOMALIES + cycle.PROCESS_ANOMALIES
    got = cycle.check_graph(g, ops, anomalies, device="cpu")
    want = jcycle.check_graph(jg, ops, anomalies)
    assert got == want and got["valid"] is False


def test_closure_defaults_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cycle.transitive_closure(_graph(100, 0))
    # graphs of at most 64 nodes close on the host, as in the JAX package
    small = _graph(40, 0)
    assert np.array_equal(cycle.transitive_closure(small),
                          jcycle.transitive_closure(small))
