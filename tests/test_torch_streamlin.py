"""The port's streaming frontier fold (jepsen_tpu_torch/checker/streamlin.py)
against the JAX package's (jepsen_tpu/checker/streamlin.py) on the CPU:
the same seeded histories, folded after 1, several and all events, give
equal carry arrays (lin, st, live, open_w) and equal scalars (status,
viol, passes, steps, n_live), solo (K=1) and lane-batched (K=4 with an
inert pad lane, and mixed shapes regrouped); overflow (status 2), frontier
growth and the offline face agree too. Tolerance: equality."""

import random

import numpy as np
import pytest

from jepsen_tpu import models as jm
from jepsen_tpu import simulate as jsim
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.checker import streamlin as jstreamlin
from jepsen_tpu.history import INF_TIME
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import linear, streamlin

MODELS = ["register", "cas-register", "mutex"]
SCALARS = ("status", "viol_slot", "passes", "steps", "n_live")


def _history(name, seed, corrupt, n_ops=40, procs=5):
    """A seeded history with overlapping ops (several processes, some
    crashed), corrupted on request."""
    rng = random.Random(seed)
    hist = jsim.random_history(rng, name, procs, n_ops, 0.05)
    return jsim.corrupt(rng, hist) if corrupt else hist


def _arrays(name, hist, F=64, upto=None):
    """The whole-history fold job of ``streamlin.check_encoded`` (events
    past ``upto`` zeroed: a fold of the first ``upto`` events). Returns
    (numpy arrays, C, event count)."""
    e, init = jm.model_spec(name).encode(hist)
    n = len(e)
    A = jm.model_spec(name).arg_width
    NW = max(64, 1 << (n - 1).bit_length())
    B = NW // 32
    events = sorted(
        [(int(e.invoke_idx[i]), 1, i) for i in range(n)]
        + [(int(e.return_idx[i]), 2, i) for i in range(n)
           if e.return_idx[i] < INF_TIME])
    c = c_max = 0
    for _t, kind, _i in events:
        c += 1 if kind == 1 else -1
        c_max = max(c_max, c)
    C = min(NW, max(8, 1 << (max(1, c_max) - 1).bit_length()))
    E = max(64, 1 << (len(events) - 1).bit_length())
    kinds = np.zeros(E, np.int32)
    slots = np.zeros(E, np.int32)
    for k, (_t, kind, i) in enumerate(events[:upto]):
        kinds[k], slots[k] = kind, i
    lin, st, live, open_w = jstreamlin.fresh_frontier(F, B, len(init),
                                                      init)
    w_f = np.zeros(NW, np.int32)
    w_args = np.zeros((NW, A), np.int32)
    w_ret = np.zeros((NW, A), np.int32)
    w_f[:n] = e.f
    w_args[:n] = np.asarray(e.args, np.int32).reshape(n, A)
    w_ret[:n] = np.asarray(e.ret, np.int32).reshape(n, A)
    clear = np.zeros(B, np.uint32)
    clear[0] = 0x5
    return ({"lin": lin, "st": st, "live": live, "open_w": open_w,
             "ev_kind": kinds, "ev_slot": slots, "w_f": w_f,
             "w_args": w_args, "w_ret": w_ret, "clear_w": clear},
            C, len(events))


def _jobs(name, arrays, C, n_ev):
    return (jstreamlin.FoldJob(jm.model_spec(name), C, arrays, n_ev),
            streamlin.FoldJob(tm.model_spec(name), C, arrays, n_ev,
                              device="cpu"))


def _same(got, want):
    for k in SCALARS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert np.array_equal(got["lin"].numpy().view(np.uint32),
                          np.asarray(want["lin"]))
    assert np.array_equal(got["open_w"].numpy().view(np.uint32),
                          np.asarray(want["open_w"]))
    for k in ("st", "live"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_fold_matches_jax_after_1_several_and_all_events(name, corrupt):
    multi_pass = False
    for seed in range(3):
        hist = _history(name, seed, corrupt)
        n_ev = _arrays(name, hist)[2]
        for upto in (1, 7, n_ev // 2, None):
            arrays, C, n = _arrays(name, hist, upto=upto)
            jj, tj = _jobs(name, arrays, C, n)
            want = jstreamlin.solo_fold(jj)
            got = streamlin.solo_fold(tj)
            _same(got, want)
            returns = int((arrays["ev_kind"] == 2).sum())
            multi_pass |= got["passes"] > returns
    assert multi_pass, "no return needed more than one closure pass"


def test_fold_decides_invalid_keys():
    """The corrupted histories above include violations (status 1)."""
    statuses = set()
    for seed in range(3):
        arrays, C, n = _arrays("cas-register",
                               _history("cas-register", seed, True))
        statuses.add(streamlin.solo_fold(
            _jobs("cas-register", arrays, C, n)[1])["status"])
    assert 1 in statuses


def test_batch_fold_k4_with_inert_pad_lane():
    """Three streams of one shape ride one fold at K=4 (a pad lane);
    each lane equals the JAX batch's and its own solo fold."""
    name = "cas-register"
    jobs = []
    for seed, corrupt in ((0, False), (1, True), (2, False)):
        arrays, C, n = _arrays(name, _history(name, seed, corrupt))
        jobs.append((arrays, n))
    C = 8
    jj = [jstreamlin.FoldJob(jm.cas_register_spec, C, a, n)
          for a, n in jobs]
    tj = [streamlin.FoldJob(tm.cas_register_spec, C, a, n, device="cpu")
          for a, n in jobs]
    want = jstreamlin.batch_fold(jj)
    got = streamlin.batch_fold(tj)
    for g, w, job in zip(got, want, tj):
        assert g["batch"] == w["batch"] == 3
        _same(g, w)
        _same(streamlin.solo_fold(job), w)


def test_batch_fold_mixed_shapes_regroup():
    """Members whose frontiers differ in F regroup by full shape; the
    lone member folds solo."""
    name = "register"
    specs = ((0, False, 64), (1, True, 128), (2, False, 64))
    jj, tj = [], []
    for seed, corrupt, F in specs:
        arrays, _C, n = _arrays(name, _history(name, seed, corrupt), F=F)
        j, t = _jobs(name, arrays, 8, n)
        jj.append(j)
        tj.append(t)
    want = jstreamlin.batch_fold(jj)
    got = streamlin.batch_fold(tj)
    assert [g["batch"] for g in got] == [w["batch"] for w in want] \
        == [2, 1, 2]
    for g, w in zip(got, want):
        _same(g, w)


def test_overflow_and_frontier_growth_match_jax():
    """A frontier of 1 config overflows (status 2) on overlapping
    writes; check_encoded grows F until the cap, and its result
    (configs explored over every attempt, the cap reached) equals the
    JAX package's."""
    name = "cas-register"
    hist = _history(name, 4, False, n_ops=60, procs=6)
    arrays, C, n = _arrays(name, hist, F=1)
    jj, tj = _jobs(name, arrays, C, n)
    want = jstreamlin.solo_fold(jj)
    got = streamlin.solo_fold(tj)
    assert got["status"] == 2
    _same(got, want)
    e, st = jm.cas_register_spec.encode(hist)
    te, tst = tm.cas_register_spec.encode(hist)
    for cap in (1, 2, 64, 4096):
        w = jstreamlin.check_encoded(jm.cas_register_spec, e, st,
                                     max_configs=cap)
        g = streamlin.check_encoded(tm.cas_register_spec, te, tst,
                                    max_configs=cap, device="cpu")
        assert g == w, cap


@pytest.mark.parametrize("name", MODELS)
def test_check_encoded_matches_jax_and_linear(name):
    for seed in range(4):
        hist = _history(name, seed, seed % 2 == 1)
        e, st = jm.model_spec(name).encode(hist)
        te, tst = tm.model_spec(name).encode(hist)
        want = jstreamlin.check_encoded(jm.model_spec(name), e, st)
        got = streamlin.check_encoded(tm.model_spec(name), te, tst,
                                      device="cpu")
        assert got == want, seed
        lin = linear.check_encoded(tm.model_spec(name), te, tst)
        assert lin == jlinear.check_encoded(jm.model_spec(name), e, st)
        assert got["valid"] == lin["valid"]
        if got["valid"] is False:
            # the fold names the op whose return emptied the frontier,
            # the sweep's witness the deepest config's: as in the JAX
            # package's test, they agree on the op's f
            assert got["op"]["f"] == lin["op"]["f"]


def test_entry_points_default_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hist = _history("register", 0, False)
    te, tst = tm.register_spec.encode(hist)
    with pytest.raises(RuntimeError, match="CUDA"):
        streamlin.check_encoded(tm.register_spec, te, tst)


def test_reference_fingerprint_blind_spot():
    """The reference's fingerprint multipliers are even at odd word
    indices, so configs that differ only in slot 62 (word 1, bit 30)
    get equal fingerprints and the reference drops one; the port's
    second, odd pair tells them apart. On a 141-op batch key (crashed
    ops leave several writes open) the JAX offline face therefore
    reports a violation that the CPU sweep does not, while the port's
    fold decides valid, as the sweep does (ROADMAP.md C)."""
    import torch
    from jepsen_tpu_torch import simulate as tsim
    cols = streamlin._fingerprint_cols(3, "cpu")
    lin = torch.zeros((1, 2, 2), dtype=torch.int32)
    lin[0, 1, 1] = 1 << 30
    st = torch.zeros((1, 2, 1), dtype=torch.int32)
    h = [x[0].tolist() for x in streamlin._fingerprints(lin, st, cols)]
    assert h[0][0] == h[0][1] and h[1][0] == h[1][1]
    assert h[2][0] != h[2][1] and h[3][0] != h[3][1]
    hist = tsim.bench_histories(4)[0][3]
    e, st0 = jm.cas_register_spec.encode(hist)
    te, tst = tm.cas_register_spec.encode(hist)
    assert jstreamlin.check_encoded(jm.cas_register_spec, e, st0)[
        "valid"] is False
    assert linear.check_encoded(tm.cas_register_spec, te, tst)[
        "valid"] is True
    assert streamlin.check_encoded(tm.cas_register_spec, te, tst,
                                   device="cpu")["valid"] is True
