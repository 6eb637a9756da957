"""The port's models (jepsen_tpu_torch/models) against the JAX package's:
identical encodings of seeded histories, and the port's steps batched
under torch equal the JAX package's steps under numpy, one configuration
at a time, on random (state, f, args, ret) with NIL. Tolerance: equality
(all integers)."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu import simulate as jsim
from jepsen_tpu.history import NIL
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import simulate as tsim
from jepsen_tpu_torch.xp import NP, TORCH

SPECS = ["register", "cas-register", "mutex"]


def _multi_history(rng, n_ops, keys=("x", "y", "z")):
    """A random multi-register history (maps of key -> value, with info
    and fail completions)."""
    hist = []
    for i in range(n_ops):
        p = i % 4
        if rng.random() < 0.5:
            v = {k: rng.randrange(3) for k in rng.sample(keys, 2)}
            f = "write"
        else:
            v, f = None, "read"
        hist.append({"type": "invoke", "process": p, "f": f, "value": v})
        kind = rng.choice(["ok", "ok", "ok", "info", "fail"])
        if f == "read" and kind == "ok":
            v = {k: rng.choice([None, 0, 1, 2]) for k in keys}
        hist.append({"type": kind, "process": p, "f": f, "value": v})
    return jh.index(hist)


def _encodings_equal(a, b):
    (ea, sa), (eb, sb) = a, b
    for name in ("invoke_idx", "return_idx", "f", "args", "ret", "is_ok",
                 "process"):
        x, y = getattr(ea, name), getattr(eb, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert np.array_equal(sa, sb) and sa.dtype == sb.dtype
    assert len(ea.ops) == len(eb.ops)


@pytest.mark.parametrize("name", SPECS)
def test_encode_identical(name):
    rng_a, rng_b = random.Random(45100), random.Random(45100)
    for trial in range(4):
        ha = jsim.random_history(rng_a, name, 5, 60, 0.1)
        hb = tsim.random_history(rng_b, name, 5, 60, 0.1)
        if trial % 2:
            ha, hb = jsim.corrupt(rng_a, ha), tsim.corrupt(rng_b, hb)
        assert ha == hb            # the copied simulator draws the same
        _encodings_equal(jm.model_spec(name).encode(ha),
                         tm.model_spec(name).encode(hb))


def test_encode_identical_multi_register():
    hist = _multi_history(random.Random(7), 40)
    _encodings_equal(jm.multi_register_spec(["x", "y", "z"]).encode(hist),
                     tm.multi_register_spec(["x", "y", "z"]).encode(hist))


def _random_inputs(rng, n, S, A, n_f):
    vals = np.array([NIL, 0, 1, 2, 3], np.int32)
    return (vals[rng.randint(0, 5, size=(n, S))],
            rng.randint(0, n_f, size=n).astype(np.int32),
            vals[rng.randint(0, 5, size=(n, A))],
            vals[rng.randint(0, 5, size=(n, A))])


@pytest.mark.parametrize("name", SPECS + ["multi-register"])
def test_steps_torch_batched_equal_numpy(name):
    if name == "multi-register":
        ja = jm.multi_register_spec(["x", "y", "z"])
        ta = tm.multi_register_spec(["x", "y", "z"])
        S = A = 3
    else:
        ja, ta = jm.model_spec(name), tm.model_spec(name)
        S, A = 1, ja.arg_width
    st, f, a, r = _random_inputs(np.random.RandomState(len(name)), 600,
                                 S, A, len(ja.f_codes))
    want = [ja.step(st[i], f[i], a[i], r[i], np) for i in range(len(f))]
    # component first: state (S, N), f (N,), args/ret (A, N)
    st2, ok = ta.step(torch.from_numpy(st.T.copy()), torch.from_numpy(f),
                      torch.from_numpy(a.T.copy()),
                      torch.from_numpy(r.T.copy()), TORCH)
    st2 = torch.broadcast_to(st2, (S, len(f))).to(torch.int32).numpy()
    ok = torch.broadcast_to(ok, (len(f),)).numpy()
    for i, (ws, wok) in enumerate(want):
        assert bool(ok[i]) == bool(wok), i
        if wok:
            assert np.array_equal(st2[:, i], np.asarray(ws, np.int32)), i
    # and the host face agrees one configuration at a time
    for i in range(0, len(f), 7):
        s_np, ok_np = ta.step(st[i], f[i], a[i], r[i], NP)
        assert bool(ok_np) == bool(want[i][1])
        assert np.array_equal(np.asarray(s_np, np.int32),
                              np.asarray(want[i][0], np.int32))


def test_oracles_match():
    for name in SPECS:
        ja, ta = jm.model_spec(name), tm.model_spec(name)
        ops = ([{"f": "write", "value": 1}, {"f": "read", "value": 1},
                {"f": "read", "value": 2}]
               if name != "mutex" else
               [{"f": "acquire"}, {"f": "acquire"}, {"f": "release"}])
        a, b = ja.make_oracle(), ta.make_oracle()
        for op in ops:
            a2, b2 = a.step(op), b.step(op)
            assert jm.is_inconsistent(a2) == tm.is_inconsistent(b2)
            if not tm.is_inconsistent(b2):
                a, b = a2, b2
        assert repr(a) == repr(b)


def test_queue_models_wait_for_a_later_slice():
    for name in ("fifo-queue", "unordered-queue"):
        with pytest.raises(KeyError, match="ROADMAP"):
            tm.model_spec(name)
    with pytest.raises(KeyError, match="queue models"):
        tm.fifo_queue(1, 2)
