"""Mutex model (knossos.model/mutex): acquire valid iff unlocked, release
valid iff locked. BASELINE.json config 3 (high-contention lock histories)."""

from __future__ import annotations

import numpy as np

from .base import Model, ModelSpec, inconsistent, register_model

F_ACQUIRE, F_RELEASE = 0, 1


class Mutex(Model):
    def __init__(self, locked=False):
        self.locked = locked

    def step(self, op):
        f = op["f"]
        if f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire held mutex")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("cannot release free mutex")
            return Mutex(False)
        raise ValueError(f"mutex: unknown f {f!r}")

    def __eq__(self, other):
        return isinstance(other, Mutex) and self.locked == other.locked

    def __hash__(self):
        return hash(("mutex", self.locked))

    def __repr__(self):
        return f"Mutex({self.locked})"


def _mutex_step(state, f, args, ret, xp):
    locked = state[0]
    is_acq = f == F_ACQUIRE
    ok = xp.where(is_acq, locked == 0, locked == 1)
    new_state = xp.stack([xp.astype(xp.where(is_acq, 1, 0), state.dtype)])
    return new_state, ok


def _mutex_encode(spec, intern, f, value, ret_value):
    return spec.f_codes[f], [], []


mutex_spec = register_model(ModelSpec(
    name="mutex",
    f_codes={"acquire": F_ACQUIRE, "release": F_RELEASE},
    arg_width=1,
    state_size=lambda e: 1,
    init_state=lambda e, s: np.zeros(1, np.int32),
    decode_state=lambda st: {"locked": bool(st[0])},
    step=_mutex_step,
    make_oracle=Mutex,
    encode_op=_mutex_encode,
))
