"""Register-family models: register, cas-register, multi-register.

Oracle semantics follow knossos.model (consumed by the reference at
checker.clj:233-234 and tests/linearizable_register.clj:37):

* register: write sets the value; read is consistent iff its value is nil
  (unknown) or equals the current value.
* cas-register: adds ``cas [old new]`` which applies iff current == old.
* multi-register: one value-map per op, reads/writes applied atomically.
"""

from __future__ import annotations

import numpy as np

from ..history import NIL
from .base import (Model, ModelSpec, inconsistent, register_model)

F_READ, F_WRITE, F_CAS = 0, 1, 2


# -- oracles -----------------------------------------------------------------

class Register(Model):
    def __init__(self, value=None):
        self.value = value

    def step(self, op):
        f, v = op["f"], op.get("value")
        if f == "write":
            return Register(v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"read {v!r}, expected {self.value!r}")
        raise ValueError(f"register: unknown f {f!r}")

    def __eq__(self, other):
        return isinstance(other, Register) and self.value == other.value

    def __hash__(self):
        return hash(("register", self.value))

    def __repr__(self):
        return f"Register({self.value!r})"


class CASRegister(Model):
    def __init__(self, value=None):
        self.value = value

    def step(self, op):
        f, v = op["f"], op.get("value")
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            old, new = v
            if old == self.value:
                return CASRegister(new)
            return inconsistent(f"cas {old!r}->{new!r} on {self.value!r}")
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"read {v!r}, expected {self.value!r}")
        raise ValueError(f"cas-register: unknown f {f!r}")

    def __eq__(self, other):
        return isinstance(other, CASRegister) and self.value == other.value

    def __hash__(self):
        return hash(("cas-register", self.value))

    def __repr__(self):
        return f"CASRegister({self.value!r})"


class MultiRegister(Model):
    """Value maps: {:f :read, :value {k v ...}} applies all reads/writes
    atomically (knossos.model/multi-register)."""

    def __init__(self, values=None):
        self.values = dict(values or {})

    def step(self, op):
        f, v = op["f"], op.get("value")
        if f == "write":
            nv = dict(self.values)
            nv.update(v)
            return MultiRegister(nv)
        if f == "read":
            for k, x in (v or {}).items():
                if x is not None and self.values.get(k) != x:
                    return inconsistent(
                        f"read {k}={x!r}, expected {self.values.get(k)!r}")
            return self
        raise ValueError(f"multi-register: unknown f {f!r}")

    def __eq__(self, other):
        return isinstance(other, MultiRegister) and self.values == other.values

    def __hash__(self):
        return hash(("multi-register", tuple(sorted(self.values.items()))))

    def __repr__(self):
        return f"MultiRegister({self.values!r})"


# -- tensor specs ------------------------------------------------------------

def _register_step(state, f, args, ret, xp):
    v = state[0]
    is_write = f == F_WRITE
    new_v = xp.where(is_write, args[0], v)
    read_ok = (ret[0] == NIL) | (ret[0] == v)
    ok = is_write | read_ok
    return xp.stack([new_v]), ok


def _register_encode(spec, intern, f, value, ret_value):
    if f == "write":
        return F_WRITE, [intern.encode(value)], []
    if f == "read":
        # after history/complete, reads may carry their value in the invoke
        rv = ret_value if ret_value is not None else value
        return F_READ, [], [intern.encode(rv)]
    raise ValueError(f"register: unknown f {f!r}")


def _reg_decode(st):
    return {"value": None if int(st[0]) == NIL else int(st[0])}


register_spec = register_model(ModelSpec(
    name="register",
    f_codes={"read": F_READ, "write": F_WRITE},
    arg_width=1,
    state_size=lambda e: 1,
    init_state=lambda e, s: np.full(1, NIL, np.int32),
    step=_register_step,
    make_oracle=Register,
    encode_op=_register_encode,
    decode_state=_reg_decode,
    pure_fs=frozenset({"read"}),
    seal_fs=frozenset({"write"}),
))


def _cas_step(state, f, args, ret, xp):
    v = state[0]
    is_write = f == F_WRITE
    is_cas = f == F_CAS
    is_read = f == F_READ
    cas_ok = v == args[0]
    new_v = xp.where(is_write, args[0],
                     xp.where(is_cas & cas_ok, args[1], v))
    read_ok = (ret[0] == NIL) | (ret[0] == v)
    ok = (is_write | (is_cas & cas_ok) | (is_read & read_ok))
    return xp.stack([new_v]), ok


def _cas_encode(spec, intern, f, value, ret_value):
    if f == "write":
        return F_WRITE, [intern.encode(value)], []
    if f == "cas":
        old, new = value
        return F_CAS, [intern.encode(old), intern.encode(new)], []
    if f == "read":
        rv = ret_value if ret_value is not None else value
        return F_READ, [], [intern.encode(rv)]
    raise ValueError(f"cas-register: unknown f {f!r}")


cas_register_spec = register_model(ModelSpec(
    name="cas-register",
    f_codes={"read": F_READ, "write": F_WRITE, "cas": F_CAS},
    arg_width=2,
    state_size=lambda e: 1,
    init_state=lambda e, s: np.full(1, NIL, np.int32),
    step=_cas_step,
    make_oracle=CASRegister,
    encode_op=_cas_encode,
    decode_state=_reg_decode,
    # cas is state-oblivious when it succeeds but NOT total (it fails
    # from a mismatched state), so only write seals a quiescent cut
    pure_fs=frozenset({"read"}),
    seal_fs=frozenset({"write"}),
))


def _multi_step(state, f, args, ret, xp):
    is_write = f == F_WRITE
    new_state = xp.where(is_write & (args != NIL), args, state)
    read_ok = xp.all((ret == NIL) | (ret == state))
    ok = is_write | read_ok
    return new_state, ok


def multi_register_spec(keys):
    """Build a ModelSpec over a fixed, ordered set of register keys."""
    keys = list(keys)
    k_index = {k: i for i, k in enumerate(keys)}
    K = len(keys)

    def encode(spec, intern, f, value, ret_value):
        vec = [NIL] * K
        if f == "write":
            for k, v in (value or {}).items():
                vec[k_index[k]] = intern.encode(v)
            return F_WRITE, vec, []
        if f == "read":
            rv = ret_value if ret_value is not None else value
            for k, v in (rv or {}).items():
                vec[k_index[k]] = intern.encode(v)
            return F_READ, [], vec
        raise ValueError(f"multi-register: unknown f {f!r}")

    return ModelSpec(
        name=f"multi-register-{K}",
        f_codes={"read": F_READ, "write": F_WRITE},
        arg_width=K,
        state_size=lambda e: K,
        init_state=lambda e, s: np.full(K, NIL, np.int32),
        step=_multi_step,
        make_oracle=MultiRegister,
        encode_op=encode,
        decode_state=lambda st: {
            "values": {k: (None if int(st[i]) == NIL else int(st[i]))
                       for k, i in k_index.items()}},
        # a multi-register write only touches the keys it names, so it
        # is NOT state-oblivious: reads are pure, nothing seals
        pure_fs=frozenset({"read"}),
    )
