"""Consistency models.

Two faces of the same model, differential-tested against each other:

1. **Oracle face** (knossos.model surface, reference checker.clj:233-234,
   jepsen/src/jepsen/tests.clj:8): immutable Python objects with
   ``step(op) -> model' | Inconsistent``. Used by host-side checkers
   (queue checker's model fold) and as the ground truth in tests.

2. **Tensor face** (the device path): a ``ModelSpec`` describing a
   fixed-width int32 state vector and a *branch-free* transition
   ``step(state, f, args, ret, xp) -> (state', ok)`` written against an
   array face ``xp`` (``jepsen_tpu_torch.xp``) -- the same code runs
   under ``xp.NP`` on the host (the sequential WGL oracle) and batched,
   component first, under ``xp.TORCH`` on the device (the batched B&B
   frontier expansion). Branch-free means where/one-hot only: no
   data-dependent Python control flow.

A copy of ``jepsen_tpu.models.base`` with its own registry: the port
imports nothing of the JAX package.

Value encoding: history values must become int32. Integers pass through;
other hashables are interned per-encoding via Interner.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..history import NIL, encode_history


class Inconsistent:
    """Marker for an invalid transition (knossos.model/inconsistent)."""

    def __init__(self, msg=""):
        self.msg = msg

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"

    def __bool__(self):
        return False


def inconsistent(msg=""):
    return Inconsistent(msg)


def is_inconsistent(x) -> bool:
    return isinstance(x, Inconsistent)


class Model:
    """Immutable state machine: ``step(op) -> Model | Inconsistent``."""

    def step(self, op):  # pragma: no cover - interface
        raise NotImplementedError


class Interner:
    """Maps arbitrary hashable values to dense non-negative int32 codes.
    Integers that fit int32 map to themselves (so arithmetic-flavored tests
    stay readable); everything else is interned."""

    INT_LO = -(2**30)
    INT_HI = 2**30

    def __init__(self):
        self._codes = {}
        self._next = 2**30  # interned codes live above the passthrough range

    def encode(self, v):
        if v is None:
            return NIL
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, (int, np.integer)) and self.INT_LO < v < self.INT_HI:
            return int(v)
        code = self._codes.get(v)
        if code is None:
            code = self._next
            self._next += 1
            self._codes[v] = code
        return code


@dataclasses.dataclass
class ModelSpec:
    """Tensor-face description of a model (see module docstring).

    Attributes:
      name: model name (matches the oracle class).
      f_codes: map op-f (str) -> int code.
      arg_width: A, width of the args/ret vectors.
      state_size: fn(EncodedHistory) -> S, the int32 state-vector length
        (history-dependent for queues: capacity = #enqueues).
      init_state: fn(EncodedHistory, S) -> np.int32[S].
      step: fn(state, f, args, ret, xp) -> (state', ok). All arrays from
        namespace xp; state (S,), f scalar, args/ret (A,), ok scalar bool.
      make_oracle: fn() -> Model for the same initial state.
    """

    name: str
    f_codes: dict
    arg_width: int
    state_size: Callable
    init_state: Callable
    step: Callable
    make_oracle: Callable
    # encode one op: (f, invoke_value, completion_value|None)
    #   -> (fcode, args_list, ret_list)
    encode_op: Callable = None
    # optional fn(init_state, S_pad) -> padded init state, for models whose
    # state size is history-dependent (queues). Padding must preserve state
    # canonicalization so the checker's dedup still sees equal states as
    # byte-equal. None = state size is fixed, never padded.
    pad_state: Callable = None
    # optional fn(e, invoke32, ret32) -> int32[n] linearization priority
    # for the device search (lower = try earlier). Purely a heuristic --
    # soundness never depends on it. None = earliest-deadline-first
    # (order by return index). Queues use this to order enqueues by
    # their values' dequeue order (an enqueue must linearize before the
    # dequeue that returns its value).
    hint: Callable = None
    # optional fn(e, invoke32, ret32) -> True | False | None: an EXACT
    # polynomial-time decision procedure for the subclass of histories it
    # understands (None = can't decide, fall back to search). Queues use
    # aspect-style bad-pattern detection, which scales where the NP-hard
    # search cannot.
    fast_check: Callable = None
    # optional fn(state_vec) -> jsonable: human-readable rendering of a
    # state vector for failure witnesses (knossos shows e.g.
    # #knossos.model.CASRegister{:value 3}); None = raw int list
    decode_state: Callable = None
    # optional frozenset of op :f names that never change state (pure
    # reads) AND always step ok when args/ret are entirely unknown.
    # The search planner (analysis/searchplan.py) elides unconstrained
    # non-ok pure ops and lets pure ops float across quiescent cuts.
    # None = no op is known pure; planning degrades, never misjudges.
    pure_fs: frozenset = None
    # optional frozenset of op :f names that are TOTAL (steppable from
    # every state) and STATE-OBLIVIOUS (the post-state depends only on
    # the op, e.g. a register write; NOT cas — it isn't total). The
    # planner's sealed quiescent cuts replay such an op as the next
    # segment's state seed. None = no cuts for this model.
    seal_fs: frozenset = None
    # optional fn(e, invoke32, ret32) -> bool[n] keep mask | None: ops
    # whose mask is False are removed from the search's candidate set
    # entirely. Must be validity-preserving BOTH ways (the check with and
    # without the pruned ops must agree) -- only provably-droppable
    # non-ok ops qualify (e.g. crashed enqueues of never-observed
    # values). None = no pruning applies to this history.
    prune: Callable = None

    def encode(self, hist):
        """Encode an event history for this model. Returns (EncodedHistory,
        init_state np.int32[S])."""
        interner = Interner()
        enc = self.encode_op or self.default_encode_op
        e = encode_history(
            hist, lambda f, v, rv: enc(self, interner, f, v, rv),
            self.arg_width)
        s = self.state_size(e)
        return e, np.asarray(self.init_state(e, s), np.int32)

    @staticmethod
    def default_encode_op(spec, interner, f, value, ret_value):
        """Default encoder: f by f_codes; invoke value -> args[0];
        completion value -> ret[0]."""
        fcode = spec.f_codes[f]
        return fcode, [interner.encode(value)], [interner.encode(ret_value)]


_REGISTRY = {}


def register_model(spec: ModelSpec):
    # codelint: ok -- import-time registration, serialized by Python's
    # module import lock; never called from worker threads
    _REGISTRY[spec.name] = spec
    return spec


def model_spec(name_or_spec) -> ModelSpec:
    if isinstance(name_or_spec, ModelSpec):
        return name_or_spec
    try:
        return _REGISTRY[name_or_spec]
    except KeyError:
        raise KeyError(f"Unknown model {name_or_spec!r}; known: "
                       f"{sorted(_REGISTRY)}") from None


def known_models():
    return dict(_REGISTRY)
