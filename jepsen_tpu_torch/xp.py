"""Array faces the model step functions run on.

A model's ``step(state, f, args, ret, xp)`` is branch-free array code.
The same function runs

* under ``NP`` on the host, one configuration at a time: ``state`` (S,),
  ``f`` a scalar, ``args``/``ret`` (A,) -- the sequential oracle, the
  state-abstraction pre-check and the witness replay;
* under ``TORCH`` on the device, batched *component first*: ``state``
  (S, ...), ``f`` (...), ``args``/``ret`` (A, ...), every operand
  broadcastable against the others. ``state[0]`` is then a whole plane
  of values, so the steps need no vmap.

Both faces agree on the component axis: ``stack`` builds it at axis 0
and ``all``/``any`` without an axis reduce it (for the host's 1-D
vectors that is the whole array, as numpy does). ``astype`` replaces the
``ndarray.astype`` method, which torch tensors lack.
"""

from __future__ import annotations

import numpy as np
import torch


class _NumpyXP:
    """numpy face for single configurations on the host."""

    where = staticmethod(np.where)
    stack = staticmethod(np.stack)
    all = staticmethod(np.all)
    any = staticmethod(np.any)

    @staticmethod
    def astype(x, dtype):
        return np.asarray(x).astype(dtype)


class _TorchXP:
    """torch face for component-first batches on the device."""

    where = staticmethod(torch.where)

    @staticmethod
    def stack(xs):
        return torch.stack(torch.broadcast_tensors(*xs))

    @staticmethod
    def all(x):
        return x.all(dim=0)

    @staticmethod
    def any(x):
        return x.any(dim=0)

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)


NP = _NumpyXP()
TORCH = _TorchXP()
