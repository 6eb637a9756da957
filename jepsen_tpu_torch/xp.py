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
``ndarray.astype`` method, which torch tensors lack. The queue models'
steps add the rest, all along the component axis:

* ``arange(n, like)``: ``0..n-1`` down the component axis, shaped to
  broadcast against ``like`` (``(n, 1, ...)`` under ``TORCH``);
* ``roll(x, shift)``, ``sort(x)``: along axis 0 (``sort`` ascending,
  values only);
* ``argmax(x)``: along axis 0, the first maximum; a bool plane is cast
  to an integer first, so an all-false column gives 0, as ``jnp.argmax``
  does;
* ``concatenate(xs)``: along axis 0, each part first broadcast to the
  common shape of the others' trailing axes.
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

    @staticmethod
    def arange(n, like):
        return np.arange(n)

    @staticmethod
    def roll(x, shift):
        return np.roll(x, shift, axis=0)

    @staticmethod
    def sort(x):
        return np.sort(x, axis=0)

    @staticmethod
    def argmax(x):
        return np.argmax(x, axis=0)

    @staticmethod
    def concatenate(xs):
        xs = [np.asarray(x) for x in xs]
        tail = np.broadcast_shapes(*(x.shape[1:] for x in xs))
        return np.concatenate(
            [np.broadcast_to(x, x.shape[:1] + tail) for x in xs])


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

    @staticmethod
    def arange(n, like):
        return torch.arange(n, device=like.device).reshape(
            (n,) + (1,) * (like.dim() - 1))

    @staticmethod
    def roll(x, shift):
        return torch.roll(x, shift, dims=0)

    @staticmethod
    def sort(x):
        return torch.sort(x, dim=0).values

    @staticmethod
    def argmax(x):
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return torch.argmax(x, dim=0)

    @staticmethod
    def concatenate(xs):
        tail = torch.broadcast_shapes(*(x.shape[1:] for x in xs))
        return torch.cat([x.expand(x.shape[:1] + tail) for x in xs])


NP = _NumpyXP()
TORCH = _TorchXP()
