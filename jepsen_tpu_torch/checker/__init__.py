"""Checkers: history -> verdict maps (reference jepsen/src/jepsen/checker.clj).

Core protocol in checker.core; the linearizability engines in checker.wgl
(CPU oracle) and checker.torch_wgl (batched device search, whose greedy
rollout is the CUDA kernel of checker.rollout)."""

from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all

__all__ = list(_core_all)
