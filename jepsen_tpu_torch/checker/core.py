"""Checker protocol (reference jepsen/src/jepsen/checker.clj).

A checker examines a history and returns a map with a ``valid`` key:
True, False, or "unknown" (couldn't decide). The part of
``jepsen_tpu.checker.core`` this slice of the port needs; validity
merging, the combinators, history lint and certification hooks come
with the host harness (ROADMAP.md queue A).
"""

from __future__ import annotations

__all__ = ["Checker"]


class Checker:
    """check(test, history, opts) -> {"valid": ..., ...} (checker.clj:52-67).

    opts is a map like {"history-file": ..., "subdirectory": ...} used by
    checkers that write files.
    """

    def check(self, test, hist, opts=None):  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, test, hist, opts=None):
        return self.check(test, hist, opts or {})
