"""Checker protocol + combinators (reference jepsen/src/jepsen/checker.clj).

A checker examines a history and returns a map with a ``valid`` key:
True, False, or "unknown" (couldn't decide). Validity merges with
False > "unknown" > True (checker.clj:29-50).

The part of ``jepsen_tpu.checker.core`` the port needs: validity merging,
the checker protocol and its combinators. ``check`` here is a plain call
on an indexed history. What ``jepsen_tpu.checker.core.check`` adds around
that call -- history lint, search planning and verdict certification
(``lint_history``, ``plan_history``, ``certify_verdict``) -- and the obs
spans of ``check_safe`` wait for the host harness and the obs glue
(ROADMAP.md queue A).
"""

from __future__ import annotations

import traceback

from .. import history as h
from ..util import real_pmap

__all__ = ["Checker", "check", "check_safe", "compose", "noop",
           "unbridled_optimism", "merge_valid", "valid_prio"]


def valid_prio(v):
    """Validity severity: false dominates, then unknown, then true
    (checker.clj:29-39)."""
    if v is False:
        return 0
    if v == "unknown" or v is None:
        return 1
    return 2


def merge_valid(valids):
    """Merge a collection of validity values (checker.clj:41-50)."""
    out = True
    for v in valids:
        if valid_prio(v) < valid_prio(out):
            out = v
    return out


class Checker:
    """check(test, history, opts) -> {"valid": ..., ...} (checker.clj:52-67).

    opts is a map like {"history-file": ..., "subdirectory": ...} used by
    checkers that write files.
    """

    def check(self, test, hist, opts=None):  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, test, hist, opts=None):
        return self.check(test, hist, opts or {})


class FnChecker(Checker):
    def __init__(self, fn, name=None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "checker")

    def check(self, test, hist, opts=None):
        return self.fn(test, hist, opts or {})

    def __repr__(self):
        return f"<checker {self.name}>"


def as_checker(c) -> Checker:
    if isinstance(c, Checker):
        return c
    if callable(c):
        return FnChecker(c)
    raise TypeError(f"not a checker: {c!r}")


def check(checker, test, hist, opts=None):
    """Run a checker over an indexed history (no lint, plan or
    certification in the port yet; see the module docstring)."""
    hist = h.ensure_indexed(hist)
    return as_checker(checker).check(test, hist, opts or {})


def check_safe(checker, test, hist, opts=None):
    """Like check, but exceptions become {"valid": "unknown"}
    (checker.clj:74-85)."""
    try:
        return check(checker, test, hist, opts)
    except Exception:  # noqa: BLE001 - mirrors reference behavior
        return {"valid": "unknown", "error": traceback.format_exc()}


class Compose(Checker):
    """Map of name -> checker, run in parallel; result map of name -> result
    with merged validity (checker.clj:87-99)."""

    def __init__(self, checker_map):
        self.checker_map = {k: as_checker(c) for k, c in checker_map.items()}

    def check(self, test, hist, opts=None):
        items = list(self.checker_map.items())
        results = real_pmap(
            lambda kv: (kv[0], check_safe(kv[1], test, hist, opts)), items)
        rmap = dict(results)
        return {"valid": merge_valid([r.get("valid") for r in rmap.values()]),
                **rmap}


def compose(checker_map):
    return Compose(checker_map)


class _Noop(Checker):
    def check(self, test, hist, opts=None):
        return {"valid": True}


def noop():
    return _Noop()


class _Optimism(Checker):
    def check(self, test, hist, opts=None):
        return {"valid": True, "everything-looks-good?": "definitely"}


def unbridled_optimism():
    """Everything is awesome! (checker.clj:118-122)"""
    return _Optimism()
