"""Helpers for mucking around with tests interactively (reference
jepsen/src/jepsen/repl.clj, 9 LoC; the port's copy of
``jepsen_tpu/repl.py``)."""

from __future__ import annotations

from . import store


def latest_test():
    """The most recently run test (repl.clj latest-test)."""
    return store.latest()


def latest_history():
    """The most recently run test's history, decoded."""
    t = store.latest()
    return t.get("history") if t is not None else None
