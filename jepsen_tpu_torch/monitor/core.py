"""The part of ``jepsen_tpu/monitor/core.py`` the plan report of record
needs: ``find_linearizable``, the walk from a test's checker tree to its
Linearizable gate. The monitor thread itself (``Monitor``, ``install``)
comes with the host harness (ROADMAP.md A.11(c))."""

from __future__ import annotations

__all__ = ["find_linearizable"]


def find_linearizable(checker):
    """Walk a checker tree to the Linearizable gate. Returns
    (linearizable, keyed) -- keyed True when the gate sits under an
    independent checker (ops carry [k v] tuples) -- or (None, False)
    when the family has no incremental engine (e.g. the cycle
    checker)."""
    from .. import independent
    from ..checker.checkers import Linearizable
    seen = set()

    def walk(c, keyed):
        if c is None or id(c) in seen:
            return None
        seen.add(id(c))
        if isinstance(c, Linearizable):
            return c, keyed
        if isinstance(c, independent._IndependentChecker):
            return walk(c.inner, True)
        # unwrap the common single-child wrappers (device-slot,
        # concurrency-limit) by attribute convention
        for attr in ("inner", "checker"):
            child = getattr(c, attr, None)
            if child is not None and child is not c:
                got = walk(child, keyed)
                if got is not None:
                    return got
        cmap = getattr(c, "checker_map", None)
        if isinstance(cmap, dict):
            for child in cmap.values():
                got = walk(child, keyed)
                if got is not None:
                    return got
        return None

    got = walk(checker, False)
    return got if got is not None else (None, False)
