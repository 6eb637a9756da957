"""The part of ``jepsen_tpu/monitor/core.py`` the run loop and the plan
report of record need: ``config`` (``test["monitor"]`` normalized),
``find_linearizable`` (the walk from a test's checker tree to its
Linearizable gate) and the run loop's hooks ``install``/``finalize``.
With monitoring off (the default) they do what the reference's do:
``install`` returns None and ``finalize(None, ...)`` is a no-op. The
monitor thread itself (``Monitor``, ``TxnMonitor``, ``certify_monitor``)
is ROADMAP.md A.11(c): with monitoring on, ``install`` raises
``NotImplementedError`` naming it."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

__all__ = ["DEFAULT_CHUNK", "config", "find_linearizable", "install",
           "finalize"]

#: completed client ops per incremental check
DEFAULT_CHUNK = 64


def config(test):
    """Normalize ``test["monitor"]`` (True | chunk int | options dict)
    into an options dict, or None when monitoring is off. Recognized
    keys: chunk, engine, engine-opts, skip-offline?, final?,
    quiescent-carry? (default True: truncate proven prefixes at sealed
    quiescent cuts so chunk checks stay O(window))."""
    mon = test.get("monitor")
    if not mon:
        return None
    if mon is True:
        cfg = {}
    elif isinstance(mon, int) and not isinstance(mon, bool):
        cfg = {"chunk": mon}
    elif isinstance(mon, dict):
        cfg = dict(mon)
    else:
        logger.warning("unrecognized test['monitor'] %r: monitoring "
                       "disabled", mon)
        return None
    if test.get("monitor-chunk") is not None:
        cfg.setdefault("chunk", test["monitor-chunk"])
    return cfg


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


def install(test):
    """The run loop's monitor hook (``core.run`` calls it after
    preflight). Returns None when monitoring is off. The monitor thread
    that a monitored run needs is not ported yet, so with monitoring on
    this raises rather than run the test unmonitored."""
    cfg = config(test)
    if cfg is None:
        return None
    raise NotImplementedError(
        "the streaming monitor inside a run (Monitor, TxnMonitor, "
        "certify_monitor) is not ported yet: ROADMAP.md A.11(c); run "
        "without test['monitor']")


def finalize(mon, test, finish=True):
    """Stop a monitor and park its summary on the test map. ``install``
    returns no monitor while A.11(c) is open, so this is the
    reference's no-op for ``mon is None``."""
    if mon is None:
        return None
    raise NotImplementedError(
        "monitor finalize needs the monitor thread: ROADMAP.md A.11(c)")
