"""The run loop's profiler hook (the part of ``jepsen_tpu/obs/profile.py``
that ``core.analyze`` calls): ``scope(test)`` wraps the analyze phase, a
no-op unless ``test["profile?"]`` is set.

The capture itself (``torch.profiler`` around the run's device searches,
with its ``profile.json`` marker next to ``trace.jsonl`` and its wall
bound) is ROADMAP.md A.11(d): with ``profile?`` set, ``scope`` raises
``NotImplementedError`` rather than run the test unprofiled.
"""

from __future__ import annotations

import contextlib

__all__ = ["scope"]


@contextlib.contextmanager
def scope(test):
    """Capture a device profile around the body when
    ``test["profile?"]`` is set; a no-op context otherwise."""
    if not isinstance(test, dict) or not test.get("profile?"):
        yield None
        return
    raise NotImplementedError(
        "the run's profiler capture (torch.profiler in place of the JAX "
        "package's jax.profiler) is not ported yet: ROADMAP.md A.11(d); "
        "run without test['profile?'], or profile the main path with "
        "python3 -m jepsen_tpu_torch.profile_main")
