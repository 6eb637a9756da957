"""Campaigns: many test runs as one schedulable, resumable unit (the
port's copy of ``jepsen_tpu/campaign/__init__.py``, ROADMAP.md
A.11(d1)).

A *campaign* turns the one-test-at-a-time harness into a sweep
scheduler on one host. Its pieces:

* **plan** -- expands a declarative sweep matrix (workload x nemesis x
  concurrency x time-limit x seed, or any axes you like) into *test
  cells* with deterministic ids, validated by the planlint PL012 pass.
* **scheduler** -- runs cells on a bounded worker pool so CPU-side
  harness phases (db setup, generator, interpreter) overlap, while a
  device-slot semaphore serializes the device checker searches per
  card.
* **compile_cache** -- process-wide counts of plan shapes: a
  shape-identical search counts a hit, a first sighting a miss
  (surfaced through `obs` and the campaign report; the port compiles
  nothing per shape, so nothing is saved by a hit).
* **journal** -- persistent campaign state under
  ``store/campaigns/<id>/`` (``campaign.json`` + an append-only
  ``cells.jsonl``), so SIGINT/SIGKILL leaves a resumable campaign and
  ``--resume`` skips completed cells.
* **report** -- outcome aggregation: summary counts, flake detection
  (same cell params, different seeds, differing validity), and triage
  grouping by abort-reason/error.

The CLI front doors are ``python -m jepsen_tpu_torch campaign ...`` and
``test-all --parallel N [--resume]`` (cli.py).

Submodules that pull in the full harness (scheduler -> core ->
checker -> torch) load lazily, so lightweight consumers -- in
particular the engines' compile-cache notes -- can import
``jepsen_tpu_torch.campaign.compile_cache`` without the heavy chain.
"""

from __future__ import annotations

from . import compile_cache  # noqa: F401  (dependency-light, eager)

_LAZY = ("plan", "scheduler", "journal", "report")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in ("run_cells", "CampaignError"):
        from . import scheduler
        return getattr(scheduler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["compile_cache", "plan", "scheduler", "journal", "report",
           "run_cells", "CampaignError"]
