"""The fleet layer: campaigns as a multi-host, restart-surviving,
externally-callable checking service (the port's copy of
``jepsen_tpu/fleet/__init__.py``).

The pillars:

* **ledger** -- the campaign plan-shape counter
  (``campaign/compile_cache.py``) made disk-persistent under
  ``store/compile_ledger/``: atomic fcntl-locked appends, torn-tail
  tolerant reads, so the counts survive process restarts and are shared
  across campaign processes and the fleet's workers.
* **dispatch + worker** (with sync, chaos and backends) -- remote-worker
  campaigns: the dispatcher leases cells to N hosts over the
  ``control/remotes.py`` plane, lease records append to the campaign
  journal as the single source of truth, and an expired or dead
  worker's cell is re-leased to another host (work stealing). Each
  worker is a fresh ``python -m jepsen_tpu_torch.fleet.worker``
  process, which on the card makes its own CUDA context and loads the
  rollout kernel's library.
* **ha** -- coordinator HA: the coordinator role as a journaled lease
  that a standby fences and takes over.
* **backends** -- per-cell backend failover tiering (gpu -> cpu)
  chosen by a cached health probe, so a card that is down degrades a
  campaign to slower verdicts instead of none.
* **service** -- the submission API with its cross-tenant coalescer:
  ROADMAP.md A.11(d4).

Submodules load lazily, as in the reference; ``ledger`` stays
dependency-light (store + fcntl only) because
``campaign.compile_cache`` imports it from inside the note path. An
unported submodule raises ``NotImplementedError`` naming its
sub-slice, and no other path runs in its place.
"""

from __future__ import annotations

_LAZY = ("ledger", "worker", "dispatch", "service", "backends",
         "sync", "chaos", "ha")

#: submodules of the JAX package's fleet that the port has not got yet,
#: each with the ROADMAP.md sub-slice that ports it
UNPORTED = {"service": "A.11(d4)"}


def _unported(name):
    return NotImplementedError(
        f"jepsen_tpu_torch.fleet.{name} is not ported yet: ROADMAP.md "
        f"{UNPORTED[name]}")


def __getattr__(name):
    if name in UNPORTED:
        raise _unported(name)
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in ("run_fleet", "FleetError", "parse_workers"):
        from . import dispatch
        return getattr(dispatch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ledger", "worker", "dispatch", "service", "backends",
           "sync", "chaos", "ha", "run_fleet", "FleetError",
           "parse_workers", "UNPORTED"]
