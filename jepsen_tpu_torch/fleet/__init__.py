"""The fleet layer: campaigns as a multi-host, restart-surviving,
externally-callable checking service (the port's copy of
``jepsen_tpu/fleet/__init__.py``, in part).

The JAX package's fleet has four pillars:

* **ledger** -- the campaign compile-reuse ledger
  (``campaign/compile_cache.py``) made disk-persistent under
  ``store/compile_ledger/`` and shared across campaign processes. The
  port compiles nothing per shape, so it has nothing to persist until
  the dispatcher, the ledger's reader, comes: ROADMAP.md A.11(d3).
* **ha** -- coordinator HA. Its journal half (the epoch fold, the
  fence, the constants) is ported, because the campaign scheduler and
  the control-plane audit read it; the lease and the standby come with
  dispatch.
* **dispatch + worker** (with sync, chaos and backends) -- remote-worker
  campaigns leasing cells over the SSH control plane, artifact sync,
  seeded fault injection and per-cell backend failover: ROADMAP.md
  A.11(d3).
* **service** -- the submission API with its cross-tenant coalescer:
  ROADMAP.md A.11(d4).

Submodules load lazily, as in the reference. An unported submodule
raises ``NotImplementedError`` naming its sub-slice, and no other path
runs in its place.
"""

from __future__ import annotations

_LAZY = ("worker", "dispatch", "service", "backends", "sync", "chaos",
         "ha")

#: submodules of the JAX package's fleet that the port has not got yet,
#: each with the ROADMAP.md sub-slice that ports it
UNPORTED = {"ledger": "A.11(d3)",
            "dispatch": "A.11(d3)", "worker": "A.11(d3)",
            "sync": "A.11(d3)", "chaos": "A.11(d3)",
            "backends": "A.11(d3)", "service": "A.11(d4)"}


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
        raise _unported("dispatch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ledger", "worker", "dispatch", "service", "backends",
           "sync", "chaos", "ha", "run_fleet", "FleetError",
           "parse_workers", "UNPORTED"]
