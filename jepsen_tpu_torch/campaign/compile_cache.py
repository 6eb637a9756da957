"""Plan-shape counter: which search shapes a campaign's cells repeated
(the port's copy of ``jepsen_tpu/campaign/compile_cache.py``;
host-only).

In the JAX package a search's plan shape keys jax's jit cache, so this
module's counts are compile hits and misses. The port compiles nothing
per shape: its searches pad to the same power-of-two buckets
(``checker/torch_wgl.py`` ``_bucket`` / ``_plan_sizes``), but a bucket
keys only the tensors' shapes, and the one compiled artifact, the
rollout kernel's library, is built once per process by ``_build``. So
here a **miss** is the first sighting of a plan shape (in this
process, or in any process sharing the attached disk ledger) and a
**hit** any later sighting; nothing is compiled or saved by
either. The counts keep the reference's names because the campaign
report and each cell's ``metrics.json`` carry them under those names.

The engines note under labels of their own (``"torch-wgl"``,
``"torch-wgl-batch"``, ``"torch-wgl-sharded"``, ``"torch-streamlin"``,
``"torch-streamlin-batch"``; the JAX package's are ``"jax-wgl"`` and so
on), so a store shared by both packages never mixes the two counts.

The in-memory counter dies with the process; attach the disk-backed
half (``jepsen_tpu_torch.fleet.ledger``, ``store/compile_ledger/``) via
``set_ledger`` and first sightings persist across restarts AND across
the fleet's worker processes: ``note`` re-reads sibling processes'
appends before declaring a miss. The fleet's finalize folds the
workers' per-cell deltas (and the cold/warm wall split) from there.

``bucket`` and ``bucket_for`` are the shared pow-2 shape rule: the
service's cross-tenant coalescer groups ``/api/check`` segments on
``bucket_for(n_ops)``, the op-count bucket every engine pads to.

``noted_keys`` is every plan shape this process noted, hits and misses
alike, under the port's labels (``analysis.sizemodel.ledger_key_shape``
maps them onto the reference's key indices). The capacity planner's
prediction oracle brackets a campaign with ``noted_counts`` and takes
``noted_since`` as its "actual" side: the shapes noted during the
campaign, including those an earlier campaign of the same process had
noted already, which a diff of the key sets would lose (ROADMAP.md
C.11).

Not carried over (ROADMAP.md, deliberate divergences): the settable
op-count floor (``set_n_floor`` / ``bucket_floor``): a coarser bucket
buys the port no reuse, only padding rows, so the floor stays the
constant ``util.DEFAULT_N_FLOOR`` read through ``torch_wgl._n_floor``.

Deliberately dependency-light (obs only): the engines import this from
inside the search entry points, and nothing here may drag the
scheduler -> core -> checker import chain back in.
"""

from __future__ import annotations

import threading

from .. import obs
from ..util import bucket

__all__ = ["note", "stats", "delta", "reset", "set_ledger", "get_ledger",
           "bucket", "bucket_for", "noted_keys", "noted_counts",
           "noted_since"]

_lock = threading.Lock()
_seen: set = set()
_noted: dict = {}         # key -> times THIS process noted it (hit or
#                           miss); never pre-seeded by a ledger attach,
#                           so a before/after bracket of the counts yields
#                           exactly one campaign's shapes (the oracle)
_hits: dict = {}          # engine -> int
_misses: dict = {}        # engine -> int
_ledger = None            # fleet.ledger.Ledger when persistence is on


def bucket_for(n_ops):
    """The op-count bucket an encoded history of ``n_ops`` rows pads
    to: ``bucket(n_ops, floor)`` with the engines' floor
    (``torch_wgl._n_floor``, the constant 64). The service's coalescer
    batches ``/api/check`` segments on it, so a giant history never
    inflates a small batchmate's padding."""
    from ..checker.torch_wgl import _n_floor
    return bucket(n_ops, _n_floor())


def set_ledger(ledger):
    """Attach (or, with None, detach) the persistent disk ledger
    (fleet.ledger.Ledger). On attach, disk-known shapes fold into the
    seen set so they count as hits from the first sighting on."""
    global _ledger
    keys = ledger.refresh() if ledger is not None else ()
    with _lock:
        _ledger = ledger
        _seen.update(keys)


def get_ledger():
    with _lock:
        return _ledger


def _canon(engine, key):
    """Canonical hashable key. With a ledger attached, keys must
    compare equal across a JSON round trip (live tuple vs re-read
    line), so they are normalized through it; without one, the raw
    tuple is cheaper and equivalent."""
    if get_ledger() is None:
        return (str(engine), tuple(key))
    from ..fleet.ledger import canon_key
    return canon_key(engine, key)


def _refresh_from(led):
    """Fold the ledger's latest on-disk keys into the seen set."""
    try:
        fresh = led.refresh()
    except Exception:  # noqa: BLE001 - ledger is bookkeeping only
        return
    with _lock:
        _seen.update(fresh)


def note(engine, key):
    """Record one search's plan. ``key`` must contain every value that
    shapes the engine's search (spec name + plan sizes). Returns True
    on a hit (a shape-identical search already ran in this process, or
    in any process that shares the attached ledger), False on a miss.
    Mirrored to the bound obs registry as
    ``campaign.compile_cache.{hits,misses}{engine=...}``.

    With a persistent ledger attached, the disk file is re-read before
    a miss is declared, and fresh misses are appended for siblings and
    successors."""
    k = _canon(engine, key)
    led = get_ledger()
    with _lock:
        hit = k in _seen
    if not hit and led is not None:
        _refresh_from(led)
    with _lock:
        hit = k in _seen
        _noted[k] = _noted.get(k, 0) + 1
        if hit:
            _hits[engine] = _hits.get(engine, 0) + 1
        else:
            _seen.add(k)
            _misses[engine] = _misses.get(engine, 0) + 1
    if not hit and led is not None:
        led.record(engine, key)
    obs.inc("campaign.compile_cache.hits" if hit
            else "campaign.compile_cache.misses", engine=str(engine))
    return hit


def noted_keys():
    """Canonical ``(engine, key)`` pairs every search THIS process has
    noted (hits and misses alike; never pre-seeded from a ledger
    attach): the keys of ``noted_counts``."""
    return set(noted_counts())


def noted_counts():
    """``{(engine, key): times noted}`` for this process: the oracle's
    bracket (``noted_since``)."""
    with _lock:
        return dict(_noted)


def noted_since(before):
    """The canonical keys noted since the ``noted_counts()`` snapshot
    ``before``: every key whose count grew, so a shape an earlier
    campaign of this process noted still counts when this one notes it
    again."""
    with _lock:
        return {k for k, n in _noted.items() if n > before.get(k, 0)}


def stats():
    """Process-lifetime totals: {"hits", "misses", "shapes",
    "by_engine": {engine: {"hits", "misses"}}}."""
    with _lock:
        engines = sorted(set(_hits) | set(_misses))
        return {
            "hits": sum(_hits.values()),
            "misses": sum(_misses.values()),
            "shapes": len(_seen),
            "by_engine": {e: {"hits": _hits.get(e, 0),
                              "misses": _misses.get(e, 0)}
                          for e in engines},
        }


def delta(before):
    """Stats since a prior ``stats()`` snapshot -- the campaign
    scheduler brackets its run with this to report only its own cells'
    repeats."""
    now = stats()
    return {"hits": now["hits"] - before.get("hits", 0),
            "misses": now["misses"] - before.get("misses", 0)}


def reset():
    """Forget every sighting and detach any persistent ledger (tests)."""
    global _ledger
    with _lock:
        _seen.clear()
        _noted.clear()
        _hits.clear()
        _misses.clear()
        _ledger = None
