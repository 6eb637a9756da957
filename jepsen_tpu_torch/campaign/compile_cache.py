"""Plan-shape counter: which search shapes a campaign's cells repeated
(the port's copy of ``jepsen_tpu/campaign/compile_cache.py``, its
in-process half only; host-only).

In the JAX package a search's plan shape keys jax's jit cache, so this
module's counts are compile hits and misses. The port compiles nothing
per shape: its searches pad to the same power-of-two buckets
(``checker/torch_wgl.py`` ``_bucket`` / ``_plan_sizes``), but a bucket
keys only the tensors' shapes, and the one compiled artifact, the
rollout kernel's library, is built once per process by ``_build``. So
here a **miss** is the first sighting of a plan shape in this process
and a **hit** any later sighting; nothing is compiled or saved by
either. The counts keep the reference's names because the campaign
report and each cell's ``metrics.json`` carry them under those names.

The engines note under labels of their own (``"torch-wgl"``,
``"torch-wgl-batch"``, ``"torch-wgl-sharded"``, ``"torch-streamlin"``,
``"torch-streamlin-batch"``; the JAX package's are ``"jax-wgl"`` and so
on), so a store shared by both packages never mixes the two counts.

Not carried over (ROADMAP.md, deliberate divergences): the settable
op-count floor (``set_n_floor`` / ``bucket_floor``): a coarser bucket
buys the port no reuse, only padding rows, so the floor stays the
constant ``util.DEFAULT_N_FLOOR`` read through ``torch_wgl._n_floor``;
and the disk-persistent ledger (``fleet.ledger``), whose reader is the
fleet's dispatcher (ROADMAP.md A.11(d3)).

Deliberately dependency-light (obs only): the engines import this from
inside the search entry points, and nothing here may drag the
scheduler -> core -> checker import chain back in.
"""

from __future__ import annotations

import threading

from .. import obs

__all__ = ["note", "stats", "delta", "reset"]

_lock = threading.Lock()
_seen: set = set()
_hits: dict = {}          # engine -> int
_misses: dict = {}        # engine -> int


def note(engine, key):
    """Record one search's plan. ``key`` must contain every value that
    shapes the engine's search (spec name + plan sizes). Returns True
    on a hit (a shape-identical search already ran in this process),
    False on a miss. Mirrored to the bound obs registry as
    ``campaign.compile_cache.{hits,misses}{engine=...}``."""
    k = (str(engine), tuple(key))
    with _lock:
        hit = k in _seen
        if hit:
            _hits[engine] = _hits.get(engine, 0) + 1
        else:
            _seen.add(k)
            _misses[engine] = _misses.get(engine, 0) + 1
    obs.inc("campaign.compile_cache.hits" if hit
            else "campaign.compile_cache.misses", engine=str(engine))
    return hit


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
    """Forget every sighting (tests)."""
    with _lock:
        _seen.clear()
        _hits.clear()
        _misses.clear()
