"""The disk-persistent compile ledger: cross-PROCESS plan-shape
knowledge under ``store/compile_ledger/`` (the port's copy of
``jepsen_tpu/fleet/ledger.py``; host-only).

``campaign.compile_cache`` answers "has a shape-identical search run
in this process?". What it cannot see is history: a campaign
re-started after a crash, or the fleet's worker processes, each of
which starts with an empty counter. This module is the durable half:
every first sighting of a plan shape appends one JSON line to
``ledger.jsonl``, and ``refresh()`` folds lines appended by *other*
processes into the reader's view, so a shape any process has planned
counts as a hit everywhere afterwards.

In the port nothing is compiled per shape (``campaign/compile_cache.py``):
a hit or a miss is a sighting, and the ledger keeps those sightings
across processes under the port's engine labels (``torch-wgl``, ...).
The one compiled artifact, the rollout kernel's library, is content-
hashed and reused across processes by ``_build`` already, so the
reference's ``enable_jax_cache`` has no counterpart: ``attach`` takes
its ``jax_cache`` argument and points nothing anywhere (ROADMAP.md,
deliberate divergences).

Disk discipline matches the campaign journal (``cells.jsonl``):

* appends happen under an ``fcntl`` exclusive lock (concurrent
  *processes* interleave whole lines, never bytes) and are
  flushed+fsynced before the lock drops;
* a process killed mid-append leaves a torn final line; the next
  appender terminates the fragment in place and readers skip it;
* records are never rewritten -- stats land as separate ``"stats"``
  event lines (one per campaign finalize), and ``stats()`` aggregates
  the whole file.

Keys are canonicalized through a JSON round trip before comparison, so
a tuple noted live and the same tuple re-read from disk are equal.

Deliberately dependency-light (store + stdlib): compile_cache imports
this from inside ``note()`` and nothing here may drag the heavy
scheduler/checker chain back in.
"""

from __future__ import annotations

import json
import logging
import os
import threading

from .. import store

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

logger = logging.getLogger(__name__)

__all__ = ["LEDGER_FILE", "Ledger", "canon_key", "attach", "attached",
           "detach", "fold_walls"]

LEDGER_FILE = "ledger.jsonl"


def canon_key(engine, key):
    """The canonical (hashable) form of one compile-plan key: what a
    live ``note()`` computes and what a ledger line parses back to
    must be equal, so both go through one JSON round trip."""
    raw = json.loads(json.dumps(list(key), cls=store._Encoder))
    return (str(engine),
            tuple(tuple(x) if isinstance(x, list) else x for x in raw))


class Ledger:
    """One process's handle on the shared on-disk ledger."""

    def __init__(self, dir=None):  # noqa: A002 - mirrors open()
        self.dir = os.path.abspath(dir or store.compile_ledger_path())
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, LEDGER_FILE)
        self._lock = threading.Lock()
        self._offset = 0        # how far refresh() has parsed
        self._keys = set()

    # -- reading --------------------------------------------------------

    def refresh(self):
        """Fold lines other processes appended since the last refresh
        into this handle's key set; returns the full set. A torn final
        line (a writer mid-append, or one that died there) is left
        unparsed -- the offset stays before it, so a later refresh
        picks the completed line up."""
        with self._lock:
            try:
                with open(self.path, "rb") as f:
                    f.seek(self._offset)
                    chunk = f.read()
            except FileNotFoundError:
                return set(self._keys)
            consumed = 0
            for line in chunk.split(b"\n")[:-1]:   # last piece: no \n yet
                consumed += len(line) + 1
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # an interior fragment: a previous writer's torn
                    # tail that a later appender terminated in place
                    logger.warning("skipping torn compile-ledger line")
                    continue
                if isinstance(rec, dict) and "key" in rec:
                    try:
                        self._keys.add(
                            canon_key(rec.get("engine"), rec["key"]))
                    except TypeError:
                        logger.warning("unhashable compile-ledger key "
                                       "skipped: %r", rec)
            self._offset += consumed
            return set(self._keys)

    def keys(self):
        with self._lock:
            return set(self._keys)

    # -- writing --------------------------------------------------------

    def _append(self, rec):
        line = json.dumps(rec, cls=store._Encoder)
        with self._lock:
            with open(self.path, "a+b") as f:
                if fcntl is not None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                try:
                    # terminate a torn tail (a writer killed mid-append)
                    # so this record never merges into the fragment
                    f.seek(0, os.SEEK_END)
                    if f.tell() > 0:
                        f.seek(-1, os.SEEK_END)
                        if f.read(1) != b"\n":
                            f.write(b"\n")
                    f.write(line.encode() + b"\n")
                    f.flush()
                    try:
                        os.fsync(f.fileno())
                    except OSError:  # pragma: no cover - exotic fs
                        pass
                finally:
                    if fcntl is not None:
                        fcntl.flock(f.fileno(), fcntl.LOCK_UN)

    def record(self, engine, key):
        """Persist one first-sighting (a compile miss). Failures are
        contained: the ledger is bookkeeping, never verdict-bearing."""
        k = canon_key(engine, key)
        try:
            self._append({"engine": k[0], "key": list(k[1]),
                          "pid": os.getpid(), "t": store.local_time()})
        except Exception:  # noqa: BLE001 - telemetry only
            logger.warning("compile-ledger append failed", exc_info=True)
            return
        with self._lock:
            self._keys.add(k)

    def note_stats(self, hits, misses, cold_wall_s=None,
                   warm_wall_s=None):
        """Append one process's hit/miss delta as a stats event (the
        campaign scheduler calls this at finalize), so the persisted
        ledger carries reuse evidence, not just shapes.

        ``cold_wall_s``/``warm_wall_s`` fold the campaign's wall clock
        in: total wall of cells whose delta had misses (first
        sightings) vs all-hit cells. In the port neither paid a
        per-shape compile; the split is kept because the ledger file
        is the reference's format."""
        st = {"hits": int(hits), "misses": int(misses)}
        if cold_wall_s is not None:
            st["cold_wall_s"] = round(float(cold_wall_s), 3)
        if warm_wall_s is not None:
            st["warm_wall_s"] = round(float(warm_wall_s), 3)
        try:
            self._append({"stats": st, "pid": os.getpid(),
                          "t": store.local_time()})
        except Exception:  # noqa: BLE001 - telemetry only
            logger.warning("compile-ledger stats append failed",
                           exc_info=True)

    # -- aggregation ----------------------------------------------------

    def stats(self):
        """Whole-file aggregate: distinct shapes, summed hit/miss
        deltas across every process that ever reported, and the
        contributing pids."""
        shapes, hits, misses, pids = set(), 0, 0, set()
        cold_s, warm_s = 0.0, 0.0
        try:
            with open(self.path, "rb") as f:
                lines = f.read().split(b"\n")
        except FileNotFoundError:
            lines = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if "key" in rec:
                try:
                    shapes.add(canon_key(rec.get("engine"), rec["key"]))
                except TypeError:
                    pass
            st = rec.get("stats")
            if isinstance(st, dict):
                hits += int(st.get("hits") or 0)
                misses += int(st.get("misses") or 0)
                cold_s += float(st.get("cold_wall_s") or 0)
                warm_s += float(st.get("warm_wall_s") or 0)
            if rec.get("pid") is not None:
                pids.add(rec["pid"])
        return {"path": self.path, "shapes": len(shapes),
                "hits": hits, "misses": misses,
                "cold_wall_s": round(cold_s, 3),
                "warm_wall_s": round(warm_s, 3),
                "processes": len(pids)}


def fold_walls(records):
    """``(cold_wall_s, warm_wall_s)`` over campaign cell records: the
    total wall of cells whose compile-cache delta had misses (first
    sightings) vs all-hit cells. One definition, shared by the
    scheduler and fleet finalize paths, so the ledger's cold/warm
    evidence can't silently diverge between the two."""
    cold = sum(float(r.get("wall_s") or 0) for r in records
               if (r.get("compile-cache") or {}).get("misses"))
    warm = sum(float(r.get("wall_s") or 0) for r in records
               if r.get("compile-cache")
               and not r["compile-cache"].get("misses"))
    return cold, warm


def attach(dir=None, jax_cache=True):  # noqa: A002 - mirrors Ledger
    """Attach a persistent ledger to ``campaign.compile_cache`` (the
    note() path consults it from then on) and seed the in-memory seen
    set from disk, so shapes compiled by earlier/concurrent processes
    count as hits immediately. Idempotent per directory: re-attaching
    the same directory reuses the live handle (nested campaign runs in
    one process must not reset each other's offsets).

    ``jax_cache`` is accepted for the reference's signature and does
    nothing: the port has no per-shape compile cache to point at the
    store (the rollout library is reused by ``_build``)."""
    from ..campaign import compile_cache
    led = compile_cache.get_ledger()
    target = os.path.abspath(dir or store.compile_ledger_path())
    if led is not None and led.dir == target:
        return led
    led = Ledger(target)
    led.refresh()
    compile_cache.set_ledger(led)
    return led


def attached():
    """The currently attached Ledger, or None."""
    from ..campaign import compile_cache
    return compile_cache.get_ledger()


def detach(expected=None):
    """Detach the persistent ledger (in-memory counting continues).
    With ``expected``, detaches only if that handle is still the
    attached one -- overlapping campaigns must not sever a sibling's
    ledger."""
    from ..campaign import compile_cache
    if expected is not None and compile_cache.get_ledger() is not expected:
        return
    compile_cache.set_ledger(None)
