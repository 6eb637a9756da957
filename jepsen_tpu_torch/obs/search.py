"""Search telemetry for the device WGL engines (the port's copy of
``jepsen_tpu/obs/search.py``; host-only).

A long linearizability search is otherwise silent until its verdict.
These helpers give the port's host loops -- the single-key search
(``checker/torch_wgl.py``), the key batch (``parallel/keyshard.py``),
the lane-batched frontier fold (``checker/streamlin.batch_fold``) and
the stream checker (``monitor/wgl_stream.StreamCheck``) -- one cheap
call per dispatch:

* `plan()` records, once per search, the padded batch's composition --
  real vs padding rows per power-of-two n-bucket -- so per-bucket
  padding waste is a measured series, not a guess;
* `heartbeat()` emits an instant trace event + counter tracks
  (frontier depth, states explored, deepest linearized op, keys still
  running), updates gauges, and accumulates the device-busy wall
  (``wgl.device_busy_s``: the ``device`` phase bracket when
  ``obs.phases`` measured one for the dispatch, else the full chunk
  wall, whose per-dispatch distribution ``wgl.chunk_s`` keeps either
  way). On the port that bracket is dispatch to a device synchronize
  of a loop of small torch launches, so it is mostly host launch time,
  not the card's busy share;
* `summary()` records the final verdict's telemetry (states explored,
  chunk count, iteration count, dedup-table load / insert failures)
  into the metrics registry.

Engines call `capture()` ONCE at search entry and use the returned
session for every emission. The session pins the sinks resolved
through ``obs.current_sinks()`` when the search STARTED: the
RUN-SCOPED pair when inside a run scope (two concurrent campaign
cells' searches each write their own {campaign, cell}-labelled
series instead of folding into whichever cell bound last), else the
process globals. The checker competition abandons losing engine
threads after a 0.5 s join, and a straggler reading the process-global
sinks per call would write phantom heartbeats into the NEXT run's
artifacts. With captured sinks a straggler keeps streaming into its own
(already discarded) buffers — harmless.

Everything no-ops while obs is unbound, so the engines pay one global
read per search plus cheap None checks per dispatched chunk when
tracing is off — the loops' own device syncs dominate by orders of
magnitude.
"""

from __future__ import annotations

import time as _time

from . import current_sinks, run_config

__all__ = ["capture", "enabled", "SearchObs",
           "HEARTBEAT_MIN_INTERVAL_S"]

#: wall-time buckets for per-chunk dispatch latency: chunks target
#: ~1-3 s; the tail buckets catch stalled dispatches
CHUNK_BUCKETS_S = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0, 600.0)

#: the fastest cadence heartbeats can fire at: one per host→device
#: dispatch, and the batch loop targets ~1 s dispatches. A
#: ``progress-interval-s`` below this cannot make progress telemetry
#: any fresher (planlint PL019 warns on it).
HEARTBEAT_MIN_INTERVAL_S = 1.0


def enabled():
    """Whether obs sinks are currently resolvable (for gating extra
    host work like device reads before a `capture()`d session
    exists)."""
    tr, reg = current_sinks()
    return tr is not None or reg is not None


def capture():
    """Snapshot this context's sinks (run-scoped when inside a run,
    else the globals) into a search session, along with the run's
    progress-telemetry cadence config."""
    tr, reg = current_sinks()
    cfg = run_config()
    return SearchObs(tr, reg,
                     min_interval_s=cfg.get("progress-interval-s"))


class SearchObs:
    """One search's telemetry channel, pinned to the sinks resolved at
    search start (see module docstring for why not per-call globals).

    ``min_interval_s`` throttles the per-dispatch TRACE emission +
    journal flush (the disk-touching parts) to at most one per
    interval; registry counters/gauges always update, so the busy-wall
    and explored accounting stay exact whatever the cadence."""

    def __init__(self, tr, reg, min_interval_s=None):
        self._tr = tr
        self._reg = reg
        try:
            self._min_interval = max(0.0, float(min_interval_s or 0.0))
        except (TypeError, ValueError):
            self._min_interval = 0.0
        # None until the first emission: 0.0 would throttle the
        # FIRST heartbeat on a freshly-booted host (monotonic()
        # counts from boot, so now - 0.0 can sit under a long
        # interval for the machine's first hours)
        self._last_emit = None

    def enabled(self):
        return self._tr is not None or self._reg is not None

    def plan(self, engine, n_bucket, rows_real, rows_total, keys=None,
             lanes=None, owners=None):
        """Record one search's padded-batch composition, once at
        entry: ``rows_real`` real op rows landed in a padded batch of
        ``rows_total`` rows (``lanes`` x ``n_bucket`` for the key
        batch). The per-bucket real/padded counters are what the
        campaign fold renders as the padding-waste table. ``owners``
        is the distinct-tenant count of a cross-tenant service batch
        (keyshard passes it through; absent everywhere else)."""
        tr, reg = self._tr, self._reg
        if tr is None and reg is None:
            return
        rows_real = int(rows_real)
        rows_total = int(rows_total)
        padded = max(0, rows_total - rows_real)
        if reg is not None:
            b = str(int(n_bucket))
            reg.inc("wgl.cells_real", rows_real, engine=engine,
                    bucket=b)
            reg.inc("wgl.cells_padded", padded, engine=engine,
                    bucket=b)
        if tr is not None:
            fields = {"bucket": int(n_bucket), "rows_real": rows_real,
                      "rows_padded": padded,
                      "waste_frac": round(padded / rows_total, 4)
                      if rows_total else 0.0}
            if keys is not None:
                fields["keys"] = int(keys)
            if lanes is not None:
                fields["lanes"] = int(lanes)
            if owners is not None:
                fields["owners"] = int(owners)
            tr.instant(f"wgl.plan.{engine}", cat="search", args=fields)

    def heartbeat(self, engine, iteration, chunk_s, device_s=None,
                  frontier=None, explored=None, depth=None,
                  keys_alive=None, keys_running=None, compactions=None,
                  shard_tops=None, **extra):
        """One call per host→device dispatch. ``frontier`` is the DFS
        stack depth (scalar, or summed over keys), ``explored`` the
        cumulative states-explored counter, ``depth`` the deepest
        linearized-ok-op count reached so far (the "wedged at op K
        with frontier F" watchdog signal — progress toward n_ok),
        ``shard_tops`` the per-shard frontier sizes (the steal-ring
        balance signal). ``device_s`` is the device-compute bracket
        (the phase plane's ``block_until_ready`` measurement): when
        given, it — not the full chunk wall — feeds the duty-cycle
        numerator."""
        tr, reg = self._tr, self._reg
        if tr is None and reg is None:
            return
        if reg is not None:
            reg.inc("wgl.chunks", engine=engine)
            reg.observe("wgl.chunk_s", chunk_s,
                        buckets=CHUNK_BUCKETS_S, engine=engine)
            # duty-cycle numerator: the DEVICE-COMPUTE wall when the
            # engine measured one (obs.phases bracket), else the full
            # chunk wall (phase attribution off: the dispatch's sync
            # rides the loop's status read, so chunk_s is the only
            # device-occupancy bound available — the pre-phase
            # behavior). Either way busy <= the wgl.chunk_s sum.
            reg.inc("wgl.device_busy_s",
                    float(device_s if device_s is not None
                          else chunk_s), engine=engine)
        fields = {"iteration": iteration, "chunk_s": round(chunk_s, 4)}
        if device_s is not None:
            fields["device_s"] = round(float(device_s), 4)
        track = {}
        if frontier is not None:
            fields["frontier"] = track["frontier"] = int(frontier)
            if reg is not None:
                reg.set_gauge("wgl.frontier_depth", int(frontier),
                              engine=engine)
                reg.max_gauge("wgl.frontier_depth_max", int(frontier),
                              engine=engine)
        if explored is not None:
            fields["explored"] = track["explored"] = int(explored)
            if reg is not None:
                reg.set_gauge("wgl.states_explored", int(explored),
                              engine=engine)
        if depth is not None:
            fields["depth"] = track["depth"] = int(depth)
            if reg is not None:
                # the deepest linearized-ok count is monotone per
                # search; max_gauge keeps it monotone across the
                # compaction rebuilds of the batch path too
                reg.max_gauge("wgl.search_depth", int(depth),
                              engine=engine)
        if keys_alive is not None:
            fields["keys_alive"] = int(keys_alive)
        if keys_running is not None:
            fields["keys_running"] = track["keys_running"] = \
                int(keys_running)
            if reg is not None:
                reg.set_gauge("wgl.keys_running", int(keys_running),
                              engine=engine)
        if compactions is not None:
            fields["compactions"] = int(compactions)
        if shard_tops is not None:
            tops = [int(t) for t in shard_tops]
            fields["shard_tops"] = tops
            busy = sum(1 for t in tops if t > 0)
            fields["shards_with_work"] = track["shards_with_work"] = busy
            if reg is not None:
                reg.set_gauge("wgl.shards_with_work", busy,
                              engine=engine)
        fields.update(extra)
        # trace emission + journal flush throttle: registry state
        # above is already current, so skipping the disk-touching
        # tail only coarsens the TRACE's sampling of it
        now = _time.monotonic()
        if self._min_interval and self._last_emit is not None \
                and now - self._last_emit < self._min_interval:
            return
        self._last_emit = now
        if tr is not None:
            tr.instant(f"wgl.heartbeat.{engine}", cat="search",
                       args=fields)
            if track:
                tr.counter(f"wgl.{engine}", track, cat="search")
        # push the journals' buffered tail to disk NOW: heartbeats
        # used to be snapshot-at-end only, so a wedged search the
        # watchdog killed left no trace of how far it got. With the
        # incremental journals attached (store.open_obs_journals) the
        # last heartbeat before the kill is always readable. One
        # flush per host->device dispatch (~seconds apart): noise
        # next to the device sync it rides behind.
        if tr is not None:
            tr.flush_journal()
        if reg is not None:
            reg.journal_now()

    def summary(self, engine, result, keys=None, shard_explored=None):
        """Record a finished search's telemetry from its result dict."""
        tr, reg = self._tr, self._reg
        if tr is None and reg is None:
            return
        verdict = result.get("valid")
        if reg is not None:
            reg.inc("wgl.searches", engine=engine)
            reg.inc("wgl.verdicts", engine=engine, valid=str(verdict))
            if result.get("configs_explored") is not None:
                reg.inc("wgl.states_explored_total",
                        int(result["configs_explored"]), engine=engine)
            if result.get("iterations") is not None:
                reg.inc("wgl.iterations_total",
                        int(result["iterations"]), engine=engine)
            if result.get("table_load") is not None:
                reg.set_gauge("wgl.table_load", result["table_load"],
                              engine=engine)
            if result.get("table_insert_failures") is not None:
                reg.inc("wgl.table_insert_failures",
                        int(result["table_insert_failures"]),
                        engine=engine)
        if tr is not None:
            fields = {k: result.get(k) for k in
                      ("valid", "configs_explored", "iterations",
                       "engine", "table_load", "table_insert_failures",
                       "error")
                      if result.get(k) is not None}
            if keys is not None:
                fields["keys"] = int(keys)
            if shard_explored is not None:
                fields["shard_explored"] = [int(x)
                                            for x in shard_explored]
                # work-split imbalance: max shard share of the total
                total = sum(fields["shard_explored"]) or 1
                fields["shard_max_share"] = round(
                    max(fields["shard_explored"]) / total, 4)
            fields["valid"] = str(verdict)
            tr.instant(f"wgl.done.{engine}", cat="search", args=fields)
