"""The interpreter: runs a generator against real clients and a nemesis,
producing a history (reference jepsen/src/jepsen/generator/interpreter.clj).

Architecture mirrors the reference exactly: a single-threaded event loop
plus one worker thread per logical worker (n client threads + the nemesis).
Each worker has a 1-slot inbox; completions flow back through one shared
unbounded queue (so puts never block, even from retired zombie workers).
The loop prioritizes completions (they are latency-sensitive), then asks
the generator for the next invocation, dispatching when its scheduled time
arrives (interpreter.clj:181-310).

Fault tolerance (robust) layers three crash-only behaviors on
top, each off by default:

* ``test["op-timeout-ms"]`` arms a wedged-worker watchdog: an op blocking
  past its deadline completes as ``:info`` with ``error="harness-timeout"``,
  the stuck worker is retired to a zombie pool, and a replacement worker
  serves the successor process.
* ``test["abort"]`` (an `robust.AbortLatch`, installed by core.run) and
  ``test["time-limit-s"]`` stop new invocations at the generator boundary,
  drain outstanding ops for ``test["abort-grace-s"]`` seconds, and return
  the partial history; ``test["aborted"]`` records the reason.
* ``test["partial-history"]`` exposes the live history list and
  ``test["journal"]`` (a `store.HistoryJournal`) receives every op as it
  lands, so an abort -- even SIGKILL -- never discards the history-so-far.

History ops additionally fan out to ``test["op-sinks"]`` -- a list of
callables invoked once per recorded op, AFTER the single point where
``__op_serial__`` stripping and zombie-completion dropping happen, so
every subscriber sees exactly the ops the history holds, in history
order, on the event-loop thread. The store journal and the streaming
monitor (``monitor.core``) both subscribe this way; sinks must be
fast, must not mutate the op, and a raising sink is logged and
detached rather than allowed to take down the run.
"""

from __future__ import annotations

import contextvars
import itertools
import logging
import queue
import threading
import time as _time

from . import client as jclient
from . import obs
from . import robust
from . import util
from . import generator as gen
from .robust.watchdog import WATCHDOG_FIRED

logger = logging.getLogger(__name__)

#: max µs to wait before re-polling a PENDING generator
#: (interpreter.clj:166-170)
MAX_PENDING_INTERVAL = 1000

#: max seconds the loop blocks on the completion queue while an abort
#: latch / hard deadline could fire -- bounds abort-detection latency
ABORT_POLL_CAP_S = 0.25

#: seconds outstanding ops get to drain after an abort before they are
#: written off as :info (test["abort-grace-s"] overrides)
DEFAULT_ABORT_GRACE_S = 10.0

#: bounded join for live (idle) workers at shutdown
WORKER_JOIN_TIMEOUT_S = 10.0

#: completions between folds of the locally-batched per-op metrics
#: into the obs registry (see the fold in `_run`): small enough that
#: journal staleness stays far below the telemetry flush cadence,
#: large enough that the per-op hot path never pays a facade call
_OBS_FOLD_OPS = 64

#: bounded join for zombie (wedged) workers -- they will almost never
#: exit; this is a courtesy poll before counting them leaked
ZOMBIE_JOIN_TIMEOUT_S = 0.05

#: private key stamping each dispatched op copy with a serial so late
#: completions from retired zombie workers can be told apart from the
#: replacement worker's traffic (stripped before history/generator)
_SERIAL = "__op_serial__"

_EXIT = {"type": "exit"}


class Worker:
    """Single-threaded stateful worker (interpreter.clj:19-31)."""

    def open(self, test, wid):
        return self

    def invoke(self, test, op):
        raise NotImplementedError

    def close(self, test):
        pass


class ClientWorker(Worker):
    """Runs ops against (client test); crashed clients are closed and
    reopened for the successor process unless reusable
    (interpreter.clj:33-67)."""

    def __init__(self, node):
        self.node = node
        self.process = None
        self.client = None

    def invoke(self, test, op):
        if self.process != op["process"] and not (
                self.client is not None
                and self.client.reusable(test)):
            self.close(test)
            try:
                self.client = jclient.validate(test["client"]) \
                    .open(test, self.node)
                self.process = op["process"]
            except Exception as e:  # noqa: BLE001 - mirrors reference
                logger.warning("Error opening client: %s", e)
                self.client = None
                out = dict(op)
                out["type"] = "fail"
                out["error"] = ["no-client", str(e)]
                return out
        else:
            self.process = op["process"]
        return self.client.invoke(test, op)

    def close(self, test):
        if self.client is not None:
            self.client.close(test)
            self.client = None


class NemesisWorker(Worker):
    def invoke(self, test, op):
        return test["nemesis"].invoke(test, op)


class ClientNemesisWorker(Worker):
    """Spawns client workers for integer ids, nemesis workers otherwise
    (interpreter.clj:78-95)."""

    def open(self, test, wid):
        if isinstance(wid, int):
            nodes = test.get("nodes") or [None]
            return ClientWorker(nodes[wid % len(nodes)])
        return NemesisWorker()


def goes_in_history(op):
    """:sleep and :log ops don't belong in the history
    (interpreter.clj:172-178)."""
    return op.get("type") not in ("sleep", "log")


def _spawn_worker(test, completions, worker, wid):
    """Spawn a worker thread with a 1-slot inbox (interpreter.clj:99-164)."""
    inbox = queue.Queue(maxsize=1)

    def loop():
        w = worker.open(test, wid)
        try:
            while True:
                op = inbox.get()
                t = op.get("type")
                if t == "exit":
                    return
                # the serial stays between the event loop and this
                # shell: clients/nemeses must never see it (and may
                # build completions from scratch anyway), so pop it
                # here and re-stamp whatever comes back
                serial = op.pop(_SERIAL, None)

                def put(out, serial=serial):
                    if serial is not None and isinstance(out, dict):
                        out = dict(out)
                        out[_SERIAL] = serial
                    completions.put(out)

                try:
                    if t == "sleep":
                        _time.sleep(op["value"])
                        put(op)
                    elif t == "log":
                        logger.info("%s", op.get("value"))
                        put(op)
                    else:
                        put(w.invoke(test, op))
                except Exception as e:  # noqa: BLE001 - crash -> info op
                    logger.warning("Process %r crashed: %s",
                                   op.get("process"), e)
                    out = dict(op)
                    out["type"] = "info"
                    out["exception"] = repr(e)
                    out["error"] = f"indeterminate: {e}"
                    put(out)
        finally:
            w.close(test)

    # run the worker in a snapshot of the spawning thread's context so
    # control-plane session bindings (c.ssh_scope) reach client/nemesis
    # invocations on this thread
    ctx = contextvars.copy_context()
    thread = threading.Thread(target=ctx.run, args=(loop,), daemon=True,
                              name=f"jepsen worker {wid}")
    thread.start()
    return {"id": wid, "inbox": inbox, "thread": thread}


def run(test):
    """Evaluate all ops from test["generator"], dispatching to workers
    driving test["client"] / test["nemesis"]. Returns the history
    (interpreter.clj:181-310)."""
    with util.ensure_relative_time():
        return _run(test)


def _trace_tid(thread):
    """Logical worker -> Chrome-trace tid: client workers keep their
    integer ids; the nemesis gets -1 (trace tids must be numeric)."""
    return thread if isinstance(thread, int) else -1


def _stop_workers(workers, zombies=()):
    """Shut every worker down with BOUNDED waits: offer _EXIT without
    blocking (draining a stale inbox slot if needed), join live workers
    briefly, poll zombies once, and count whatever is still alive as a
    leaked thread (``robust.leaked_threads`` in metrics.json) instead of
    hanging the harness on it."""
    for w in workers:
        for _ in range(64):
            if not w["thread"].is_alive():
                break
            try:
                w["inbox"].put_nowait(_EXIT)
                break
            except queue.Full:
                try:
                    w["inbox"].get_nowait()
                except queue.Empty:
                    pass
    leaked = 0
    # one shared deadline: k wedged workers cost ~10s total, not k*10s
    deadline = _time.monotonic() + WORKER_JOIN_TIMEOUT_S
    for w in workers:
        w["thread"].join(max(0.0, deadline - _time.monotonic()))
        if w["thread"].is_alive():
            leaked += 1
            logger.warning("Worker %r did not exit within %.0fs; "
                           "abandoning its thread", w["id"],
                           WORKER_JOIN_TIMEOUT_S)
    for z in zombies:
        z["thread"].join(ZOMBIE_JOIN_TIMEOUT_S)
        if z["thread"].is_alive():
            leaked += 1
    if leaked:
        obs.inc("robust.leaked_threads", leaked)
    return leaked


def _run(test):
    ctx = gen.context(test)
    worker_ids = ctx.all_threads()
    # unbounded: zombie workers may complete late, and their puts must
    # never block a thread we have already written off
    completions = queue.Queue()
    workers = {wid: _spawn_worker(test, completions, ClientNemesisWorker(),
                                  wid)
               for wid in worker_ids}
    zombies = []
    g = gen.validate(gen.friendly_exceptions(test.get("generator")))
    if obs.enabled():
        for wid in worker_ids:
            obs.name_thread(_trace_tid(wid), f"worker {wid}")

    # -- fault-tolerance wiring (all optional, all default-off) --------
    latch = test.get("abort")
    op_timeout_ms = test.get("op-timeout-ms")
    watchdog = robust.OpWatchdog(op_timeout_ms / 1000.0, completions) \
        if op_timeout_ms else None
    time_limit_s = test.get("time-limit-s")
    hard_deadline = (_time.monotonic() + time_limit_s) if time_limit_s \
        else None
    grace_s = test.get("abort-grace-s", DEFAULT_ABORT_GRACE_S)
    # multi-subscriber op tap: journal + any test["op-sinks"] callables
    # all receive each recorded op exactly once, post serial-strip and
    # zombie-drop (the journal and the monitor need the same feed, so
    # the tap is a fan-out list)
    sinks = [s for s in (test.get("op-sinks") or ()) if callable(s)]
    journal = test.get("journal")
    if journal is not None:
        sinks.append(journal.append)
    serial_counter = itertools.count(1)
    serials = {}         # thread -> serial of its outstanding op
    inflight_ops = {}    # thread -> the (clean) outstanding invocation
    drain_deadline = None

    outstanding = 0
    poll_timeout = 0.0   # seconds
    history = []
    # live view for core.run's salvage path: on any abort the history
    # collected so far is recoverable from the test map
    test["partial-history"] = history
    # per-thread invoke timestamps (tracer clock) for the invoke->
    # complete op spans; at most one op is outstanding per thread
    inflight = {}
    # per-op metrics fold: the registry facade costs microseconds per
    # call and every call here rides the serial hot loop, so counters
    # and latency observations accumulate in plain locals and fold
    # every _OBS_FOLD_OPS completions (and at every abort/exit edge).
    # Totals are exact; metrics-journal staleness stays bounded well
    # below the telemetry flush cadence. Trace spans are NOT batched —
    # every op still gets its event the moment it completes.
    obs_lat = []
    obs_counts = {}     # (counter, type-or-None, f) -> n

    def fold_obs():
        for (cname, ty, f), n in obs_counts.items():
            if ty is None:
                obs.inc(cname, n, f=f)
            else:
                obs.inc(cname, n, type=ty, f=f)
        obs_counts.clear()
        if obs_lat:
            obs.observe_many("interpreter.op_latency_s", obs_lat)
            obs_lat.clear()

    def record(op):
        history.append(op)
        for sink in list(sinks):
            try:
                sink(op)
            except Exception:  # noqa: BLE001 - a sink must not kill the run
                logger.warning("op sink %r failed; detaching it", sink,
                               exc_info=True)
                sinks.remove(sink)

    def process_completion(op2):
        """The completion half of the loop body, shared by real worker
        completions and watchdog/abort-synthesized :info ops."""
        nonlocal ctx, g, outstanding
        thread = ctx.process_to_thread(op2["process"])
        now = util.relative_time_nanos()
        op2 = dict(op2)
        op2.pop(_SERIAL, None)
        op2["time"] = now
        ctx = ctx.with_time(now).free(thread)
        if obs.enabled():
            start = inflight.pop(thread, None)
            if start is not None:
                t1 = obs.now_ns()
                obs.complete(
                    str(op2.get("f")), start, t1 - start,
                    cat="op", tid=_trace_tid(thread),
                    process=op2.get("process"),
                    type=op2.get("type"))
                obs_lat.append((t1 - start) / 1e9)
            if goes_in_history(op2):
                k = ("interpreter.ops_completed",
                     str(op2.get("type")), str(op2.get("f")))
                obs_counts[k] = obs_counts.get(k, 0) + 1
            if len(obs_lat) >= _OBS_FOLD_OPS:
                fold_obs()
        g = gen.gen_update(g, test, ctx, op2)
        if thread != gen.NEMESIS and op2.get("type") == "info":
            ctx = ctx.with_worker(thread, ctx.next_process(thread))
        if goes_in_history(op2):
            record(op2)
        outstanding -= 1

    def retire_worker(thread, synthesized_error, respawn=True):
        """Retire a wedged worker to the zombie pool and synthesize the
        :info completion for its outstanding op; with ``respawn``, spawn
        a fresh worker for the same logical id (the successor process is
        assigned by the normal info-completion path). The final drain
        write-off passes respawn=False -- the loop is about to return,
        so a replacement would only be spawned to be shut down."""
        op = inflight_ops.pop(thread)
        serials.pop(thread, None)
        zombies.append(workers.pop(thread))
        if respawn:
            workers[thread] = _spawn_worker(test, completions,
                                            ClientNemesisWorker(), thread)
            obs.inc("robust.workers_retired")
        out = dict(op)
        out["type"] = "info"
        out["error"] = synthesized_error
        process_completion(out)

    def finish():
        fold_obs()
        if watchdog is not None:
            watchdog.stop()
        _stop_workers(list(workers.values()), zombies)
        test.pop("partial-history", None)
        return history

    try:
        while True:
            op2 = None
            try:
                if poll_timeout > 0:
                    timeout = poll_timeout
                    if latch is not None or hard_deadline is not None:
                        timeout = min(timeout, ABORT_POLL_CAP_S)
                    op2 = completions.get(timeout=timeout)
                else:
                    op2 = completions.get_nowait()
            except queue.Empty:
                op2 = None

            if op2 is not None and WATCHDOG_FIRED in op2:
                wid, serial, _op = op2[WATCHDOG_FIRED]
                # advisory: a real completion may have raced the deadline
                if serials.get(wid) == serial:
                    retire_worker(wid, "harness-timeout")
                    poll_timeout = 0.0
                continue

            if op2 is not None:
                serial = op2.get(_SERIAL)
                thread = ctx.process_to_thread(op2["process"])
                if thread is None or (serial is not None
                                      and serials.get(thread) != serial):
                    # late completion from a retired zombie worker: its
                    # op already completed as :info harness-timeout
                    obs.inc("robust.late_completions")
                    logger.info("Dropping late completion from retired "
                                "worker: %r",
                                {k: op2.get(k) for k in ("process", "f",
                                                         "type")})
                    continue
                if serials.get(thread) is not None:
                    if watchdog is not None:
                        watchdog.disarm(thread, serials[thread])
                    serials.pop(thread, None)
                inflight_ops.pop(thread, None)
                process_completion(op2)
                poll_timeout = 0.0
                continue

            # -- abort latch / hard deadline (generator boundary) ------
            if drain_deadline is None and (
                    (latch is not None and latch.is_set())
                    or (hard_deadline is not None
                        and _time.monotonic() >= hard_deadline)):
                reason = (latch.reason if latch is not None
                          and latch.is_set() else None) or "time-limit"
                test["aborted"] = reason
                drain_deadline = _time.monotonic() + grace_s
                logger.warning(
                    "Abort (%s): no new ops; draining %d outstanding "
                    "op(s) for up to %.0fs", reason, outstanding, grace_s)
                fold_obs()
                obs.inc("robust.aborts", reason=reason)
                obs.instant("interpreter.abort", cat="lifecycle",
                            reason=reason, outstanding=outstanding)
                obs.flush()

            if drain_deadline is not None:
                if outstanding == 0:
                    return finish()
                if _time.monotonic() >= drain_deadline:
                    logger.warning(
                        "Drain grace expired; writing off %d op(s) as "
                        ":info harness-abort", outstanding)
                    for thread in list(inflight_ops):
                        retire_worker(thread, "harness-abort",
                                      respawn=False)
                    return finish()
                poll_timeout = min(
                    MAX_PENDING_INTERVAL / 1e6 * 50,
                    max(drain_deadline - _time.monotonic(), 0.001))
                continue

            now = util.relative_time_nanos()
            ctx = ctx.with_time(now)
            res = gen.gen_op(g, test, ctx)

            if res is None:
                if outstanding > 0:
                    poll_timeout = MAX_PENDING_INTERVAL / 1e6
                    continue
                return finish()

            op, g2 = res
            if op is gen.PENDING:
                # NB: do NOT commit g2 -- generator state advances only
                # when an op is actually dispatched (the reference recurs
                # with the old gen on :pending, interpreter.clj:264)
                poll_timeout = MAX_PENDING_INTERVAL / 1e6
                continue

            if now < op["time"]:
                # not yet time for this op; wait (but serve completions)
                poll_timeout = (op["time"] - now) / 1e9
                continue

            thread = ctx.process_to_thread(op["process"])
            serial = next(serial_counter)
            wop = dict(op)
            wop[_SERIAL] = serial
            workers[thread]["inbox"].put(wop)
            serials[thread] = serial
            if goes_in_history(op):
                inflight_ops[thread] = op
                if watchdog is not None:
                    watchdog.arm(thread, serial, op)
            if obs.enabled() and op.get("type") == "invoke":
                inflight[thread] = obs.now_ns()
                k = ("interpreter.ops_invoked", None,
                     str(op.get("f")))
                obs_counts[k] = obs_counts.get(k, 0) + 1
            ctx = ctx.with_time(op["time"]).busy(thread)
            g = gen.gen_update(g2, test, ctx, op)
            if goes_in_history(op):
                record(op)
            outstanding += 1
            poll_timeout = 0.0
    except BaseException:  # noqa: BLE001 - workers must exit on ANY abort
        logger.info("Shutting down workers after abnormal exit")
        fold_obs()
        if watchdog is not None:
            watchdog.stop()
        # bounded: a wedged worker is abandoned and counted, never joined
        # forever (test["partial-history"] stays set for core.run salvage)
        _stop_workers(list(workers.values()), zombies)
        raise
