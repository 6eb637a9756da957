"""The monitor thread: consume the live op stream, extend the WGL
verdict chunk by chunk, abort the run on violation (the port of
``jepsen_tpu/monitor/core.py``).

Threading contract:

* ``offer(op)`` runs on the interpreter's event-loop thread for every
  history op, after serial-stripping and zombie filtering (the op-sink
  fan-out in interpreter.py). It appends to a deque and occasionally
  notifies -- the whole per-op cost the interpreter pays.
* one daemon thread (``jepsen monitor``) drains the deque, feeds the
  per-key `StreamEncoder`s, and runs a prefix check over every key
  that saw new completions once ``chunk`` completions accumulated. Its
  device checks (``jax-wgl``: ``torch_wgl`` with the rollout kernel;
  ``streamlin``: ``StreamCheck``'s fold) run on ``engine_opts["device"]``
  (None: CUDA).
* ``stop()`` is idempotent and bounded: it asks the thread to finish
  (draining + one final check so the verdict covers everything
  consumed), joins with a timeout, and cancels a wedged device check
  through the engines' ``cancel`` event rather than waiting forever.

Verdict semantics: the monitor re-checks the *prefix*, so its False is
exactly the offline checker's False on the same cut -- the acceptance
property tests equivalence across chunk sizes. "unknown" checks never
abort anything; they are counted and the offline checker keeps the
final word.

Unlike the JAX package, no error is contained: a monitor that cannot be
built raises from ``install`` before the first op, and an exception on
the monitor thread aborts the run (reason ``"monitor-error"``) and is
re-raised on the run's thread by ``stop``/``finalize`` once the thread
is joined. Only the quiescent-cut carry's host bookkeeping stays
contained (it can cost, never change, a verdict), counted in
``carry_failures``.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time as _time

from .. import independent
from .. import obs
from .. import resolve_device
from .. import robust
from ..obs import phases as obs_phases
from ..checker.core import merge_valid
from . import engine as mengine
from .stream import StreamEncoder

logger = logging.getLogger(__name__)

__all__ = ["ABORT_REASON", "DEFAULT_CHUNK", "ERROR_REASON", "Monitor",
           "config", "find_linearizable", "install", "finalize"]

#: completed client ops per monitor step (pow-2 so encoded prefixes
#: cross shape buckets as rarely as possible)
DEFAULT_CHUNK = 64

#: bounded join for the monitor thread at stop(); a device check that
#: outlives this is cancelled, then given a short grace
STOP_JOIN_S = 60.0
CANCEL_JOIN_S = 5.0

#: latch reason for monitor-triggered aborts (campaign outcome logic
#: and docs key off this string)
ABORT_REASON = "monitor-violation"

#: latch reason when the monitor thread itself raised; ``finalize``
#: re-raises the exception once the thread is joined
ERROR_REASON = "monitor-error"


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


class _MonitorThread:
    """The threading contract both monitors share: O(1) ``offer`` on the
    event-loop thread, one daemon chunk thread running ``_step``, a
    bounded idempotent ``stop`` that re-raises an exception of the
    thread once it is joined. Subclasses set ``chunk``, ``latch`` and
    ``violation`` and define ``_step``."""

    _thread_name = "jepsen monitor"

    def _init_thread(self):
        self._tr, self._reg = obs.current_sinks()
        self._cancel = threading.Event()
        self._cond = threading.Condition()
        self._queue = collections.deque()   # (op, index, t_offer)
        self._pending_completions = 0
        self._n_seen = 0
        self._stopping = False
        self._finish = True
        #: the exception the monitor thread raised (re-raised by stop)
        self.error = None
        self._raised = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=self._thread_name)

    # -- interpreter side --------------------------------------------------

    def offer(self, op):
        """Op-sink entry: called on the event-loop thread per history
        op. O(1); never raises."""
        try:
            with self._cond:
                idx = self._n_seen
                self._n_seen += 1
                if self.violation is not None or self._stopping:
                    return
                self._queue.append((op, idx, _time.monotonic()))
                if op.get("type") != "invoke" \
                        and isinstance(op.get("process"), int):
                    self._pending_completions += 1
                    if self._pending_completions >= self.chunk:
                        self._cond.notify()
        except Exception:  # noqa: BLE001 - must never hurt the run
            logger.warning("monitor offer failed", exc_info=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._thread.start()
        return self

    def stop(self, finish=True, timeout_s=STOP_JOIN_S):
        """Ask the thread to wrap up and join (idempotent). With
        ``finish`` the thread drains the queue and runs one last check
        over every dirty key, so the summary verdict covers the whole
        consumed stream; without it (crash paths) the thread exits at
        the next opportunity. An exception the thread raised is
        re-raised here, once."""
        with self._cond:
            self._stopping = True
            self._finish = self._finish and finish
            self._cond.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout_s)
            if self._thread.is_alive():
                self._cancel.set()
                self._thread.join(CANCEL_JOIN_S)
                if self._thread.is_alive():
                    logger.warning("monitor thread did not exit; "
                                   "abandoning")
                    self._inc("robust.leaked_threads")
        if self.error is not None and not self._raised:
            self._raised = True
            raise self.error

    def _inc(self, name, n=1, **labels):
        if self._reg is not None:
            self._reg.inc(name, n, **labels)

    def _loop(self):
        while True:
            with self._cond:
                while (self._pending_completions < self.chunk
                       and not self._stopping
                       and self.violation is None):
                    self._cond.wait(0.25)
                stopping = self._stopping
            if self.violation is not None:
                break
            if stopping:
                if self._finish and not self._cancel.is_set():
                    self._step()
                break
            self._step()

    def _run(self):
        # the monitor thread starts with an empty contextvars context;
        # pin the pair captured at construction as the run-scoped
        # sinks so the device checks it drives (and their search
        # heartbeats) land in THIS run's series
        try:
            with obs.sink_scope(self._tr, self._reg), self._run_span():
                self._loop()
        except BaseException as exc:  # noqa: BLE001 - kept, re-raised
            self.error = exc
            logger.error("monitor thread raised; aborting the run",
                         exc_info=True)
            self.latch.set(ERROR_REASON)

    def _run_span(self):
        return contextlib.nullcontext()


class Monitor(_MonitorThread):
    """One run's streaming monitor. Build via `install(test)`."""

    def __init__(self, spec, latch, chunk=DEFAULT_CHUNK,
                 engine="jax-wgl", engine_opts=None, init_ops=(),
                 keyed=False, device_sem=None, quiescent_carry=True):
        if engine not in mengine.ENGINES:
            raise ValueError(f"unknown monitor engine {engine!r}; "
                             f"expected one of {mengine.ENGINES}")
        self.spec = spec
        self.latch = latch
        self.chunk = max(1, int(chunk))
        self.engine = engine
        self.engine_opts = dict(engine_opts or {})
        if engine in ("jax-wgl", "streamlin"):
            # the device checks run on engine_opts["device"] (None:
            # CUDA): resolved now, so a monitor without its device
            # raises before the run's first op
            resolve_device(self.engine_opts.get("device"))
        self.init_ops = list(init_ops or ())
        self.keyed = keyed
        self.device_sem = device_sem
        #: quiescent-cut carry (analysis/searchplan.py): after a True
        #: prefix verdict, the encoder truncates to the latest sealed
        #: quiescent cut, so crash-free monitored runs re-check
        #: O(window) instead of O(prefix). Off via the monitor config
        #: {"quiescent-carry?": False}.
        self.quiescent_carry = bool(quiescent_carry)
        self.truncated_ops = 0
        #: carries whose host bookkeeping raised (contained: a carry can
        #: cost, never change, a verdict)
        self.carry_failures = 0
        self.violation = None
        #: certifiable violation evidence (encoded prefix + engine
        #: result), parked on the test map by finalize for the
        #: certify backstop in core.analyze
        self.evidence = None
        # sinks captured at construction through the RUN-SCOPED
        # resolution (install runs on the run's own thread inside
        # obs.run_scope)
        self._init_thread()
        self._encoders = {}                 # key -> StreamEncoder
        self._dirty = {}                    # key -> t_offer of newest op
        self._verdicts = {}                 # key -> last check validity
        # counters mirrored into the summary (registry may be absent)
        self.ops_consumed = 0
        self.chunks = 0
        self.checks = 0
        self.unknown_checks = 0
        self.unkeyed_skipped = 0
        self._t_start = _time.monotonic()
        self._t_first_verdict = None

    # -- summary -----------------------------------------------------------

    def summary(self):
        """The ``results["monitor"]`` block."""
        if self.violation is not None:
            verdict = False
        elif self.error is not None:
            verdict = "unknown"
        else:
            verdict = merge_valid(self._verdicts.values()) \
                if self._verdicts else True
        out = {
            "verdict": verdict,
            "engine": self.engine,
            "chunk": self.chunk,
            "ops_consumed": self.ops_consumed,
            "chunks": self.chunks,
            "checks": self.checks,
            "unknown_checks": self.unknown_checks,
            "keys": len(self._encoders),
            "time_to_first_verdict_s": self._t_first_verdict,
        }
        if self.unkeyed_skipped:
            out["unkeyed_ops_skipped"] = self.unkeyed_skipped
        if self.quiescent_carry:
            out["quiescent_truncated_ops"] = self.truncated_ops
        if self.carry_failures:
            out["carry_failures"] = self.carry_failures
        if self.error is not None:
            out["error"] = repr(self.error)
        stream = self._stream_summary()
        if stream is not None:
            out["stream"] = stream
        if self.violation is not None:
            out.update(self.violation)
        return out

    #: stream counters reported as the max across keys (sizes/capacities
    #: describe a single stream's state, not fleet-wide volume)
    _STREAM_MAX_KEYS = ("frontier_size", "frontier_peak", "frontier_cap",
                        "window", "open_slots", "batch_peak")

    def _stream_summary(self):
        """Aggregate per-key StreamCheck telemetry (engine streamlin
        only): counters sum across keys, sizes take the max, and the
        first fall-back reason is surfaced so a degraded run is visible
        in results["monitor"]["stream"]."""
        blocks = [enc.stream_summary() for enc in self._encoders.values()
                  if callable(getattr(enc, "stream_summary", None))]
        if not blocks:
            return None
        out = {}
        for b in blocks:
            for k, v in b.items():
                if k == "fallback":
                    out.setdefault(k, v)
                elif k in self._STREAM_MAX_KEYS:
                    out[k] = max(out.get(k, 0), v)
                else:
                    out[k] = out.get(k, 0) + v
        if "device_s" in out:
            out["device_s"] = round(out["device_s"], 4)
        return out

    # -- monitor thread ----------------------------------------------------

    def _span(self, name, **args):
        if self._tr is None:
            return contextlib.nullcontext()
        return self._tr.span(name, cat="monitor", args=args or None)

    def _run_span(self):
        return self._span("monitor.run", engine=self.engine,
                          chunk=self.chunk)

    def _encoder(self, key):
        enc = self._encoders.get(key)
        if enc is None:
            if self.engine == "streamlin":
                # the device-resident frontier driver; duck-types the
                # StreamEncoder surface and adds check()
                from .wgl_stream import StreamCheck
                enc = StreamCheck(self.spec, self.init_ops,
                                  opts=self.engine_opts,
                                  device=self.engine_opts.get("device"))
            else:
                enc = StreamEncoder(self.spec, self.init_ops)
            self._encoders[key] = enc
        return enc

    def _consume(self, op, idx, t):
        """Feed one event into the right encoder; count completions."""
        if not isinstance(op.get("process"), int):
            return
        if self.keyed:
            v = op.get("value")
            if not independent.is_tuple(v):
                # independent.subhistory replicates un-keyed client ops
                # into every key; the stream can't (later keys don't
                # exist yet), so they are skipped and counted
                self.unkeyed_skipped += 1
                self._inc("monitor.unkeyed_ops_skipped")
                return
            op = dict(op)
            op["value"] = v.value
            key = v.key
        else:
            key = None
        enc = self._encoder(key)
        if enc.offer(op, idx):
            self.ops_consumed += 1
            self._inc("monitor.ops_consumed")
            self._dirty[key] = max(self._dirty.get(key, 0.0), t)

    def _carry(self, enc, e):
        """Truncate a proven prefix at its latest sealed quiescent cut.
        Host bookkeeping only: a failure is counted, never raised."""
        try:
            from ..analysis import searchplan
            cut = searchplan.stream_cut(self.spec, e)
            if cut is not None:
                dropped = enc.truncate_before(*cut)
                if dropped:
                    self.truncated_ops += dropped
                    self._inc("monitor.quiescent_truncated_ops", dropped)
        except Exception:  # noqa: BLE001 - cost only, never a verdict
            self.carry_failures += 1
            self._inc("monitor.carry_failures")
            logger.warning("quiescent-cut carry failed", exc_info=True)

    def _check_key(self, key, t_newest):
        """Materialize + check one key's prefix; returns its validity
        and records a violation on False."""
        enc = self._encoders[key]
        stream = callable(getattr(enc, "check", None))
        e = init_state = None
        if not stream:
            # streamlin keeps the encoded prefix device-resident; the
            # host only materializes it on the flat paths (carry cuts,
            # violation evidence) below
            e, init_state = enc.materialize()
        t0 = _time.monotonic()
        sem = self.device_sem \
            if self.engine in ("jax-wgl", "streamlin") else None
        if sem is not None:
            t_w = _time.monotonic()
            sem.acquire()
            self._inc("monitor.device_waits")
            if self._reg is not None:
                self._reg.observe("monitor.device_wait_s",
                                  _time.monotonic() - t_w)
            # device-slot wait is a named phase in the attribution
            # plane: the engine's own phase spans start only once the
            # semaphore admits the check
            obs_phases.note_wait(self.engine,
                                 _time.monotonic() - t_w)
        try:
            with self._span("monitor.check", key=repr(key),
                            n=len(enc)):
                if stream:
                    r = enc.check(cancel=self._cancel)
                else:
                    r = mengine.check_prefix(
                        self.spec, e, init_state, self.engine,
                        self.engine_opts, cancel=self._cancel)
        finally:
            if sem is not None:
                sem.release()
        dt = _time.monotonic() - t0
        self.checks += 1
        valid = r.get("valid")
        self._inc("monitor.checks", valid=str(valid))
        if self._reg is not None:
            self._reg.observe("monitor.check_s", dt)
        if self._t_first_verdict is None and valid in (True, False):
            self._t_first_verdict = round(
                _time.monotonic() - self._t_start, 4)
            if self._reg is not None:
                self._reg.set_gauge("monitor.time_to_first_verdict_s",
                                    self._t_first_verdict)
        if valid is True and self.quiescent_carry:
            # the whole consumed prefix just proved linearizable:
            # carry the latest sealed quiescent cut so the next check
            # covers only the open window, not the ever-growing prefix
            # (decrease-and-conquer, arxiv 2410.04581)
            if e is None:
                e, init_state = enc.materialize()
            self._carry(enc, e)
        if valid == "unknown":
            self.unknown_checks += 1
            # an undecided check leaves the key "unknown" until a
            # LATER check decides: checks are cumulative prefixes, so
            # a later True covers every earlier cut (prefix-closure of
            # linearizability) and overwrites this. False stays sticky
            # (it can never unhappen, and it already aborted the run).
            if self._verdicts.get(key) is not False:
                self._verdicts[key] = "unknown"
            return "unknown"
        self._verdicts[key] = valid
        if valid is False and self.violation is None:
            if e is None:
                e, init_state = enc.materialize()
            latency = max(0.0, _time.monotonic() - t_newest)
            self.violation = {
                "detected_at_index": enc.last_index,
                "detection_latency_s": round(latency, 4),
                "checked_ops": len(e),
            }
            if self.keyed:
                self.violation["key"] = key
            w = r.get("op")
            if isinstance(w, dict):
                self.violation["detected_op"] = dict(w)
            # park the certifiable evidence: the encoded prefix that
            # decided False plus the engine result. core.analyze's
            # certify backstop replays the witness and cross-checks
            # the prefix through an INDEPENDENT engine -- under
            # ``skip-offline?`` this verdict becomes the verdict of
            # record with no full offline check behind it
            self.evidence = {"e": e, "init_state": init_state,
                             "result": r, "key": key}
            self._inc("monitor.violations")
            if self._reg is not None:
                self._reg.set_gauge("monitor.detection_latency_s",
                                    self.violation["detection_latency_s"])
            if self._tr is not None:
                self._tr.instant("monitor.violation", cat="monitor",
                                 args=dict(self.violation,
                                           detected_op=None))
            logger.warning(
                "MONITOR: non-linearizable prefix detected at history "
                "index %d%s (%.3fs after the op landed); aborting run",
                enc.last_index,
                f" key {key!r}" if self.keyed else "", latency)
            self.latch.set(ABORT_REASON)
        return valid

    def _step(self):
        """Drain the queue and check every key that saw new
        completions (called per chunk, and once more at stop for the
        final flush)."""
        with self._cond:
            batch = list(self._queue)
            self._queue.clear()
            self._pending_completions = 0
        for op, idx, t in batch:
            self._consume(op, idx, t)
        if not self._dirty:
            return
        self.chunks += 1
        self._inc("monitor.chunks")
        dirty, self._dirty = self._dirty, {}
        for key in sorted(dirty, key=repr):
            if self.violation is not None or self._cancel.is_set():
                return
            self._check_key(key, dirty[key])


def install(test):
    """Wire a Monitor into a prepared test map (``core.run`` calls
    this after preflight): discover the Linearizable gate in the
    test's checker tree, chain a per-run abort latch over
    ``test["abort"]``, subscribe to the interpreter's op-sink list,
    and start the thread. Returns the Monitor, or None when monitoring
    is off or the checker tree has no linearizable gate. A monitor that
    cannot be built raises here, before the first op."""
    cfg = config(test)
    if cfg is None:
        return None
    if cfg.get("family") == "txn":
        # transactional family: no linearizable gate to discover; the
        # cycle engine's incremental frontier is the streaming check
        from . import txn as mtxn
        return mtxn.install_txn(test, cfg)
    lin, keyed = find_linearizable(test.get("checker"))
    if lin is None:
        logger.warning(
            "monitor requested but the checker tree has no "
            "linearizable gate (no incremental engine for this "
            "family); monitoring disabled for this run")
        obs.inc("monitor.disabled", reason="no-engine")
        return None
    from ..analysis import searchplan
    engine = cfg.get("engine")
    if engine is None:
        engine = lin.algorithm if lin.algorithm in mengine.ENGINES \
            else "jax-wgl"
    latch = robust.ChainedLatch(test.get("abort"))
    mon = Monitor(
        spec=lin.spec, latch=latch,
        chunk=cfg.get("chunk") or DEFAULT_CHUNK,
        engine=engine,
        engine_opts=cfg.get("engine-opts") or lin.engine_opts,
        init_ops=lin.init_ops, keyed=keyed,
        device_sem=test.get("monitor-device-sem"),
        # the carry honors BOTH knobs: its own monitor option and the
        # test-wide searchplan gate INCLUDING the predicate list (a
        # user disabling the planner or just the crash-segments
        # predicate to rule the cut code out must actually stop it)
        quiescent_carry=(cfg.get("quiescent-carry?", True)
                         and searchplan.segments_enabled(test)))
    test["abort"] = latch
    test.setdefault("op-sinks", []).append(mon.offer)
    obs.inc("monitor.installed", engine=engine)
    return mon.start()


def finalize(mon, test, finish=True):
    """Stop a Monitor and park its summary on the test map
    (idempotent; ``core.run`` calls it on every exit path before
    analyze so the verdict lands in results.json + monitor.json). An
    exception of the monitor thread is re-raised once the summary is
    parked."""
    if mon is None:
        return None
    try:
        mon.stop(finish=finish)
    finally:
        summary = mon.summary()
        test["monitor-verdict"] = summary
        if mon.evidence is not None:
            # non-serializable (arrays + spec): store.py strips it;
            # core.analyze pops it for the certify backstop
            test["monitor-evidence"] = dict(mon.evidence,
                                            spec=mon.spec)
        sinks = test.get("op-sinks")
        if isinstance(sinks, list) and mon.offer in sinks:
            sinks.remove(mon.offer)
    return summary
