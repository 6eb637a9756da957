"""Checking-as-a-service: the logic behind web.py's ``/api/`` routes
(the port's copy of ``jepsen_tpu/fleet/service.py``).

* ``POST /api/check`` -- one history JSON in, one verdict out.
  Pipeline: histlint (malformed histories are a 400 with the
  diagnostics, not a garbage verdict), then the same one-engine
  dispatch the streaming monitor uses (``monitor/engine.py
  check_prefix``), so the service's verdict is by construction the
  offline checker's verdict on that history. Keyed ([k, v]-valued)
  histories split per key as ``independent`` does and merge validity
  the same way.
* ``POST /api/campaigns`` -- a sweep-matrix JSON in, a campaign id
  out; the campaign runs on a background thread through the ordinary
  campaign scheduler (journal, ledger, resume) and its status polls at
  ``GET /api/campaigns/<id>``.
* **Shutdown.** Every submitted campaign's latch chains off one
  service-wide ``robust.AbortLatch``; ``shutdown()`` flips it, so
  stopping the service aborts (and leaves resumable) every campaign it
  accepted.
* **Admission control.** Every request passes the `Admission` gate
  first: token authn (constant-time compare; planlint PL016 makes a
  non-loopback bind without a token a preflight error), per-caller
  budgets (concurrent checks, queued campaigns, ops/day) with a bounded
  admission queue that sheds load as 429 + Retry-After, and a drain on
  shutdown. Rejected or shed requests never touch in-flight work.
* **Cross-tenant batch coalescing.** Admitted ``jax-wgl`` checks would
  each run one device search, serializing behind the card while
  strangers queue (``service.queue_wait_s`` is that wait). Independent
  histories check independently (P-compositionality, arXiv
  1504.00204), so the `Coalescer` holds each submission's planned,
  encoded segments for a short window (default 25 ms) or until a size
  cap, then feeds segments from different callers to one
  ``keyshard.check_batch_encoded`` call. Batches group on ``(model,
  op-count bucket)`` (``compile_cache.bucket_for``), so a giant history
  never inflates a small batchmate's padding. Per-request deadlines
  survive the merge: a segment whose deadline passes returns "unknown"
  to its owner alone. Txn tenants' cycle probes batch on one
  ``txn-closure`` lane (``cycle.batch_closure_probe``) and monitored
  streams' frontier folds on ``streamlin:<model>`` lanes
  (``streamlin.batch_fold``). The ``service.coalesce.*`` series on
  ``/api/metrics`` carry batches, segments and occupancy next to
  ``admission.shed_total``.

Where the port differs (ROADMAP.md, deliberate divergences):

* **The device.** The service takes its device once, at
  configuration (``configure_coalesce(device=...)``; None means CUDA,
  which raises there without a card). The coalescer's batches, the
  solo searches, the txn closures and a submitted campaign's cells all
  run there; no request can choose it. The reference follows
  ``JAX_PLATFORMS``.
* **No fallback that hides the device.** A batch that fails on the
  coalescer thread is not re-run solo: its error reaches every waiting
  owner (`Coalescer.wait` raises `BatchFailed`), and the request
  answers 500 naming it. An error raised by an engine, coalesced or
  solo, is a 500; 422 stays for errors raised before the engine
  dispatch (prepare, encode, plan; txn inference). A stopped or
  replaced coalescer still hands its queued segments to the solo path,
  a segment past its deadline still reads "unknown", and accounting
  errors are still contained.
* **Names.** Engine ``"jax-wgl"`` keeps its name (``monitor.engine.
  ENGINES``); the phase plane's wait lanes are ``torch-wgl-batch``,
  ``torch-streamlin-batch`` and ``txn-closure``.

Transport-level hardening (size limits, JSON errors) lives in
web.Handler; this module is pure request logic, so it tests without a
socket.
"""

from __future__ import annotations

import contextlib
import hmac
import logging
import re
import threading
import time

from .. import resolve_device, robust, store
from ..obs import phases as obs_phases

logger = logging.getLogger(__name__)

__all__ = ["MAX_BODY_BYTES", "ApiError", "Admission", "Coalescer",
           "CoalescerStopped", "BatchFailed",
           "DEFAULT_BUDGETS", "DEFAULT_COALESCE_WINDOW_MS",
           "DEFAULT_COALESCE_MAX_SEGMENTS",
           "authorize", "admission", "configure",
           "configure_coalesce", "coalescer", "device",
           "check_history", "submit_campaign", "campaign_status",
           "latch", "drain", "shutdown", "reset",
           "register_metrics_source", "unregister_metrics_source",
           "metrics_text", "slo_registry", "note_request",
           "endpoint_of"]

#: request-body ceiling enforced by web.Handler BEFORE reading
MAX_BODY_BYTES = 16 << 20

#: device-engine wall budget for one /api/check (seconds); payloads
#: may lower it, never raise it past the cap
CHECK_TIMEOUT_S = 30.0
CHECK_TIMEOUT_CAP_S = 120.0

#: histories larger than this are refused outright: the check is
#: NP-hard and a service must bound the work it accepts
MAX_CHECK_OPS = 200_000


class ApiError(Exception):
    """An HTTP-shaped request failure. ``retry_after`` (seconds)
    becomes a ``Retry-After`` response header -- shed load tells the
    caller when to come back instead of just slamming the door."""

    def __init__(self, status, message, retry_after=None, headers=None,
                 **extra):
        self.status = int(status)
        self.payload = {"error": str(message), **extra}
        self.headers = dict(headers or {})
        if retry_after is not None:
            self.headers["Retry-After"] = str(max(1, int(retry_after)))
        super().__init__(str(message))


# ---------------------------------------------------------------------------
# admission control: authn + per-caller budgets + bounded queue

#: default per-caller budgets. Generous on purpose: a bare viewer on
#: loopback behaves as a plain viewer; real deployments tighten them
#: via `configure`. ``ops-per-day`` is off (None) by default.
DEFAULT_BUDGETS = {
    "concurrent-checks": 8,   # in-flight /api/check per caller
    "queue-depth": 16,        # callers allowed to WAIT for a slot
    "campaigns": 8,           # queued+running campaigns per caller
    "ops-per-day": None,      # history events accepted per caller/day
}


class Admission:
    """The front door: who may ask, and how much.

    * **Authn.** With tokens configured, every request needs
      ``Authorization: Bearer <token>``; comparison is constant-time
      (`hmac.compare_digest`). Without tokens the caller is identified
      by its client address (budgets still apply).
    * **Budgets.** Per caller: at most ``concurrent-checks`` checks in
      flight; up to ``queue-depth`` more may wait (bounded, with a
      wall deadline) and everything past that sheds immediately as
      429 + Retry-After. ``campaigns`` bounds queued+running
      submissions; ``ops-per-day`` is a daily work quota (the check is
      NP-hard: accepted ops are the cost).
    * **Drain.** ``drain()`` stops new admissions (503) and wakes
      waiters; in-flight requests and accepted campaigns are
      untouched.
    """

    def __init__(self, token=None, tokens=None, budgets=None,
                 queue_wait_s=15.0):
        self.tokens = {str(t): str(n) for t, n in (tokens or {}).items()}
        if token:
            self.tokens.setdefault(str(token), "token")
        self.budgets = dict(DEFAULT_BUDGETS)
        self.budgets.update(budgets or {})
        for k in ("concurrent-checks", "queue-depth", "campaigns",
                  "ops-per-day"):
            v = self.budgets.get(k)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 0):
                raise ValueError(f"budget {k!r} must be a "
                                 f"non-negative integer, got {v!r}")
        self.queue_wait_s = float(queue_wait_s)
        self._cond = threading.Condition()
        self._draining = False
        self._callers = {}
        self._shed = 0

    def _shed_one(self, err):
        """Count one shed/refused admission (429/503) and rethrow --
        the ``admission.shed_total`` series /api/metrics exposes."""
        with self._cond:
            self._shed += 1
        raise err

    @property
    def shed_count(self):
        with self._cond:
            return self._shed

    def gauges(self):
        """The live admission state as metric series (the
        ``admission.*`` family /api/metrics renders)."""
        with self._cond:
            return {
                "admission.active_checks": sum(
                    st["active"] for st in self._callers.values()),
                "admission.queue_depth": sum(
                    st["waiting"] for st in self._callers.values()),
                "admission.campaigns": sum(
                    st["campaigns"] for st in self._callers.values()),
                "admission.callers": len(self._callers),
                "admission.draining": int(self._draining),
            }

    def _state(self, caller):
        return self._callers.setdefault(str(caller), {
            "active": 0, "waiting": 0, "day": None, "ops": 0,
            "campaigns": 0})

    def _gc(self, caller):
        """Drop an idle caller's state (lock held): unauthenticated
        callers are keyed by client address, so without this the table
        would grow by one entry per distinct source address. Kept only
        while something is held: a slot in flight, a waiter, a live
        campaign, or today's op spend."""
        caller = str(caller)
        st = self._callers.get(caller)
        if st is None or st["active"] or st["waiting"] \
                or st["campaigns"]:
            return
        if self.budgets.get("ops-per-day") is not None and st["ops"] \
                and st["day"] == int(time.time() // 86400):
            return
        self._callers.pop(caller, None)

    # -- authn ----------------------------------------------------------

    def authorize(self, header=None, client="local"):
        """The caller id for one request, or 401. ``header`` is the
        raw Authorization value (``Bearer <token>`` or the bare
        token); ``client`` identifies unauthenticated callers when no
        token is required."""
        if not self.tokens:
            return str(client or "local")
        tok = str(header or "")
        if tok.lower().startswith("bearer "):
            tok = tok[len("bearer "):].strip()
        matched = None
        for t, name in self.tokens.items():
            # compare EVERY configured token: the loop's timing must
            # not reveal which (if any) matched
            if hmac.compare_digest(tok.encode(), t.encode()):
                matched = name
        if matched is None:
            raise ApiError(401, "missing or invalid API token",
                           headers={"WWW-Authenticate": "Bearer"})
        return matched

    # -- checks ---------------------------------------------------------

    @contextlib.contextmanager
    def check_slot(self, caller, ops=0):
        """Hold one concurrent-check slot for ``caller`` (queueing up
        to the budget, shedding past it); charges ``ops`` against the
        daily quota on admission."""
        self._admit(str(caller), int(ops))
        try:
            yield
        finally:
            with self._cond:
                self._state(caller)["active"] -= 1
                self._gc(caller)
                self._cond.notify_all()

    def _admit(self, caller, ops):
        deadline = time.monotonic() + self.queue_wait_s
        with self._cond:
            st = self._state(caller)
            quota = self.budgets.get("ops-per-day")

            def check_quota():
                if quota is None:
                    return
                day = int(time.time() // 86400)
                if st["day"] != day:
                    st["day"], st["ops"] = day, 0
                if st["ops"] + ops > quota:
                    nxt = (day + 1) * 86400 - time.time()
                    self._shed_one(ApiError(
                        429, f"daily op quota exhausted "
                             f"({st['ops']}/{quota} used, "
                             f"{ops} requested)",
                        retry_after=min(86400, max(1, nxt))))

            check_quota()
            # a None budget means unlimited, for every key
            limit = self.budgets["concurrent-checks"]
            qdepth = self.budgets["queue-depth"]
            while not self._draining and limit is not None \
                    and st["active"] >= limit:
                left = deadline - time.monotonic()
                if (qdepth is not None and st["waiting"] >= qdepth) \
                        or left <= 0:
                    self._shed_one(ApiError(
                        429, "concurrent check budget exhausted "
                             f"({st['active']} in flight, "
                             f"{st['waiting']} queued)",
                        retry_after=2))
                st["waiting"] += 1
                try:
                    self._cond.wait(timeout=left)
                finally:
                    st["waiting"] -= 1
            if self._draining:
                self._shed_one(ApiError(503, "service is draining",
                                        retry_after=30))
            # cond.wait released the lock, so sibling waiters may
            # have spent the quota meanwhile: re-check before charging
            check_quota()
            st["active"] += 1
            if quota is not None:
                st["ops"] += ops

    # -- campaigns ------------------------------------------------------

    def campaign_slot(self, caller):
        """Claim one campaign slot (released via `campaign_done` when
        the campaign thread finishes); 429 past the budget."""
        with self._cond:
            if self._draining:
                self._shed_one(ApiError(503, "service is draining",
                                        retry_after=30))
            st = self._state(caller)
            limit = self.budgets["campaigns"]
            if limit is not None and st["campaigns"] >= limit:
                self._shed_one(ApiError(
                    429, f"campaign budget exhausted ({limit} "
                         "queued or running)", retry_after=30))
            st["campaigns"] += 1

    def campaign_done(self, caller):
        with self._cond:
            st = self._state(caller)
            st["campaigns"] = max(0, st["campaigns"] - 1)
            self._gc(caller)
            self._cond.notify_all()

    # -- lifecycle ------------------------------------------------------

    def drain(self):
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    @property
    def draining(self):
        with self._cond:
            return self._draining

    def snapshot(self):
        """Per-caller counters (status pages, tests)."""
        with self._cond:
            return {c: dict(st) for c, st in self._callers.items()}


# ---------------------------------------------------------------------------
# cross-tenant batch coalescing: queued /api/check segments from
# different callers merge into one padded device batch

#: how long the first segment of a batch may wait for batchmates
#: before the batch closes anyway (milliseconds)
DEFAULT_COALESCE_WINDOW_MS = 25.0

#: segments per batch past which the batch closes early -- bounds both
#: the batch's key axis and how many owners one batch failure reaches
DEFAULT_COALESCE_MAX_SEGMENTS = 32

#: occupancy histogram buckets: real segments / pow-2 key lanes
COALESCE_OCC_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                        0.875, 1.0)

#: the result a segment's owner reads when its request deadline
#: passes -- ONE shape for the coalesced, solo, and pre-encode budget
#: checks, so verdict folding cannot tell the paths apart
_DEADLINE_RESULT = {"valid": "unknown",
                    "error": "request timeout budget exhausted"}


class CoalescerStopped(RuntimeError):
    """`Coalescer.submit` on a stopped (or replaced) coalescer: the
    caller checks that segment solo."""


class BatchFailed(RuntimeError):
    """`Coalescer.wait` for a segment whose batch raised on the
    coalescer thread; the batch's error is its ``__cause__``."""


class _TxnClosureSpec:
    """The coalescer's stand-in "model" for transactional cycle
    probes: txn tenants queue per (``txn-closure``, pow-2 txn-count
    bucket) as WGL tenants queue per (model, op bucket), and one
    batched squaring pass answers the whole batch
    (``cycle.batch_closure_probe``)."""

    name = "txn-closure"


TXN_CLOSURE_SPEC = _TxnClosureSpec()

#: monitored-stream frontier lanes: one lane per model, named
#: "streamlin:<model>" (``checker/streamlin.STREAM_LANE_PREFIX``,
#: restated so lane routing imports no torch)
STREAM_LANE_PREFIX = "streamlin:"

#: the phase plane's wait lane of each coalescer lane kind
_WAIT_LANES = {"txn": "txn-closure", "stream": "torch-streamlin-batch",
               "wgl": "torch-wgl-batch"}


class _PendingSegment:
    """One encoded segment waiting in (or delivered by) the batcher.
    ``result`` is read only after ``event`` is set; ``None`` then
    means "check it on the solo path" (a stopped coalescer), never a
    verdict; a set ``error`` is the batch's failure."""

    __slots__ = ("spec", "pair", "deadline", "owner", "enqueued",
                 "event", "result", "error")

    def __init__(self, spec, pair, deadline, owner):
        self.spec = spec
        self.pair = pair
        self.deadline = float(deadline)
        self.owner = str(owner)
        self.enqueued = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error = None


def _lane_kind(spec):
    if spec.name == TXN_CLOSURE_SPEC.name:
        return "txn"
    if spec.name.startswith(STREAM_LANE_PREFIX):
        return "stream"
    return "wgl"


class Coalescer:
    """The cross-tenant batcher: a coalescing queue plus one daemon
    thread that closes batches and drives the card.

    * **Grouping.** Segments queue per ``(model, op-count bucket)`` --
      the bucket from ``campaign.compile_cache.bucket_for`` (the same
      pow-2 rule every engine pads with), so one giant history can't
      inflate every batchmate's padding.
    * **Closing.** A group's batch closes ``window_s`` after its
      oldest segment enqueued, or immediately at ``max_segments``.
      Batches dispatch on the batcher thread itself, so while one
      batch runs on the card later submissions keep accumulating into
      larger batches -- backpressure turns into occupancy.
    * **Deadlines.** Each segment carries its request's wall
      deadline. A segment already expired at dispatch is answered
      "unknown" without touching the card; the batch's budget is the
      LONGEST remaining deadline (capped), so a short-deadline tenant
      times out alone -- `wait` returns its "unknown" at its own
      deadline while batchmates keep running.
    * **Failures.** A batch that raises delivers its error to every
      waiting owner (`wait` raises `BatchFailed`); nothing re-runs
      solo. Stopping the coalescer (shutdown, replacement) delivers
      ``None``, and the owners check those segments solo.
    * **Device.** Every batch runs on ``device`` (None: CUDA, resolved
      here); a fold batch runs where its streams' frontiers live.
    """

    def __init__(self, window_s=DEFAULT_COALESCE_WINDOW_MS / 1000.0,
                 max_segments=DEFAULT_COALESCE_MAX_SEGMENTS,
                 planned=None, device=None):
        window_s = float(window_s)
        max_segments = int(max_segments)
        if window_s <= 0:
            raise ValueError(f"coalesce window must be positive, "
                             f"got {window_s!r}")
        if max_segments <= 0:
            raise ValueError(f"coalesce segment cap must be positive, "
                             f"got {max_segments!r}")
        self.window_s = window_s
        self.max_segments = max_segments
        self.device = resolve_device(device)
        self._cond = threading.Condition()
        self._queues = {}       # (model, bucket) -> [_PendingSegment]
        self._planned = {}      # model -> sorted [planned buckets]
        self._stopped = False
        self._thread = None     # started lazily on first submit
        self._batches = 0
        self._segments = 0
        self._lanes = 0
        self._fallbacks = 0
        self._failed = 0
        self._expired = 0
        if planned:
            self.preregister(planned)

    # -- the request side ----------------------------------------------

    def preregister(self, keys):
        """Seed the planned ``(model, bucket)`` shape set: a submission
        whose raw pow-2 bucket falls BELOW a planned bucket for its
        model queues on the smallest planned bucket >= it. Rounding
        only ever goes up (padding rows are inert), and models or
        buckets outside the plan keep the raw rule."""
        with self._cond:
            for m, b in keys:
                buckets = set(self._planned.get(str(m)) or ())
                buckets.add(int(b))
                self._planned[str(m)] = sorted(buckets)

    def _bucket_key(self, spec, n_rows):
        from ..campaign import compile_cache
        raw = compile_cache.bucket_for(n_rows)
        with self._cond:
            planned = self._planned.get(spec.name) or ()
        for b in planned:       # sorted ascending: smallest >= raw
            if b >= raw:
                return (spec.name, b)
        return (spec.name, raw)

    def submit(self, spec, e, init_state, deadline, owner="local"):
        """Enqueue one encoded segment; returns the pending handle to
        `wait` on. Raises `CoalescerStopped` when the coalescer is
        stopped (the caller then checks solo)."""
        key = self._bucket_key(spec, len(e))
        item = _PendingSegment(spec, (e, init_state), deadline, owner)
        with self._cond:
            if self._stopped:
                raise CoalescerStopped("coalescer is stopped")
            self._queues.setdefault(key, []).append(item)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="jepsen coalesce batcher")
                self._thread.start()
            self._cond.notify_all()
        return item

    def submit_closure(self, adj, deadline, owner="local"):
        """Enqueue one txn adjacency matrix for a batched cycle probe
        (key (``txn-closure``, pow-2 txn-count bucket)). ``wait``
        answers ``{"cyclic": bool}``, the deadline "unknown", or None =
        probe solo."""
        return self.submit(TXN_CLOSURE_SPEC, adj, None, deadline,
                           owner=owner)

    def wait(self, item):
        """Block until ``item``'s batch delivered or its request
        deadline passed. Returns the engine result dict, the deadline
        "unknown" (the same dict the solo path's exhausted budget
        produces), or None = check it on the solo path. Raises
        `BatchFailed` when the batch raised."""
        left = item.deadline - time.monotonic()
        if left <= 0 or not item.event.wait(timeout=left):
            return dict(_DEADLINE_RESULT)
        if item.error is not None:
            raise BatchFailed(
                f"coalesced {item.spec.name} batch failed: "
                f"{item.error!r}") from item.error
        return item.result

    def stats(self):
        """Lifetime batch counters: ``occupancy`` is real segments over
        pow-2 key lanes across every delivered batch; ``failed``
        counts segments whose batch raised."""
        with self._cond:
            return {"batches": self._batches,
                    "segments": self._segments,
                    "lanes": self._lanes,
                    "fallbacks": self._fallbacks,
                    "failed": self._failed,
                    "expired": self._expired,
                    "queued": sum(len(q)
                                  for q in self._queues.values()),
                    "planned": sum(len(v)
                                   for v in self._planned.values()),
                    "occupancy": round(self._segments / self._lanes, 4)
                    if self._lanes else None}

    # -- lifecycle ------------------------------------------------------

    def stop(self, join_s=5.0):
        """Stop accepting and wake every queued segment with the
        solo-path sentinel; bounded join on the batcher thread."""
        with self._cond:
            self._stopped = True
            pending = [it for q in self._queues.values() for it in q]
            self._queues.clear()
            t = self._thread
            self._cond.notify_all()
        self._release(pending)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=join_s)

    # -- the batcher thread --------------------------------------------

    def _ripe_key(self, now):
        """The ripe group with the OLDEST head segment (not dict
        order: one continuously-busy group must not starve the
        others on the single batcher thread)."""
        best = None
        best_age = -1.0
        for key, q in self._queues.items():
            if q and (len(q) >= self.max_segments
                      or now - q[0].enqueued >= self.window_s):
                age = now - q[0].enqueued
                if age > best_age:
                    best, best_age = key, age
        return best

    def _next_close(self, now):
        return min(q[0].enqueued + self.window_s
                   for q in self._queues.values() if q)

    def _run(self):
        while True:
            with self._cond:
                while not self._stopped \
                        and not any(self._queues.values()):
                    self._cond.wait()
                if self._stopped:
                    return
                now = time.monotonic()
                key = self._ripe_key(now)
                if key is None:
                    self._cond.wait(
                        timeout=max(0.001, self._next_close(now) - now))
                    continue
                q = self._queues[key]
                items = q[:self.max_segments]
                rest = q[self.max_segments:]
                if rest:
                    self._queues[key] = rest
                else:
                    del self._queues[key]
            try:
                self._dispatch(items, bucket=key[1])
            except Exception as exc:  # noqa: BLE001 - delivered, not hidden
                logger.warning("coalesced batch of %d segment(s) failed",
                               len(items), exc_info=True)
                self._deliver_error(items, exc)

    def _undelivered(self, items):
        return [it for it in items if not it.event.is_set()]

    def _release(self, items):
        """Deliver the solo-path sentinel to every still-waiting member
        of a stopped coalescer's queues."""
        undelivered = self._undelivered(items)
        if not undelivered:
            return
        with self._cond:
            self._fallbacks += len(undelivered)
        for it in undelivered:
            it.result = None
            it.event.set()
        self._count("service.coalesce.fallbacks", len(undelivered))

    def _deliver_error(self, items, exc):
        """Hand a failed batch's error to every still-waiting member:
        each owner's `wait` raises it, and nothing re-runs solo."""
        undelivered = self._undelivered(items)
        if not undelivered:
            return
        with self._cond:
            self._failed += len(undelivered)
        for it in undelivered:
            it.error = exc
            it.event.set()
        self._count("service.coalesce.failed", len(undelivered))

    def _count(self, name, n):
        try:
            slo_registry().inc(name, n)
        except Exception:  # noqa: BLE001 - accounting only
            logger.warning("coalesce accounting failed", exc_info=True)

    def _dispatch(self, items, bucket=None):
        spec = items[0].spec
        now = time.monotonic()
        live = []
        for it in items:
            if it.deadline <= now:
                # expired while queued: its owner already read (or
                # will read) the deadline "unknown" from wait(); no
                # device work for it, and no widening of the batch
                it.result = dict(_DEADLINE_RESULT)
                it.event.set()
            else:
                live.append(it)
        with self._cond:
            self._expired += len(items) - len(live)
        if not live:
            return
        # the batch's budget serves its LONGEST deadline: a
        # short-deadline member times out alone in wait(), batchmates
        # keep their shot at a definite verdict
        timeout_s = min(CHECK_TIMEOUT_CAP_S,
                        max(it.deadline for it in live) - now)
        kind = _lane_kind(spec)
        if kind == "txn":
            # ONE batched closure probe answers cyclic-or-not for
            # every member's adjacency matrix (cycle classification
            # stays host-side, and only for members that are cyclic)
            from ..cycle import batch_closure_probe
            flags = batch_closure_probe([it.pair[0] for it in live],
                                        n_floor=bucket or 64,
                                        device=self.device)
            results = [{"cyclic": bool(f)} for f in flags]
        elif kind == "stream":
            # strangers' frontier-extension folds stack into one
            # lane-batched fold (batch_fold regroups by full shape, so
            # a mid-flight frontier grow never mis-stacks a batch)
            from ..checker import streamlin
            results = streamlin.batch_fold(
                [it.pair[0] for it in live],
                owners=[it.owner for it in live], e_bucket=bucket)
        else:
            from ..parallel import keyshard
            # pad the batch to its GROUP bucket, not a re-derived one:
            # with pre-registration the group bucket may sit above
            # every member's raw length
            results = keyshard.check_batch_encoded(
                spec, [it.pair for it in live], timeout_s=timeout_s,
                owners=[it.owner for it in live], n_floor=bucket,
                device=self.device)
        for it, r in zip(live, results):
            it.result = r
            it.event.set()
        lanes = 1 << (len(live) - 1).bit_length() if len(live) > 1 else 1
        with self._cond:
            self._batches += 1
            self._segments += len(live)
            self._lanes += lanes
        self._note_batch(spec, live, lanes, now)

    # -- accounting (never verdict-bearing) ----------------------------

    def _note_batch(self, spec, live, lanes, t_dispatch):
        try:
            reg = slo_registry()
            reg.inc("service.coalesce.batches", model=spec.name)
            reg.inc("service.coalesce.segments", len(live),
                    model=spec.name)
            reg.observe("service.coalesce.occupancy",
                        len(live) / lanes,
                        buckets=COALESCE_OCC_BUCKETS)
            reg.observe("service.coalesce.owners",
                        len({it.owner for it in live}),
                        buckets=(1, 2, 4, 8, 16, 32))
            lane = _WAIT_LANES[_lane_kind(spec)]
            for it in live:
                reg.observe("service.coalesce.wait_s",
                            t_dispatch - it.enqueued,
                            buckets=SLO_BUCKETS_S)
                # the queue wait is also a named phase in the
                # time-attribution plane (obs.phases)
                obs_phases.note_wait(lane, t_dispatch - it.enqueued,
                                     owner=it.owner)
        except Exception:  # noqa: BLE001
            logger.warning("coalesce accounting failed", exc_info=True)


_lock = threading.Lock()
_latch = None
_admission = None
_campaigns = {}     # campaign id -> {"thread", "latch", "submitted"}
_coalescer = None
_device = None      # torch.device set by configure_coalesce
_slo = None


# ---------------------------------------------------------------------------
# service SLO metrics: per-endpoint request accounting + the
# verdict-latency / queue-wait histograms (p50/p99 derive from the
# Prometheus buckets)

#: request/verdict latency buckets, seconds: /api/check spans sub-ms
#: histlint rejections to the 120 s engine cap
SLO_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def slo_registry():
    """The service's own metrics registry (independent of any run's
    bound registry: a serve-only process still has SLOs). Rendered into
    ``GET /api/metrics`` alongside everything else."""
    global _slo
    with _lock:
        if _slo is None:
            from ..obs import Registry
            _slo = Registry()
        return _slo


def endpoint_of(path):
    """The SLO label for one /api path: 'check', 'campaigns',
    'campaign-status', 'metrics', or 'other'."""
    clean = str(path).rstrip("/")
    if clean == "/api/check":
        return "check"
    if clean == "/api/campaigns":
        return "campaigns"
    if clean.startswith("/api/campaigns/"):
        return "campaign-status"
    if clean == "/api/metrics":
        return "metrics"
    return "other"


def note_request(endpoint, status, wall_s):
    """One served /api request: counted per {endpoint, status} with a
    request-latency observation, plus a trace span when a tracer is
    bound. web.Handler calls this for every /api response, including
    the 4xx/5xx ones."""
    try:
        reg = slo_registry()
        reg.inc("service.requests", endpoint=str(endpoint),
                status=str(int(status)))
        reg.observe("service.request_s", float(wall_s),
                    buckets=SLO_BUCKETS_S, endpoint=str(endpoint))
        from .. import obs
        tr = obs.tracer()
        if tr is not None:
            now = tr.now_ns()
            dur = int(float(wall_s) * 1e9)
            tr.complete("service.request", now - dur, dur,
                        cat="service",
                        args={"endpoint": str(endpoint),
                              "status": int(status)})
    except Exception:  # noqa: BLE001 - accounting must not 500 requests
        logger.warning("request accounting failed", exc_info=True)


def _slo_observe(name, value, **labels):
    try:
        slo_registry().observe(name, float(value),
                               buckets=SLO_BUCKETS_S, **labels)
    except Exception:  # noqa: BLE001
        logger.warning("SLO observation failed", exc_info=True)


def configure(token=None, tokens=None, budgets=None,
              queue_wait_s=15.0):
    """(Re)build the service-wide admission gate: the --serve /
    web.serve entry points call this with the operator's token and
    budget knobs. Replacing the gate only affects NEW requests;
    in-flight slots release against the old one."""
    global _admission
    gate = Admission(token=token, tokens=tokens, budgets=budgets,
                     queue_wait_s=queue_wait_s)
    with _lock:
        _admission = gate
    return gate


def admission():
    """The service-wide Admission gate (permissive defaults until
    `configure` is called: no tokens, generous budgets)."""
    global _admission
    with _lock:
        if _admission is None:
            _admission = Admission()
        return _admission


def configure_coalesce(enabled=True, window_ms=None, max_segments=None,
                       planned=None, device=None):
    """(Re)build the service-wide cross-tenant batcher and set the
    service's device. ``device`` (None: CUDA, which raises here without
    a card) is where the coalescer's batches and every solo search
    run, enabled or not. ``enabled`` False tears the batcher down
    (every check runs solo); ``window_ms``/``max_segments`` default to
    the module constants; ``planned`` pre-registers ``(model, bucket)``
    shapes (see `Coalescer.preregister`). Returns the new `Coalescer`
    (or None when disabled). Replacing an existing coalescer stops it:
    its queued segments are handed to the solo path."""
    global _coalescer, _device
    dev = resolve_device(device)
    new = None
    if enabled:
        w = DEFAULT_COALESCE_WINDOW_MS if window_ms is None \
            else float(window_ms)
        m = DEFAULT_COALESCE_MAX_SEGMENTS if max_segments is None \
            else int(max_segments)
        new = Coalescer(window_s=w / 1000.0, max_segments=m,
                        planned=planned, device=dev)
    with _lock:
        old = _coalescer
        _coalescer = new
        _device = dev
    if old is not None:
        old.stop()
    return new


def coalescer():
    """The service-wide Coalescer, or None while coalescing is off
    (the default for direct `check_history` callers; ``web.serve``
    turns it on unless told otherwise)."""
    with _lock:
        return _coalescer


def device():
    """The service's device: the one `configure_coalesce` set, else
    CUDA (raising without a card)."""
    with _lock:
        dev = _device
    return dev if dev is not None else resolve_device(None)


def authorize(header=None, client="local"):
    """Module-level convenience: the caller id for one request, or
    401 (web.Handler calls this before routing)."""
    return admission().authorize(header, client=client)


def drain():
    """Stop admitting new requests (503 + Retry-After); in-flight
    requests and accepted campaigns keep running."""
    admission().drain()


def latch():
    """The service-wide abort latch (created on first use)."""
    global _latch
    with _lock:
        if _latch is None:
            _latch = robust.AbortLatch()
        return _latch


def shutdown(reason="service-shutdown", join_s=10.0):
    """Graceful stop: drain admission first (new requests shed as
    503, waiters wake), then honor the shared AbortLatch so every
    accepted campaign aborts gracefully (journals stay resumable),
    then give their threads a bounded join."""
    drain()
    latch().set(reason)
    with _lock:
        threads = [c["thread"] for c in _campaigns.values()]
        coal = _coalescer
    if coal is not None:
        # after the drain: no new submissions arrive, and queued
        # segments go to the solo path so in-flight requests still
        # answer while the server winds down
        coal.stop()
    deadline = time.monotonic() + join_s
    for t in threads:
        t.join(timeout=max(0.1, deadline - time.monotonic()))


def reset():
    """Forget service state (tests)."""
    global _latch, _admission, _slo, _coalescer, _device
    with _lock:
        coal = _coalescer
        _latch = None
        _admission = None
        _slo = None
        _coalescer = None
        _device = None
        _campaigns.clear()
        _metrics_sources.clear()
    if coal is not None:
        coal.stop()


# ---------------------------------------------------------------------------
# GET /api/metrics: Prometheus text exposition

_metrics_sources = {}


def register_metrics_source(name, fn):
    """Register a live metrics provider for ``GET /api/metrics``.
    ``fn()`` returns an obs.Registry or a structured section dict (see
    obs.metrics.render_prometheus) -- the fleet dispatcher registers
    its lease-table/queue gauges here for the duration of a campaign.
    Returns the name (pass to `unregister_metrics_source`)."""
    with _lock:
        _metrics_sources[str(name)] = fn
    return str(name)


def unregister_metrics_source(name):
    with _lock:
        _metrics_sources.pop(str(name), None)


def _ledger_section():
    """The plan-shape ledger family: cross-process hit/miss counts and
    the cold/warm wall split in the reference's format."""
    from . import ledger as fledger
    led = fledger.attached()
    if led is None:
        return None
    st = led.stats()
    return {"counters": {"ledger.hits": st.get("hits", 0),
                         "ledger.misses": st.get("misses", 0)},
            "gauges": {"ledger.shapes": st.get("shapes", 0),
                       "ledger.processes": st.get("processes", 0),
                       "ledger.cold_wall_s": st.get("cold_wall_s", 0.0),
                       "ledger.warm_wall_s": st.get("warm_wall_s",
                                                    0.0)}}


def metrics_text():
    """The ``GET /api/metrics`` body: every live obs Registry, every
    registered source (fleet dispatch gauges), the service's own SLO
    registry, the admission gate's live state, and the plan-shape
    ledger aggregate -- in the Prometheus text exposition format.
    Sources that fail are skipped, never 5xx'd: a metrics scrape must
    not depend on every subsystem being healthy."""
    from .. import obs

    sections = list(obs.live_registries())
    with _lock:
        sources = list(_metrics_sources.items())
    for name, fn in sources:
        try:
            section = fn()
            if isinstance(section, (list, tuple)):
                sections.extend(s for s in section if s is not None)
            elif section is not None:
                sections.append(section)
        except Exception:  # noqa: BLE001 - scrape over perfection
            logger.warning("metrics source %s failed", name,
                           exc_info=True)
    adm = admission()
    sections.append({"gauges": adm.gauges(),
                     "counters": {"admission.shed_total":
                                  adm.shed_count}})
    sections.append(slo_registry())
    try:
        led = _ledger_section()
        if led is not None:
            sections.append(led)
    except Exception:  # noqa: BLE001
        logger.warning("ledger metrics section failed", exc_info=True)
    from ..obs import render_prometheus
    return render_prometheus(sections)


# ---------------------------------------------------------------------------
# POST /api/check

class _EngineFailure(Exception):
    """Internal: an engine (coalesced or solo) raised while checking
    admitted work -- a 500, not bad input."""


def _engine_error(exc):
    return ApiError(500, f"check failed in the engine: {exc!r}")


def _require(payload, key, types, what):
    v = payload.get(key)
    if not isinstance(v, types):
        raise ApiError(400, f"{key!r} must be {what}")
    return v


def _split_keyed(hist):
    """Per-key subhistories of an [k, v]-valued history, mirroring
    independent.subhistory. JSON has no tuple type, so every 2-element
    list value is coerced to an independent.Tuple first -- the caller
    opted into keyed semantics."""
    from .. import independent
    coerced = []
    for op in hist:
        v = op.get("value")
        if isinstance(v, (list, tuple)) and len(v) == 2 \
                and not independent.is_tuple(v):
            op = dict(op)
            op["value"] = independent.tuple_(v[0], v[1])
        coerced.append(op)
    hist = coerced
    keys = independent.history_keys(hist)
    if not keys:
        raise ApiError(400, "keyed check requested but no op carries "
                            "an [key, value] tuple value")
    return {k: independent.subhistory(k, hist) for k in keys}


def check_history(payload, caller="local"):
    """The /api/check pipeline; returns the response dict or raises
    ApiError. Payload keys: ``history`` (list of op maps, required),
    ``model`` (name, default cas-register), ``engine`` (jax-wgl /
    linear / wgl / streamlin, default jax-wgl), ``family`` (wgl /
    txn), ``keyed`` (bool), ``init-ops``, ``timeout-s``,
    ``searchplan``, ``coalesce``, ``certify``. ``caller`` is the
    `authorize`-d identity the admission gate budgets against."""
    if not isinstance(payload, dict):
        raise ApiError(400, "request body must be a JSON object")
    hist = _require(payload, "history", list, "a list of op maps")
    if len(hist) > MAX_CHECK_OPS:
        raise ApiError(413, f"history has {len(hist)} events; this "
                            f"service accepts at most {MAX_CHECK_OPS}")
    # admission: one concurrent-check slot per caller for the whole
    # pipeline (accepted events are the cost, so the history length is
    # what the daily quota charges). Queue wait is the slot wall,
    # verdict latency the whole admission-to-verdict wall
    t0 = time.monotonic()
    with admission().check_slot(caller, ops=len(hist)):
        _slo_observe("service.queue_wait_s", time.monotonic() - t0,
                     endpoint="check")
        out = _check_admitted(payload, hist, caller=caller)
    _slo_observe("service.verdict_latency_s", time.monotonic() - t0,
                 endpoint="check", valid=str(out.get("valid")))
    return out


def _certify_one(spec, slot, payload):
    """Certify one (sub)history's merged result ("_certify" stash) and
    return the response summary. Differential sampling is off on the
    service path (a replay per request would double the card's load);
    the witness replay + invalid cross-check are the cheap, bounded
    parts."""
    from ..analysis import certify
    stash = slot.pop("_certify", None)
    if stash is None:
        return {"certified": False}
    merged, client = stash
    cert, diags = certify.certify_with_diagnostics(
        spec, client, merged, samples=0, differential=False,
        init_ops=payload.get("init-ops"))
    return {"certified": True, "verdict": cert["verdict"],
            "counts": cert["counts"], "checks": cert["checks"],
            "diagnostics": cert["diagnostics"]}


def _certify_response(spec, out, payload):
    """The "certify": true response block, over the single submission
    or folded across a keyed submission's per-key results. Contained,
    as the port's run-loop certification is: a certifier crash reports
    itself instead of failing the check."""
    try:
        if "keys" in out:
            per_key = {k: _certify_one(spec, slot, payload)
                       for k, slot in sorted(out["keys"].items())}
            counts = {}
            for s in per_key.values():
                for sev, n in (s.get("counts") or {}).items():
                    counts[sev] = counts.get(sev, 0) + n
            return {"certified": True, "counts": counts,
                    "keys": per_key}
        return _certify_one(spec, out, payload)
    except Exception:  # noqa: BLE001 - contained, never verdict-bearing
        logger.warning("/api/check certification crashed",
                       exc_info=True)
        # the stashes hold tensor-bearing results: never let one leak
        # into the JSON response
        for slot in [out] + list((out.get("keys") or {}).values()):
            if isinstance(slot, dict):
                slot.pop("_certify", None)
        return {"certified": False, "error": "certification crashed"}


def _check_txn_admitted(payload, hist, caller="local"):
    """The ``"family": "txn"`` /api/check pipeline: host-side
    dependency inference, a (coalesced) cycle probe on the card, and
    offline Adya classification only for histories that earn it.
    Payload keys: ``workload`` (append / wr), ``anomalies`` (requested
    class names), ``realtime`` / ``process`` (edge flags),
    ``skew-bound`` (ns; gates realtime edges), ``certify``,
    ``coalesce``. An inference error is a 422; a probe or
    classification error is a 500."""
    from ..cycle import (DEFAULT_ANOMALIES, PROCESS_ANOMALIES,
                         transitive_closure)
    from ..monitor import engine as mengine

    workload = payload.get("workload", "append")
    if workload not in mengine.TXN_WORKLOADS:
        raise ApiError(400, f"unknown txn workload {workload!r}; "
                            f"known: {list(mengine.TXN_WORKLOADS)}")
    known = set(DEFAULT_ANOMALIES) | set(PROCESS_ANOMALIES)
    anomalies = payload.get("anomalies")
    if anomalies is not None:
        if not isinstance(anomalies, (list, tuple)) \
                or not all(isinstance(a, str) for a in anomalies):
            raise ApiError(400, "'anomalies' must be a list of "
                                "anomaly-class names")
        bad = sorted(set(anomalies) - known)
        if bad:
            raise ApiError(400, f"unknown anomaly class(es) {bad}; "
                                f"known: {sorted(known)}")
    for key in ("realtime", "process"):
        if key in payload and not isinstance(payload[key], bool):
            raise ApiError(400, f"{key!r} must be a boolean")
    skew = payload.get("skew-bound", 0)
    if not isinstance(skew, (int, float)) or isinstance(skew, bool) \
            or skew < 0:
        raise ApiError(400, "'skew-bound' must be a non-negative "
                            "number (history time units)")
    if not isinstance(payload.get("coalesce", True), bool):
        raise ApiError(400, "'coalesce' must be a boolean")
    if not isinstance(payload.get("certify", False), bool):
        raise ApiError(400, "'certify' must be a boolean")
    opts = {"anomalies": tuple(anomalies) if anomalies
            else DEFAULT_ANOMALIES,
            "realtime": payload.get("realtime", True),
            "process": payload.get("process", False),
            "skew-bound": int(skew)}
    t0 = time.monotonic()
    timeout_s = min(float(payload.get("timeout-s") or CHECK_TIMEOUT_S),
                    CHECK_TIMEOUT_CAP_S)
    deadline = t0 + timeout_s
    from .. import history as jhistory
    hist = jhistory.index([dict(o) for o in hist])
    try:
        if workload == "wr":
            from ..cycle import wr as cycle_wr
            graph, found, oks, _garbage = cycle_wr.infer(hist, opts)
        else:
            from ..cycle import append as cycle_app
            graph, found, oks = cycle_app.infer(
                hist, opts["anomalies"], realtime=opts["realtime"],
                process=opts["process"], skew_bound=opts["skew-bound"])
    except ApiError:
        raise
    except Exception as exc:  # noqa: BLE001 - bad input, not a 500
        logger.warning("/api/check txn inference failed", exc_info=True)
        raise ApiError(422, f"txn history could not be inferred: "
                            f"{exc!r}") from None
    suspicious = set(found) - {"garbage-read"}
    garbage = found.get("garbage-read") or []
    coalesced = None
    cyclic = None
    try:
        if not suspicious:
            adj = graph.adj > 0
            coal = coalescer()
            if coal is not None and payload.get("coalesce", True) \
                    and len(adj):
                try:
                    item = coal.submit_closure(adj, deadline,
                                               owner=caller)
                except CoalescerStopped:
                    item = None
                r = coal.wait(item) if item is not None else None
                if isinstance(r, dict) and "cyclic" in r:
                    cyclic = bool(r["cyclic"])
                    coalesced = {"txns": len(adj)}
            if cyclic is None and len(adj):
                closure = transitive_closure(adj, device=device())
                cyclic = bool(closure.diagonal().any())
            cyclic = bool(cyclic)
        if suspicious or cyclic:
            # the offline engine owns every classified verdict:
            # witnesses, anomaly names, and requested-subset semantics
            # come from the code the offline checker runs
            res = mengine.check_txn_prefix(hist, workload,
                                           dict(opts, device=device()))
        elif garbage:
            res = {"valid": "unknown", "anomaly_types": [],
                   "anomalies": {"garbage-read": garbage}}
        else:
            res = {"valid": True, "anomaly_types": [], "anomalies": {}}
    except ApiError:
        raise
    except Exception as exc:  # noqa: BLE001 - an engine error: a 500
        logger.warning("/api/check txn engine failed", exc_info=True)
        raise _engine_error(exc) from exc
    out = {"valid": res.get("valid"),
           "family": "txn", "workload": workload,
           "model": f"txn-{workload}", "engine": f"txn-{workload}",
           "anomaly_types": list(res.get("anomaly_types") or ()),
           "anomalies": res.get("anomalies") or {},
           "txns": len(oks), "events": len(hist),
           **({"error": str(res["error"])} if res.get("error")
              else {}),
           **({"coalesced": coalesced} if coalesced else {}),
           "wall_s": round(time.monotonic() - t0, 3)}
    if payload.get("certify", False):
        try:
            from ..analysis import certify
            checks = []
            diags = certify.certify_cycle_witness(
                res, hist, workload=workload, opts=opts, checks=checks)
            sev = {"error": 0, "warning": 0, "info": 0}
            for d in diags:
                sev[d.severity] = sev.get(d.severity, 0) + 1
            out["certify"] = {
                "certified": True,
                "verdict": res.get("valid"),
                "counts": sev,
                "checks": checks,
                "diagnostics": [{"code": d.code,
                                 "severity": d.severity,
                                 "message": d.message,
                                 "location": d.location}
                                for d in diags]}
        except Exception:  # noqa: BLE001 - contained, never verdict-bearing
            logger.warning("/api/check txn certification crashed",
                           exc_info=True)
            out["certify"] = {"certified": False,
                              "error": "certification crashed"}
    from .. import obs
    obs.inc("fleet.api_checks", valid=str(out.get("valid")),
            family="txn")
    return out


def _check_admitted(payload, hist, caller="local"):
    from ..analysis import errors as diag_errors
    from ..analysis import histlint
    from ..checker.checkers import Linearizable
    from ..models import model_spec
    from ..monitor import engine as mengine

    family = payload.get("family")
    if family == "txn":
        return _check_txn_admitted(payload, hist, caller=caller)
    if family is not None and family != "wgl":
        raise ApiError(400, f"unknown check family {family!r}; "
                            "known: wgl (default), txn")

    model = payload.get("model", "cas-register")
    try:
        spec = model_spec(str(model))
    except KeyError as e:
        raise ApiError(400, str(e)) from None
    engine = payload.get("engine", "jax-wgl")
    if engine not in mengine.ENGINES:
        raise ApiError(400, f"unknown engine {engine!r}; known: "
                            f"{list(mengine.ENGINES)}")
    timeout_s = payload.get("timeout-s")
    if timeout_s is not None and (not isinstance(timeout_s, (int, float))
                                  or isinstance(timeout_s, bool)
                                  or timeout_s <= 0):
        raise ApiError(400, f"timeout-s must be a positive number, "
                            f"got {timeout_s!r}")
    timeout_s = min(float(timeout_s or CHECK_TIMEOUT_S),
                    CHECK_TIMEOUT_CAP_S)
    if not isinstance(payload.get("coalesce", True), bool):
        raise ApiError(400, f"'coalesce' must be a boolean, got "
                            f"{payload['coalesce']!r}")
    if not isinstance(payload.get("certify", False), bool):
        raise ApiError(400, f"'certify' must be a boolean, got "
                            f"{payload['certify']!r}")
    # proof-carrying verdicts on demand: "certify": true replays the
    # verdict's witness through the pure CPU model and cross-checks
    # invalid verdicts through an independent engine
    # (analysis/certify.py); the summary rides back on the response
    certify_on = bool(payload.get("certify", False))
    # cross-tenant coalescing: only the device engine batches (the CPU
    # engines have no key axis); the payload may opt a single request
    # out ("coalesce": false), e.g. to compare against the solo path
    coal = coalescer()
    use_coal = (coal is not None and engine == "jax-wgl"
                and payload.get("coalesce", True))

    # -- histlint: refuse malformed histories with the diagnostics ----
    diags = histlint.lint_history(hist, model_fs=set(spec.f_codes))
    errs = diag_errors(diags)
    if errs:
        raise ApiError(
            400, "history failed histlint",
            diagnostics=[{"code": d.code, "message": d.message,
                          "location": d.location} for d in errs[:20]])

    from .. import history as jhistory
    hist = jhistory.index([dict(o) for o in hist])
    lin = Linearizable(spec, engine,
                       init_ops=payload.get("init-ops"))
    # ONE wall budget for the whole request, not per key: a keyed
    # history with many hard keys must not multiply the cap
    t0 = time.monotonic()
    deadline = t0 + timeout_s

    # the search planner runs on every submission (opt out with
    # "searchplan": false): sealed quiescent cuts slice each
    # (sub)history into independent segments checked through the
    # same engine dispatch
    plan_on = payload.get("searchplan", True)
    from ..analysis import searchplan

    def solo(e, init_state):
        # the non-batched dispatch (and where a stopped coalescer's
        # segments go), on the service's device
        left = deadline - time.monotonic()
        if left <= 0:
            return dict(_DEADLINE_RESULT)
        engine_opts = {"timeout_s": left, "device": device()} \
            if engine in ("jax-wgl", "streamlin") else None
        try:
            return mengine.check_prefix(spec, e, init_state,
                                        engine=engine,
                                        engine_opts=engine_opts)
        except Exception as exc:  # noqa: BLE001 - an engine error
            raise _EngineFailure(exc) from exc

    def start_one(sub):
        """Phase 1 of one (sub)history's check: plan, encode, and
        SUBMIT every segment before anything waits -- all of this
        request's segments (every key of a keyed submission, and
        every concurrent stranger's) land in the same coalescing
        window. Returns the phase-2 closure that waits and folds."""
        client = lin.prepare_history(jhistory.client_ops(sub))
        segments = [client]
        seg_seeds = [None]
        plan_meta = None
        n_ops = None
        if plan_on:
            segs, info = searchplan.plan_segments(spec, client)
            if len(segs) > 1:
                segments = [s.events for s in segs]
                seg_seeds = [s.seed for s in segs]
                plan_meta = {"segments": len(segs),
                             "cuts": info["cuts"],
                             "elided": info["elided"]}
                # "ops" keeps its unplanned meaning -- the logical ops
                # of the submitted (sub)history, what ONE flat encode
                # would produce
                n_ops = info["rows"] + info["elided"]
        per_seg = []
        pending = []            # (slot, item, e, init_state)
        for seg in segments:
            left = deadline - time.monotonic()
            if left <= 0:
                per_seg.append(dict(_DEADLINE_RESULT))
                continue
            e, init_state = spec.encode(seg)
            if n_ops is None:
                n_ops = len(e)
            if use_coal:
                try:
                    item = coal.submit(spec, e, init_state, deadline,
                                       owner=caller)
                except CoalescerStopped:
                    logger.warning("coalescer stopped; checking solo")
                else:
                    per_seg.append(None)
                    pending.append((len(per_seg) - 1, item, e,
                                    init_state))
                    continue
            per_seg.append(solo(e, init_state))

        def finish():
            try:
                for slot, item, e, init_state in pending:
                    r = coal.wait(item)
                    per_seg[slot] = r if r is not None \
                        else solo(e, init_state)
                return fold()
            except _EngineFailure:
                raise
            except Exception as exc:  # noqa: BLE001 - after dispatch
                raise _EngineFailure(exc) from exc

        def fold():
            # stamp witness provenance as the offline planned path
            # does (checkers._check_planned): the certifier
            # re-certifies each segment against a replanned cut
            for i, r in enumerate(per_seg):
                w = r.get("witness") if isinstance(r, dict) else None
                if isinstance(w, dict):
                    w["segment"] = {"index": i, "count": len(per_seg),
                                    "seed": seg_seeds[i]}
            # demux back into one per-(sub)history verdict through
            # the fold the planned offline paths use (worst-wins
            # validity, configs sum, failing segment's witness)
            merged = searchplan.merge_segment_results(
                per_seg,
                info={"cuts": plan_meta["cuts"],
                      "elided": plan_meta["elided"]}
                if plan_meta else None,
                engine=engine)
            errs = [str(r["error"]) for r in per_seg
                    if r.get("error")]
            out = {"valid": merged["valid"], "ops": n_ops or 0,
                   "configs_explored": merged["configs_explored"],
                   **({"searchplan": plan_meta} if plan_meta else {}),
                   **({"error": errs[0]} if errs else {})}
            # how many distinct tenants shared this submission's
            # batches (keyshard stamps batch_owners on searched keys)
            owners = max((int(r.get("batch_owners") or 0)
                          for r in per_seg), default=0)
            if use_coal and owners:
                out["coalesced"] = {"owners": owners}
            if certify_on:
                # raw material for the post-verdict certification
                # below (popped before the response is shaped)
                out["_certify"] = (merged, client)
            return out

        return finish

    try:
        if payload.get("keyed"):
            from ..checker.core import merge_valid
            # start EVERY key before finishing any: all keys'
            # segments share one coalescing window
            started = [(str(k), start_one(sub))
                       for k, sub in sorted(_split_keyed(hist).items(),
                                            key=lambda kv: str(kv[0]))]
            per_key = {k: finish() for k, finish in started}
            out = {"valid": merge_valid([r["valid"]
                                         for r in per_key.values()]),
                   "keys": per_key}
        else:
            out = start_one(hist)()
    except ApiError:
        raise
    except _EngineFailure as f:
        logger.warning("/api/check engine failed", exc_info=True)
        raise _engine_error(f.__cause__) from f.__cause__
    except Exception as exc:  # noqa: BLE001 - bad input, not a 500
        logger.warning("/api/check failed", exc_info=True)
        raise ApiError(422, f"history could not be checked: "
                            f"{exc!r}") from None
    if certify_on:
        out["certify"] = _certify_response(spec, out, payload)
    out.update({"model": spec.name, "engine": engine,
                "events": len(hist),
                "wall_s": round(time.monotonic() - t0, 3),
                "histlint": {"warnings": len(diags) - len(errs)}})
    from .. import obs
    obs.inc("fleet.api_checks", valid=str(out.get("valid")))
    return out


# ---------------------------------------------------------------------------
# POST /api/campaigns + GET /api/campaigns/<id>

#: default base options submitted campaigns build cells from (the demo
#: suite's no-ssh shape); a payload's "options" overlay these
DEFAULT_OPTIONS = {
    "nodes": ["n1"], "concurrency": 1, "ssh": {"dummy?": True},
    "time-limit": 5, "workload": "register",
}

#: option keys a remote payload may NOT override: anything that would
#: point the server's control plane at real hosts or local files, and
#: (in the port) the device, which is the service's own. Submitted
#: campaigns always run on the dummy remote.
PROTECTED_OPTIONS = ("nodes-file", "nodes", "node", "ssh",
                     "ssh-private-key", "leave-db-running?", "device")

_SAFE_ID = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._+=,-]*$")


def _safe_campaign_id(cid):
    """Campaign ids from the wire become filesystem path components
    (store/campaigns/<id>/...): refuse anything that isn't a plain
    token, or a crafted id escapes the store on both read and write."""
    cid = str(cid)
    if not _SAFE_ID.fullmatch(cid) or len(cid) > 200:
        raise ApiError(400, f"invalid campaign id {cid!r}: use "
                            "letters, digits, and ._+=,- only")
    return cid


def submit_campaign(payload, builder=None, caller="local"):
    """Accept a sweep matrix; returns (campaign_id, meta dict). The
    campaign runs on a daemon thread via the ordinary scheduler with a
    latch chained off the service latch, its cells on the service's
    device when one was configured. ``caller`` is the `authorize`-d
    identity whose campaign budget the submission claims (released
    when the campaign thread finishes)."""
    from ..campaign import CampaignError, run_cells
    from ..campaign import plan as cplan

    if not isinstance(payload, dict):
        raise ApiError(400, "request body must be a JSON object")
    axes = _require(payload, "axes", dict, "an {axis: [values]} object")
    matrix = {"axes": axes, "base": payload.get("base") or {}}
    try:
        cells_plan, diags = cplan.validate(matrix)
    except cplan.CampaignPlanError as e:
        raise ApiError(400, f"campaign matrix invalid: {e}") from None
    options = dict(DEFAULT_OPTIONS)
    overlay = payload.get("options") or {}
    if not isinstance(overlay, dict):
        raise ApiError(400, "'options' must be an object")
    overlay = {k: v for k, v in overlay.items()
               if k not in PROTECTED_OPTIONS}
    options.update(overlay)
    # whatever the payload said, a submitted campaign runs on the
    # dummy remote
    options["ssh"] = {"dummy?": True}
    with _lock:
        dev = _device
    if dev is not None:
        options["device"] = dev.type

    def _pos_int(key):
        v = payload.get(key)
        if v is None:
            return 1
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            raise ApiError(400, f"{key!r} must be a positive integer, "
                                f"got {v!r}")
        return v

    parallel = _pos_int("parallel")
    device_slots = _pos_int("device-slots")
    campaign_id = _safe_campaign_id(payload.get("id") or
                                    "api-" + store.local_time())
    if campaign_id in _campaigns:
        raise ApiError(409, f"campaign {campaign_id!r} already "
                            "submitted")

    from .worker import resolve_builder
    build_fn = resolve_builder(builder or "jepsen_tpu_torch.demo:demo_test")
    build_lock = threading.Lock()

    def build(params):
        import random
        o = dict(options)
        o.update(params)
        with build_lock:
            if "seed" in params:
                random.seed(params["seed"])
            return build_fn(o)

    cells = [{"id": c["id"], "group": c["group"],
              "params": c["params"], "build": build}
             for c in cells_plan]
    child = robust.ChainedLatch(parent=latch())
    # claim the caller's campaign-budget slot LAST, after every 4xx
    # has had its chance: a rejected payload must not burn budget
    adm = admission()
    adm.campaign_slot(caller)

    def run():
        try:
            run_cells(cells, campaign_id=campaign_id,
                      parallel=parallel, device_slots=device_slots,
                      latch=child)
        except CampaignError as e:
            logger.warning("submitted campaign %s refused: %s",
                           campaign_id, e)
        except Exception:  # noqa: BLE001 - background thread
            logger.warning("submitted campaign %s crashed",
                           campaign_id, exc_info=True)
        finally:
            adm.campaign_done(caller)

    try:
        t = threading.Thread(target=run, daemon=True,
                             name=f"jepsen api campaign {campaign_id}")
        with _lock:
            _campaigns[campaign_id] = {"thread": t, "latch": child,
                                       "submitted": store.local_time()}
        t.start()
    except BaseException:   # thread never ran: give the slot back
        adm.campaign_done(caller)
        raise
    from .. import obs
    obs.inc("fleet.api_campaigns")
    return campaign_id, {"campaign": campaign_id,
                         "cells": [c["id"] for c in cells_plan],
                         "status-url": f"/api/campaigns/{campaign_id}",
                         "warnings": len(diags)}


def campaign_status(campaign_id):
    """The pollable status body for one campaign (submitted via the
    API or any other way -- the store is the truth)."""
    campaign_id = _safe_campaign_id(campaign_id)
    data = store.load_campaign(campaign_id)
    with _lock:
        sub = _campaigns.get(campaign_id)
    if data is None and sub is None:
        raise ApiError(404, f"unknown campaign {campaign_id!r}")
    meta = (data or {}).get("meta") or {}
    records = store.latest_campaign_records(campaign_id) if data else []
    out = {"campaign": campaign_id,
           "status": meta.get("status") or "submitted",
           "cells-planned": len(meta.get("cells") or []),
           "cells-done": len(records),
           "outcomes": {},
           "records": records}
    for r in records:
        k = str(r.get("outcome"))
        out["outcomes"][k] = out["outcomes"].get(k, 0) + 1
    if data and data.get("report"):
        out["report"] = {k: v for k, v in data["report"].items()
                         if k not in ("cells", "results")}
    return out
