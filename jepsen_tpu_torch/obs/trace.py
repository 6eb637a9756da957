"""Span-based tracer emitting Chrome-trace / Perfetto-compatible events
(the port's copy of ``jepsen_tpu/obs/trace.py``; host-only).

The reference framework has no tracing at all; every perf claim in this
repo used to rest on ad-hoc timers (SURVEY.md §5). This tracer turns a
test run into a self-evidencing artifact: `Tracer` collects events in
memory (thread-safe, bounded) and `dump()` writes them in the Chrome
Trace Event JSON format — one event object per line, so the file is
simultaneously grep/`jq`-able line-by-line JSONL *and* loadable as-is in
`chrome://tracing` and Perfetto's JSON importer (the format spec makes
the enclosing ``[``/``]`` optional and tolerates trailing commas; the
dump writes a leading ``[`` line and a trailing comma per event).

Event kinds used here:

* ``X`` complete events — spans with a start timestamp and duration
  (lifecycle phases, per-op invoke→complete, remote exec calls).
* ``i`` instant events — point-in-time markers (generator trace taps,
  search heartbeats).
* ``C`` counter events — numeric series Perfetto renders as tracks
  (WGL frontier depth, states explored).
* ``b``/``e`` async events — durations that start and end on different
  threads (nemesis fault windows: the ``start`` and ``stop`` ops run as
  separate nemesis invocations).
* ``M`` metadata events — thread names for the logical-worker tids.

Timestamps are microseconds relative to the tracer's creation
(``time.monotonic_ns`` based, like util.relative_time). Span *nesting*
propagates through a contextvar stack, so `contextvars.copy_context()`
— which the interpreter's worker spawn and control's on_nodes fan-out
already use — carries the parent span across threads for free.

Two additions for the FLEET telemetry plane (doc/observability.md):

* **Wall-clock anchor + context.** Every tracer records the wall epoch
  (``time.time_ns``) at creation and an optional ``context`` mapping
  ({campaign, cell, worker} for fleet runs). Both ride in a
  ``trace_meta`` metadata event at the head of the dump/journal, which
  is what lets ``obs.merge`` place per-worker traces on one normalized
  timeline and attribute whole files to their campaign cell without
  per-event label bloat.
* **Crash-safe journal.** `attach_journal` mirrors every event to an
  append+flush journal file (``trace.jsonl.journal``, the
  store.HistoryJournal discipline): a kill -9'd process leaves
  everything up to the kill on disk, torn final line dropped on read.
  `dump()` stays the atomic finalize; once it succeeds the caller
  retires the journal (`close_journal(remove=True)`).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time as _time

#: parent-span stack: a tuple of span names, carried across threads by
#: the contextvars snapshots the interpreter/control fan-outs already
#: take (empty tuple = root)
_span_stack = contextvars.ContextVar("obs_span_stack", default=())

#: hard cap on buffered events: a runaway heartbeat loop must not eat
#: the host's memory; overflow increments ``dropped`` instead
MAX_EVENTS = 1_000_000


def current_span():
    """Name of the innermost active span, or None at the root."""
    stack = _span_stack.get()
    return stack[-1] if stack else None


class Tracer:
    """Collects Chrome-trace events; `dump(path)` persists them."""

    def __init__(self, max_events=MAX_EVENTS, context=None):
        self._events = []
        self._lock = threading.Lock()
        self._t0 = _time.monotonic_ns()
        #: wall-clock anchor for cross-process merging: the wall time
        #: this tracer's ts=0 corresponds to (best effort -- a time
        #: nemesis stepping the wall clock skews it, which is exactly
        #: what the merge's handshake-based normalization corrects)
        self.epoch_ns = _time.time_ns()
        self.context = dict(context or {})
        self._pid = os.getpid()
        self._named_tids = set()
        self._max_events = max_events
        self.dropped = 0
        self._journal = None
        self._journal_path = None
        self._journal_flush_s = 0.0
        self._journal_last = 0.0
        self._journal_stop = None
        #: serialized forms of ``_events[:len(_ser)]`` — filled lazily
        #: in batches by `_serialized_upto` (events are never mutated
        #: after _emit, so deferring is safe). Each event is JSON-
        #: encoded exactly ONCE and the string is shared by the
        #: journal's incremental appends and the final dump().
        self._ser = []
        #: how many events the journal has on disk already
        self._journal_written = 0

    # -- clock ----------------------------------------------------------

    def now_ns(self):
        """ns since this tracer's epoch (monotonic)."""
        return _time.monotonic_ns() - self._t0

    # -- raw emission ---------------------------------------------------

    def _emit(self, ev):
        # lock-free: CPython's list.append is atomic, and the
        # serialization cache / journal / dump only ever read a
        # length-prefix snapshot taken under the lock. The cap check
        # may overshoot by a few racing events (it is a memory guard,
        # not a contract) and a racing dropped count may undercount —
        # both harmless, and the hot path pays one append.
        if len(self._events) >= self._max_events:
            self.dropped += 1
            return
        self._events.append(ev)
        # flush_s <= 0 = synchronous per-event durability; with a
        # positive interval the background flusher owns the writes.
        # The unlocked peek is a fast-path filter only -- the journal
        # handle is re-checked under the lock, so a close racing this
        # emit can't flush into a None/closed file
        if self._journal is not None and self._journal_flush_s <= 0:
            with self._lock:
                if self._journal is not None:
                    self._journal_flush_locked(_time.monotonic())

    def _serialized_upto(self, n):
        """Extend the one-shot serialization cache to cover the first
        ``n`` events and return it (lock held)."""
        ser, events = self._ser, self._events
        while len(ser) < n:
            ser.append(json.dumps(events[len(ser)],
                                  separators=(",", ":")))
        return ser

    # -- crash-safe journal ---------------------------------------------

    def meta_event(self):
        """The ``trace_meta`` metadata event: wall epoch + context.
        Written at the head of every dump/journal (never buffered, so
        it doesn't count against the event cap)."""
        ev = self._base("trace_meta", "i", "__metadata", 0, self._pid)
        ev["s"] = "g"
        ev["args"] = {"epoch_ns": self.epoch_ns}
        if self.context:
            ev["args"]["context"] = dict(self.context)
        return ev

    def attach_journal(self, path, flush_s=0.5):
        """Start mirroring events to an incremental journal at ``path``
        (one JSON line per event, HistoryJournal discipline): already
        buffered events are backfilled, then every `_emit` enqueues.
        The hot path pays one list append; serialization + write +
        flush happen in batches at most every ``flush_s`` seconds
        (<= 0 = every event); `flush_journal` forces one. Failures are
        contained -- the journal is crash insurance, never
        load-bearing."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with self._lock:
            self.close_journal_locked()
            try:
                f = open(path, "w")
                n = len(self._events)
                f.write(json.dumps(self.meta_event()) + "\n")
                f.write("".join(s + "\n"
                                for s in self._serialized_upto(n)[:n]))
                f.flush()
            except OSError:
                return None
            self._journal = f
            self._journal_path = path
            self._journal_written = n
            self._journal_flush_s = max(0.0, float(flush_s))
            self._journal_last = _time.monotonic()
            if self._journal_flush_s > 0:
                stop = self._journal_stop = threading.Event()
                threading.Thread(
                    target=self._journal_loop, args=(stop,),
                    name="obs-trace-journal", daemon=True).start()
            return path

    def _journal_loop(self, stop):
        """Background flusher: every flush interval, serialize + write
        whatever the hot path appended since the last pass. Keeps the
        emit path to a single list append and — unlike the old
        on-mutation check — flushes the tail even while the tracer is
        idle (a wedged run's last events still reach disk)."""
        while not stop.wait(self._journal_flush_s):
            with self._lock:
                if self._journal is None or self._journal_stop is not stop:
                    return
                self._journal_flush_locked(_time.monotonic())

    def _journal_flush_locked(self, now):
        """Serialize + append everything not yet on disk, then flush
        (lock held). A failed write drops the journal rather than the
        run."""
        try:
            n = len(self._events)
            if self._journal_written < n:
                ser = self._serialized_upto(n)
                self._journal.write("".join(
                    s + "\n"
                    for s in ser[self._journal_written:n]))
                self._journal_written = n
            self._journal.flush()
            self._journal_last = now
        except (OSError, ValueError):
            self._journal = None

    def journaling(self):
        """True while an incremental journal is attached and healthy."""
        return self._journal is not None

    def flush_journal(self):
        """Force the journal's buffered tail to disk (search
        heartbeats call this: a wedged search killed by the watchdog
        must leave its LAST heartbeat readable)."""
        with self._lock:
            if self._journal is None:
                return
            self._journal_flush_locked(_time.monotonic())

    def close_journal_locked(self):
        if self._journal_stop is not None:
            self._journal_stop.set()
            self._journal_stop = None
        f, self._journal = self._journal, None
        if f is not None:
            try:
                n = len(self._events)
                if self._journal_written < n:
                    ser = self._serialized_upto(n)
                    f.write("".join(
                        s + "\n"
                        for s in ser[self._journal_written:n]))
                    self._journal_written = n
                f.close()
            except (OSError, ValueError):  # pragma: no cover
                pass

    def close_journal(self, remove=False):
        """Stop journaling; with ``remove``, delete the journal file
        (the finalize step once the atomic dump exists)."""
        with self._lock:
            self.close_journal_locked()
            path, self._journal_path = self._journal_path, None
        if remove and path:
            try:
                os.remove(path)
            except OSError:
                pass

    def _base(self, name, ph, cat, ts_ns, tid):
        if tid is None:
            tid = threading.get_ident()
        return {"name": name, "ph": ph, "cat": cat,
                "ts": ts_ns / 1e3,            # Chrome trace: microseconds
                "pid": self._pid, "tid": tid}

    def name_thread(self, tid, name):
        """Emit a thread-name metadata event once per tid (Perfetto shows
        these as track labels — e.g. logical worker ids)."""
        with self._lock:
            if tid in self._named_tids:
                return
            self._named_tids.add(tid)
        ev = self._base("thread_name", "M", "__metadata", 0, tid)
        ev["args"] = {"name": str(name)}
        self._emit(ev)

    # -- event kinds ----------------------------------------------------

    def complete(self, name, ts_ns, dur_ns, cat="default", tid=None,
                 args=None):
        """An ``X`` span with an externally measured start/duration (the
        interpreter measures op latency itself; the tracer just
        records). Built as one dict literal — this is the per-op hot
        path and `_base` + mutation costs a measurable fraction of a
        noop op."""
        ev = {"name": name, "ph": "X", "cat": cat, "ts": ts_ns / 1e3,
              "pid": self._pid,
              "tid": threading.get_ident() if tid is None else tid,
              "dur": dur_ns / 1e3 if dur_ns > 0 else 0.0}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name, cat="default", tid=None, args=None):
        ev = self._base(name, "i", cat, self.now_ns(), tid)
        ev["s"] = "t"                         # thread-scoped instant
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name, values, cat="default"):
        """A ``C`` event: {series: number} rendered as counter tracks."""
        ev = self._base(name, "C", cat, self.now_ns(), self._pid)
        ev["args"] = {k: float(v) for k, v in values.items()}
        self._emit(ev)

    def async_begin(self, name, wid, cat="default", args=None):
        ev = self._base(name, "b", cat, self.now_ns(),
                        threading.get_ident())
        ev["id"] = str(wid)
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_end(self, name, wid, cat="default", args=None):
        ev = self._base(name, "e", cat, self.now_ns(),
                        threading.get_ident())
        ev["id"] = str(wid)
        if args:
            ev["args"] = args
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, name, cat="lifecycle", tid=None, args=None):
        """A nested span: records an ``X`` event on exit and pushes the
        name onto the contextvar parent stack for the duration, so spans
        opened inside (including in threads spawned from a context
        snapshot taken inside) carry ``args.parent``."""
        stack = _span_stack.get()
        token = _span_stack.set(stack + (name,))
        t0 = self.now_ns()
        try:
            yield
        finally:
            _span_stack.reset(token)
            a = dict(args or {})
            if stack:
                a["parent"] = stack[-1]
            self.complete(name, t0, self.now_ns() - t0, cat=cat,
                          tid=tid, args=a or None)

    # -- persistence ----------------------------------------------------

    def events(self):
        with self._lock:
            return list(self._events)

    def dump(self, path):
        """Write trace.jsonl: a ``[`` line, then one event per line with
        a trailing comma. Loads directly in chrome://tracing / Perfetto
        (the JSON array format's closing bracket is optional) and stays
        line-parseable (strip the trailing comma). A buffer overflow is
        recorded IN the file (a final ``trace_truncated`` instant with
        the dropped count) — a silently truncated trace reads as
        "activity stopped here", which is exactly the wrong conclusion
        during a stall diagnosis."""
        with self._lock:
            n = len(self._events)
            lines = [json.dumps(self.meta_event(),
                                separators=(",", ":"))]
            lines += self._serialized_upto(n)[:n]
        if self.dropped:
            ev = self._base("trace_truncated", "i", "__metadata",
                            self.now_ns(), self._pid)
            ev["s"] = "g"
            ev["args"] = {"dropped_events": self.dropped,
                          "max_events": self._max_events}
            lines.append(json.dumps(ev, separators=(",", ":")))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("[\n")
            f.write("".join(s + ",\n" for s in lines))
        os.replace(tmp, path)
        return path


def load_trace(path):
    """Parse a trace.jsonl back into a list of event dicts (tolerant of
    the leading ``[`` and trailing commas — i.e. exactly what dump
    writes, and also plain one-object-per-line JSONL). Unparseable
    lines are DROPPED with a warning, not fatal: an incremental
    journal's torn final line (killed mid-append) must not make the
    surviving telemetry unreadable."""
    import logging
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                logging.getLogger(__name__).warning(
                    "dropping unparseable trace line in %s", path)
    return events


def trace_meta(events):
    """The ``trace_meta`` args of a loaded trace (epoch_ns + context),
    or None for traces predating the anchor."""
    for ev in events:
        if ev.get("name") == "trace_meta":
            return ev.get("args") or {}
    return None
