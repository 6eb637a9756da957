"""Unified observability: tracing + metrics (the port's copy of
``jepsen_tpu/obs/__init__.py``; host-only).

One module gives every layer of the port (the checkers, the analyzers,
``store``, and the device searches: ``torch_wgl``, the key batch, the
streaming fold, the txn closure) the same two primitives:

* a span-based **tracer** (`trace.Tracer`) emitting Chrome-trace /
  Perfetto-compatible ``trace.jsonl``;
* a **metrics registry** (`metrics.Registry`) of counters, gauges, and
  latency histograms serialized to ``metrics.json``.

Binding is a module-global pair set by `bind()` — *not* a contextvar —
because instrumented code runs on threads the binder never created
(interpreter workers, checker-competition racers, web handlers); all of
them must see the active sinks. Span *nesting* still flows through a
contextvar (trace._span_stack), so parentage follows the
`contextvars.copy_context()` snapshots the thread fan-outs already
take.

Every facade function below is a safe no-op while nothing is bound:
off-by-default, one global read + falsy check per call site, so the
uninstrumented hot paths pay nothing measurable. A caller binds a
fresh pair per test with ``run_scope(test)`` (opt out with
``test["obs?"] = False``; ``core.run`` does this) and
``store.write_obs`` persists both artifacts next to ``results.json``.
The campaign layer's folds (``obs/merge.py``, ``obs/bubbles.py``) and
the perf trend gate (``obs/trend.py``) are submodules, imported
where used.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time as _time

from .metrics import (DEFAULT_LATENCY_BUCKETS_S, Histogram, Registry,
                      load_metrics_journal, render_prometheus)
from .trace import Tracer, current_span, load_trace, trace_meta

__all__ = [
    "Tracer", "Registry", "Histogram", "DEFAULT_LATENCY_BUCKETS_S",
    "bind", "run_scope", "sink_scope", "tracer", "registry",
    "current_sinks", "run_config", "live_registries", "enabled",
    "current_span",
    "load_trace", "trace_meta", "load_metrics_journal",
    "render_prometheus", "span", "instant", "complete", "counter_track",
    "window_start", "window_end", "name_thread", "now_ns", "inc",
    "set_gauge", "max_gauge", "observe", "observe_many", "gen_event",
    "flush",
]

_lock = threading.Lock()
_tracer = None
_registry = None
#: active bind() scopes in bind order; the newest is the live pair.
#: Exit removes a scope's OWN entry wherever it sits, so overlapping
#: scopes (campaign cells overlap core.runs) unwind in any order
#: without severing a live sibling or leaking a dead pair.
_bind_stack = []

#: run-scoped sinks: (tracer, registry, config) for the RUN this
#: logical context belongs to. The global pair above is
#: last-binder-wins, so with OVERLAPPING campaign cells a device
#: search that read the globals could capture a SIBLING cell's sinks
#: and fold its heartbeat counters into the wrong {campaign, cell}
#: series. The contextvar rides the `contextvars.copy_context()`
#: snapshots the thread fan-outs already take, so code on a run's own
#: threads resolves the run's own pair; threads outside any run fall
#: back to the globals.
_ctx_sinks = contextvars.ContextVar("jepsen_obs_run_sinks",
                                    default=None)


def tracer():
    """The active Tracer, or None."""
    return _tracer


def registry():
    """The active Registry, or None."""
    return _registry


def current_sinks():
    """(tracer, registry) for THIS logical context: the run-scoped
    pair when inside a run (correct even while a sibling campaign
    cell holds the process-global binding), else the globals. The
    device search sessions (obs.search.capture) resolve through this
    so two concurrent cells' heartbeat counters stop folding into one
    series."""
    ctx = _ctx_sinks.get()
    if ctx is not None:
        return ctx[0], ctx[1]
    return _tracer, _registry


def run_config():
    """The run-scoped obs config mapping (progress-interval-s, ...),
    or {} outside any run scope."""
    ctx = _ctx_sinks.get()
    return ctx[2] if ctx is not None and ctx[2] else {}


@contextlib.contextmanager
def sink_scope(tr, reg, config=None):
    """Pin (tracer, registry) as THIS context's run-scoped sinks
    without touching the process-global binding — how a thread that
    captured its run's pair at construction (the monitor) makes the
    search sessions it drives resolve that pair instead of whatever
    the globals currently say."""
    token = _ctx_sinks.set((tr, reg, dict(config or {})))
    try:
        yield (tr, reg)
    finally:
        _ctx_sinks.reset(token)


def live_registries():
    """Every registry with an open bind() scope, oldest first,
    deduped. /api/metrics renders ALL of them (each run's registry
    carries its own {campaign, cell} default labels, so concurrent
    cells expose distinct series), not just the newest binder's."""
    with _lock:
        pairs = list(_bind_stack)
    out = []
    for _tr, reg in pairs:
        if reg is not None and all(reg is not r for r in out):
            out.append(reg)
    return out


def enabled():
    return _tracer is not None or _registry is not None


@contextlib.contextmanager
def bind(tr=None, reg=None):
    """Install (tracer, registry) as the process-wide sinks for the
    duration. Re-entrant for same-thread nesting: the previous pair is
    restored on exit.

    OVERLAPPING binds (campaign cells run core.run concurrently) get
    last-binder-wins semantics: the live pair is the newest still-open
    scope's, and a scope's exit removes its OWN stack entry wherever
    it sits — so the first cell to FINISH can no longer null out a
    still-running sibling's binding mid-run (telemetry then
    cross-attributes to the newest binder, documented best-effort,
    instead of silently vanishing), and the last scope out always
    unbinds cleanly."""
    global _tracer, _registry
    entry = (tr, reg)
    with _lock:
        _bind_stack.append(entry)
        _tracer, _registry = tr, reg
    try:
        yield (tr, reg)
    finally:
        with _lock:
            for i in range(len(_bind_stack) - 1, -1, -1):
                if _bind_stack[i] is entry:
                    del _bind_stack[i]
                    break
            _tracer, _registry = _bind_stack[-1] if _bind_stack \
                else (None, None)


def run_scope(test):
    """The per-test-run binding `core.run` uses: creates a fresh tracer
    + registry (unless ``test["obs?"]`` is falsy), parks them in
    ``test["obs"]`` so store.write_obs can persist them, and binds them
    for the run's duration.

    ``test["obs-context"]`` (set by the campaign scheduler / fleet
    worker: ``{campaign, cell, worker}``) becomes the tracer's
    trace_meta context AND the registry's default labels, so every
    span and metric the run emits stays attributable after the
    campaign-level merge.

    The pair is ALSO pinned as this context's run-scoped sinks
    (`sink_scope`), so the run's own threads — checker competition
    racers, the device search host loops — resolve this run's pair
    through `current_sinks` even while an overlapping sibling cell
    holds the process-global binding."""
    if not test.get("obs?", True):
        test.pop("obs", None)
        return contextlib.nullcontext((None, None))
    ctx = test.get("obs-context")
    tr = Tracer(context=ctx)
    reg = Registry(default_labels=ctx)
    test["obs"] = {"tracer": tr, "registry": reg}
    cfg = {k: test[k] for k in ("progress-interval-s", "phases?")
           if test.get(k) is not None}

    @contextlib.contextmanager
    def scope():
        with bind(tr, reg):
            with sink_scope(tr, reg, cfg):
                yield (tr, reg)

    return scope()


# ---------------------------------------------------------------------------
# tracing facade (no-ops while unbound)

def now_ns():
    tr = _tracer
    return tr.now_ns() if tr is not None else _time.monotonic_ns()


def span(name, cat="lifecycle", tid=None, **args):
    """Context manager: a nested trace span (no-op while unbound)."""
    tr = _tracer
    if tr is None:
        return contextlib.nullcontext()
    return tr.span(name, cat=cat, tid=tid, args=args or None)


def instant(name, cat="default", tid=None, **args):
    tr = _tracer
    if tr is not None:
        tr.instant(name, cat=cat, tid=tid, args=args or None)


def complete(name, ts_ns, dur_ns, cat="default", tid=None, **args):
    tr = _tracer
    if tr is not None:
        tr.complete(name, ts_ns, dur_ns, cat=cat, tid=tid,
                    args=args or None)


def counter_track(name, cat="default", **values):
    tr = _tracer
    if tr is not None:
        tr.counter(name, values, cat=cat)


def window_start(name, wid, cat="nemesis", **args):
    tr = _tracer
    if tr is not None:
        tr.async_begin(name, wid, cat=cat, args=args or None)


def window_end(name, wid, cat="nemesis", **args):
    tr = _tracer
    if tr is not None:
        tr.async_end(name, wid, cat=cat, args=args or None)


def name_thread(tid, name):
    tr = _tracer
    if tr is not None:
        tr.name_thread(tid, name)


def flush(force_metrics=True):
    """Force the bound sinks' journals to disk (no-op when unbound or
    unjournaled): the facade for code that just produced something a
    crash must not lose."""
    tr, reg = _tracer, _registry
    if tr is not None:
        tr.flush_journal()
    if reg is not None and force_metrics:
        reg.journal_now()


def gen_event(tag, kind, payload):
    """The generator.trace combinator's tap: one instant event per
    traced op/update, alongside its existing log line. The repr is
    capped like every other instrumentation site — traced generators
    over large values must not bloat the event buffer."""
    tr = _tracer
    if tr is not None:
        tr.instant(f"gen.{tag}", cat="generator",
                   args={"kind": kind, "event": repr(payload)[:200]})


# ---------------------------------------------------------------------------
# metrics facade (no-ops while unbound)

def inc(name, n=1, **labels):
    reg = _registry
    if reg is not None:
        reg.inc(name, n, **labels)


def set_gauge(name, value, **labels):
    reg = _registry
    if reg is not None:
        reg.set_gauge(name, value, **labels)


def max_gauge(name, value, **labels):
    reg = _registry
    if reg is not None:
        reg.max_gauge(name, value, **labels)


def observe(name, value, buckets=None, **labels):
    reg = _registry
    if reg is not None:
        reg.observe(name, value, buckets=buckets, **labels)


def observe_many(name, values, buckets=None, **labels):
    """Batch form of `observe`: one lock acquisition for the lot."""
    reg = _registry
    if reg is not None:
        reg.observe_many(name, values, buckets=buckets, **labels)
