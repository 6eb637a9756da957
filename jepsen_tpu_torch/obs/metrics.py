"""Metrics registry: counters, gauges, and fixed-bucket histograms (the
port's copy of ``jepsen_tpu/obs/metrics.py``; host-only).

Prometheus-shaped but dependency-free: a `Registry` holds named series
(with optional labels), and `snapshot()` renders everything to one
plain-JSON dict — the ``metrics.json`` artifact store.py writes next to
``results.json``. All mutation is lock-protected; instrumented hot
paths (one op completion = one counter bump + one histogram observe)
stay cheap.

Fleet-plane additions (doc/observability.md):

* **Default labels.** A registry built with ``default_labels``
  (``{campaign, cell, worker}`` for fleet runs) merges them into every
  series key, so a worker's metrics stay attributable after the
  campaign-level fold without call sites threading identity around.
* **Crash-safe journal.** `attach_journal` appends a full snapshot
  line at most every ``flush_s`` seconds (and on `journal_now`), so a
  kill -9'd process leaves its last metrics snapshot on disk;
  `load_metrics_journal` reads the last parseable line back
  (torn-tail tolerant). The atomic ``metrics.json`` dump stays the
  finalize; `close_journal(remove=True)` retires the journal.
* **Exposition.** `render_prometheus` renders registries (and
  structured gauge/counter sections) in the Prometheus text format —
  the body of the fleet service's ``GET /api/metrics``.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time as _time

#: fixed latency buckets, seconds: ~log-spaced from 100 µs to 2 min.
#: Counts are PER-BUCKET (not cumulative); values above the last bound
#: land in one overflow bucket, so len(counts) == len(bounds) + 1.
DEFAULT_LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def bucket_index(bounds, value):
    """Index of the bucket ``value`` falls in: first i with value <=
    bounds[i], else len(bounds) (the overflow bucket)."""
    for i, b in enumerate(bounds):
        if value <= b:
            return i
    return len(bounds)


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max."""

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS_S):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value):
        value = float(value)
        self.counts[bucket_index(self.bounds, value)] += 1
        self.sum += value
        self.count += 1
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def quantile(self, q):
        """Estimated q-quantile (0..1) by linear walk over the buckets;
        None when empty. Values in the overflow bucket report the max."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                if i == len(self.bounds):
                    return self.max
                return self.bounds[i]
        return self.max

    def to_dict(self):
        return {"buckets_le": list(self.bounds),
                "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max}


def _key_str(name, labels):
    """The flattened ``name{k=v,...}`` form (labels sorted) used in
    snapshot()/metrics.json — unchanged on-disk shape."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def _key(name, labels):
    """Back-compat helper: flattened key from a labels mapping."""
    return _key_str(name, tuple(sorted(
        (str(k), str(v)) for k, v in (labels or {}).items())))


def parse_flat_key(key):
    """``name{k=v,...}`` -> (name, {k: v}) — the inverse of the
    snapshot()/metrics.json flattened keys, shared by every consumer
    (web's utilization table, the campaign metrics fold, the fleet
    dispatcher's live re-fold). Best effort: label VALUES containing
    ``=``/``,`` parse wrong, which costs one folded cell, not data."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = {}
    for part in rest.rstrip("}").split(","):
        k, _, v = part.partition("=")
        labels[k] = v
    return name, labels


class Registry:
    """Thread-safe home for counters, gauges, and histograms.

    Series are keyed internally by ``(name, ((label, value), ...))``
    tuples (labels sorted), so the exposition renderer never has to
    re-parse flattened key strings whose label VALUES may themselves
    contain ``=``/``,`` (campaign cell ids do). ``snapshot()`` still
    emits the flattened ``name{k=v,...}`` strings metrics.json always
    had."""

    def __init__(self, default_labels=None):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}
        self._defaults = {str(k): str(v)
                          for k, v in (default_labels or {}).items()
                          if v is not None}
        self._journal = None
        self._journal_path = None
        self._journal_flush_s = 0.5
        self._journal_last = 0.0
        self._journal_stop = None
        #: mutation counter; the background flusher skips the snapshot
        #: when nothing changed since its last write
        self._mut = 0
        self._journal_mut = -1
        #: (name, raw label items) -> built key. Instrumented hot
        #: paths hit the same few (name, labels) shapes thousands of
        #: times per run; caching skips the default-merge + sort +
        #: str() walk. Bounded so a high-cardinality label can't leak.
        self._kcache = {}

    def _k(self, name, labels):
        try:
            ck = (name, tuple(labels.items()))
            k = self._kcache.get(ck)
        except TypeError:       # unhashable label value
            ck = k = None
        if k is None:
            if self._defaults:
                labels = {**self._defaults, **labels}
            k = (str(name), tuple(sorted(
                (str(kk), str(v)) for kk, v in labels.items())))
            if ck is not None and len(self._kcache) < 4096:
                self._kcache[ck] = k
        return k

    def inc(self, name, n=1, **labels):
        k = self._k(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + n
            self._mut += 1
            self._maybe_journal()

    def set_gauge(self, name, value, **labels):
        k = self._k(name, labels)
        with self._lock:
            self._gauges[k] = value
            self._mut += 1
            self._maybe_journal()

    def max_gauge(self, name, value, **labels):
        """Set a gauge to max(current, value) — high-water marks."""
        k = self._k(name, labels)
        with self._lock:
            cur = self._gauges.get(k)
            if cur is None or value > cur:
                self._gauges[k] = value
            self._mut += 1
            self._maybe_journal()

    def observe(self, name, value, buckets=None, **labels):
        k = self._k(name, labels)
        with self._lock:
            hist = self._histograms.get(k)
            if hist is None:
                hist = self._histograms[k] = Histogram(
                    buckets or DEFAULT_LATENCY_BUCKETS_S)
            hist.observe(value)
            self._mut += 1
            self._maybe_journal()

    def observe_many(self, name, values, buckets=None, **labels):
        """Fold a batch of observations into one histogram under a
        single lock acquisition + key construction — the interpreter's
        per-op telemetry fold uses this so the op hot path never
        touches the registry."""
        if not values:
            return
        k = self._k(name, labels)
        with self._lock:
            hist = self._histograms.get(k)
            if hist is None:
                hist = self._histograms[k] = Histogram(
                    buckets or DEFAULT_LATENCY_BUCKETS_S)
            for v in values:
                hist.observe(v)
            self._mut += 1
            self._maybe_journal()

    def histogram(self, name, **labels):
        with self._lock:
            return self._histograms.get(self._k(name, labels))

    def counter_value(self, name, **labels):
        with self._lock:
            return self._counters.get(self._k(name, labels), 0)

    def gauge_value(self, name, **labels):
        with self._lock:
            return self._gauges.get(self._k(name, labels))

    def _snapshot_locked(self):
        return {
            "counters": {_key_str(n, lb): v
                         for (n, lb), v in self._counters.items()},
            "gauges": {_key_str(n, lb): v
                       for (n, lb), v in self._gauges.items()},
            "histograms": {_key_str(n, lb): h.to_dict()
                           for (n, lb), h in self._histograms.items()},
        }

    def snapshot(self):
        """One plain-JSON dict of everything: the metrics.json payload."""
        with self._lock:
            return self._snapshot_locked()

    def series(self):
        """The structured view the Prometheus renderer consumes:
        {"counters"/"gauges": {(name, labels): value}, "histograms":
        {(name, labels): to_dict()}}."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": {k: h.to_dict()
                                   for k, h in
                                   self._histograms.items()}}

    # -- crash-safe journal ---------------------------------------------

    def attach_journal(self, path, flush_s=0.5):
        """Start journaling snapshots to ``path``: one full-snapshot
        JSON line immediately, then at most one per ``flush_s``
        seconds as mutations land. Contained: journaling failures drop
        the journal, never the run."""
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with self._lock:
            self._close_journal_locked()
            try:
                self._journal = open(path, "w")
            except OSError:
                return None
            self._journal_path = path
            self._journal_flush_s = max(0.0, float(flush_s))
            self._journal_last = 0.0
            self._journal_write_locked(_time.monotonic())
            if self._journal_flush_s > 0:
                stop = self._journal_stop = threading.Event()
                threading.Thread(
                    target=self._journal_loop, args=(stop,),
                    name="obs-metrics-journal", daemon=True).start()
            return path

    def _journal_loop(self, stop):
        """Background flusher: one snapshot line per flush interval,
        skipped while nothing mutated. Keeps the mutation hot paths to
        a counter bump — no inline serialization, no interval check —
        and snapshots a quiet-but-alive registry's final state even
        when no further mutation ever lands."""
        while not stop.wait(self._journal_flush_s):
            with self._lock:
                if self._journal is None or self._journal_stop is not stop:
                    return
                if self._mut != self._journal_mut:
                    self._journal_write_locked(_time.monotonic())

    def _maybe_journal(self):
        # flush_s <= 0 = synchronous per-mutation durability; with a
        # positive interval the background flusher owns the writes
        if self._journal is not None and self._journal_flush_s <= 0:
            self._journal_write_locked(_time.monotonic())

    def _journal_write_locked(self, now):
        try:
            self._journal.write(
                json.dumps(self._snapshot_locked(), default=str) + "\n")
            self._journal.flush()
            self._journal_last = now
            self._journal_mut = self._mut
        except (OSError, ValueError, TypeError):
            self._journal = None

    def journaling(self):
        """True while an incremental journal is attached and healthy."""
        return self._journal is not None

    def journal_now(self):
        """Force one snapshot line to disk regardless of the flush
        interval (search heartbeats call this so a watchdog-killed
        search leaves its last counters readable)."""
        with self._lock:
            if self._journal is not None:
                self._journal_write_locked(_time.monotonic())

    def _close_journal_locked(self):
        if self._journal_stop is not None:
            self._journal_stop.set()
            self._journal_stop = None
        f, self._journal = self._journal, None
        if f is not None:
            try:
                f.close()
            except OSError:  # pragma: no cover
                pass

    def close_journal(self, remove=False):
        with self._lock:
            self._close_journal_locked()
            path, self._journal_path = self._journal_path, None
        if remove and path:
            import os
            try:
                os.remove(path)
            except OSError:
                pass


def load_metrics_journal(path):
    """The LAST parseable snapshot line of a metrics journal, or None.
    A process killed mid-append leaves a torn final line; the line
    before it is the freshest complete snapshot."""
    last = None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    snap = json.loads(line)
                except ValueError:
                    continue
                if isinstance(snap, dict):
                    last = snap
    except OSError:
        return None
    return last


# ---------------------------------------------------------------------------
# Prometheus text exposition (the /api/metrics body)

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name, prefix="jepsen"):
    n = _PROM_NAME_RE.sub("_", str(name))
    if prefix:
        n = f"{prefix}_{n}"
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _prom_escape(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels, extra=()):
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    inner = ",".join(f'{_PROM_NAME_RE.sub("_", str(k))}='
                     f'"{_prom_escape(v)}"' for k, v in items)
    return "{" + inner + "}"


def _norm_series(section):
    """One section -> (counters, gauges, histograms) with
    ``(name, ((k, v), ...))`` keys. Accepts a Registry or a structured
    dict whose keys may be plain names (no labels) or key tuples."""
    if isinstance(section, Registry):
        s = section.series()
    else:
        s = section or {}

    def norm(d):
        out = {}
        for k, v in (d or {}).items():
            if isinstance(k, tuple):
                out[(str(k[0]), tuple(k[1]))] = v
            else:
                out[(str(k), ())] = v
        return out

    return (norm(s.get("counters")), norm(s.get("gauges")),
            norm(s.get("histograms")))


def _num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def render_prometheus(sections, prefix="jepsen"):
    """Render registries/sections in the Prometheus text exposition
    format (version 0.0.4). ``sections`` is an iterable of Registry
    instances or structured dicts ({"counters": {...}, "gauges":
    {...}, "histograms": {...}}); later sections win on exact key
    collisions. Histograms convert to cumulative ``_bucket`` series
    (+Inf included) plus ``_sum``/``_count``. Output is sorted —
    deterministic for identical inputs — and non-numeric gauge values
    are skipped (a path-valued gauge has no exposition)."""
    counters, gauges, histograms = {}, {}, {}
    for section in sections:
        c, g, h = _norm_series(section)
        counters.update(c)
        gauges.update(g)
        histograms.update(h)

    lines = []

    def family(kind, series, suffix=""):
        by_name = {}
        for (name, labels), v in series.items():
            n = _num(v)
            if n is None:   # a path-valued gauge has no exposition --
                continue    # and must not leave a dangling TYPE line
            by_name.setdefault(name, []).append((labels, n))
        for name in sorted(by_name):
            pname = _prom_name(name, prefix)
            lines.append(f"# TYPE {pname} {kind}")
            for labels, n in sorted(by_name[name]):
                body = int(n) if float(n).is_integer() else n
                lines.append(
                    f"{pname}{suffix}{_prom_labels(labels)} {body}")

    family("counter", counters)
    family("gauge", gauges)

    by_name = {}
    for (name, labels), h in histograms.items():
        by_name.setdefault(name, []).append((labels, h))
    for name in sorted(by_name):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} histogram")
        for labels, h in sorted(by_name[name],
                                key=lambda lh: lh[0]):
            if isinstance(h, Histogram):
                h = h.to_dict()
            bounds = h.get("buckets_le") or []
            cum = 0
            for b, c in zip(bounds, h.get("counts") or []):
                cum += c
                lines.append(f"{pname}_bucket"
                             f"{_prom_labels(labels, ((('le'), f'{b:g}'),))}"
                             f" {cum}")
            lines.append(f"{pname}_bucket"
                         f"{_prom_labels(labels, (('le', '+Inf'),))}"
                         f" {h.get('count', 0)}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} "
                         f"{h.get('sum', 0.0)}")
            lines.append(f"{pname}_count{_prom_labels(labels)} "
                         f"{h.get('count', 0)}")
    return "\n".join(lines) + "\n"
