"""Persistence: writes tests, histories, and results to disk (reference
jepsen/src/jepsen/store.clj; the port's copy of ``jepsen_tpu/store.py``,
whole and host-only, so the two packages read each other's run
directories).

``base_dir`` is settable: tests and ``chip_smoke.py`` point it at a
temporary directory. The campaign, compile-ledger and artifact-sync
directories below are the JAX package's layout, so a store shared by
both packages browses the same: the port's campaign scheduler and
fleet (``campaign/journal.py``) write the campaign directories,
``fleet/ledger.py`` the compile ledger, and ``fleet/sync.py`` stages
mirrored runs in the artifact-sync area.

Layout mirrors the reference: ``store/<name>/<start-time>/`` per test run,
with ``store/current``, ``store/latest`` and ``store/<name>/latest``
symlinks (store.clj:118-147, 305-343). Serialization is redesigned for
Python: the reference's Fressian binary (store.clj:31-116) becomes
``test.json`` (the test map minus nonserializable keys, with a permissive
encoder), and histories are written both human-readable (``history.txt``)
and machine-readable (``history.jsonl``, one op per line — the EDN
analogue). The two-phase model is identical: ``save_1`` persists
test+history right after the run, before analysis; ``save_2`` re-persists
with results (store.clj:388-413), so analysis is re-runnable offline via
``load`` + ``load_history``.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import os.path
import pathlib
import shutil
import threading

from . import history as h
from .util import op_str

logger = logging.getLogger(__name__)

#: Root directory for all test data (store.clj:29).
base_dir = "store"

#: Test-map keys that can't (or shouldn't) be serialized
#: (store.clj:160-162).
DEFAULT_NONSERIALIZABLE_KEYS = {
    "db", "os", "net", "client", "checker", "nemesis", "generator", "model",
    "remote", "barrier", "sessions", "dummy-log", "obs",
    "analysis-done?", "searchplan-done?", "certify-done?", "abort",
    "journal", "partial-history", "monitor-evidence", "certificate",
    "op-sinks", "monitor-device-sem",
}

#: on-disk name of the incremental history journal (one JSON op per
#: line, appended as the run progresses; finalized into history.jsonl)
JOURNAL_FILE = "history.jsonl.journal"

#: incremental telemetry journals (same crash-only discipline as the
#: history journal: appended+flushed as the run progresses, retired by
#: the atomic trace.jsonl / metrics.json finalize) — what a kill -9'd
#: worker leaves for the fleet's artifact sync to mirror home
TRACE_JOURNAL_FILE = "trace.jsonl.journal"
METRICS_JOURNAL_FILE = "metrics.json.journal"

#: default telemetry journal flush interval, milliseconds (override
#: per test with ``test["telemetry-flush-ms"]``; planlint PL017
#: rejects non-positive values)
DEFAULT_TELEMETRY_FLUSH_MS = 500.0

#: directory under base_dir holding campaign state
#: (``store/campaigns/<campaign-id>/campaign.json`` + ``cells.jsonl``
#: + ``report.json``, written by jepsen_tpu_torch.campaign.journal); the
#: name is reserved -- test_names() skips it
CAMPAIGNS_DIR = "campaigns"

#: directory under base_dir holding the disk-persistent compile ledger
#: (``store/compile_ledger/ledger.jsonl``, written by
#: the JAX package's fleet.ledger); reserved -- test_names() skips it
COMPILE_LEDGER_DIR = "compile_ledger"

#: directory under base_dir where fleet artifact sync stages
#: downloads before their atomic rename into place
#: (jepsen_tpu.fleet.sync); reserved -- test_names() skips it, and
#: anything inside is by definition an unpublished partial copy
SYNC_TMP_DIR = ".sync-tmp"

TIME_FORMAT = "%Y%m%dT%H%M%S.%f%z"


def local_time(t=None):
    """A start-time string: basic-date-time, local zone (util/local-time)."""
    t = t or datetime.datetime.now().astimezone()
    return t.strftime(TIME_FORMAT)


def nonserializable_keys(test):
    """Default nonserializable keys plus the test's own
    (store.clj:164-168)."""
    return DEFAULT_NONSERIALIZABLE_KEYS | set(
        test.get("nonserializable-keys", ()))


def path(test, *args):
    """The directory for a test's results, or a file inside it. Nested
    list path components are flattened; Nones are dropped
    (store.clj:118-139)."""
    assert test.get("name"), "test needs a :name to have a store directory"
    assert test.get("start-time"), "test needs a :start-time"
    t = test["start-time"]
    if not isinstance(t, str):
        t = local_time(t)

    def flatten(xs):
        for x in xs:
            if x is None:
                continue
            if isinstance(x, (list, tuple)):
                yield from flatten(x)
            else:
                yield str(x)

    return os.path.join(base_dir, str(test["name"]), t, *flatten(args))


def make_path(test, *args):
    """Like path, but ensures the containing directory exists
    (store.clj:142-147)."""
    p = path(test, *args)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    return p


class _Encoder(json.JSONEncoder):
    """Permissive JSON encoder: sets become sorted lists, datetimes
    ISO-format, everything else falls back to repr (the analogue of the
    reference's custom fressian handlers, store.clj:31-116)."""

    def default(self, o):
        if isinstance(o, (set, frozenset)):
            try:
                return sorted(o)
            except TypeError:
                return sorted(o, key=repr)
        if isinstance(o, (datetime.datetime, datetime.date)):
            return o.isoformat()
        if isinstance(o, bytes):
            return o.decode("utf-8", errors="replace")
        if isinstance(o, pathlib.PurePath):
            return str(o)
        try:
            import numpy as np
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, np.generic):
                # every numpy scalar -- int, float, AND bool_ (which
                # repr'd as "True" strings before and broke metrics
                # snapshots round-tripping through JSON)
                return o.item()
        except ImportError:  # pragma: no cover
            pass
        return repr(o)


def _dump_json(data, p):
    # fsync BEFORE the rename: os.replace is atomic in the namespace
    # but says nothing about the data blocks. A kill -9 (or power cut)
    # between write and rename used to be able to publish a
    # stale-but-valid file whose bytes never reached disk -- for
    # campaign.json that meant a meta silently disagreeing with the
    # fsync'd journal tail it claims to summarize.
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, cls=_Encoder)
        f.write("\n")
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:  # pragma: no cover - exotic fs
            pass
    os.replace(tmp, p)


def serializable_test(test):
    return {k: v for k, v in test.items()
            if k not in nonserializable_keys(test)}


def write_results(test):
    """Writes results.json (store.clj:354-358 results.edn)."""
    _dump_json(test.get("results"), make_path(test, "results.json"))


def write_history(test):
    """Writes history.txt (human) and history.jsonl (machine)
    (store.clj:360-371). history.jsonl lands via atomic rename, and a
    successful write retires the incremental journal (the journal is
    crash insurance; once the real file exists it is strictly
    better)."""
    hist = test.get("history") or []
    with open(make_path(test, "history.txt"), "w") as f:
        for op in hist:
            f.write(op_str(op) + "\n")
    p = make_path(test, "history.jsonl")
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        for op in hist:
            f.write(json.dumps(op, cls=_Encoder) + "\n")
    os.replace(tmp, p)
    journal = test.get("journal")
    if journal is not None:
        journal.close()
    try:
        os.remove(path(test, JOURNAL_FILE))
    except OSError:
        pass


class HistoryJournal:
    """Crash-only incremental history: every op is appended (one JSON
    line) and flushed as it lands in the interpreter's history, so a
    SIGKILL'd run still leaves ``history.jsonl.journal`` on disk with
    everything up to the kill. ``write_history`` finalizes: once the
    atomic ``history.jsonl`` exists the journal is deleted.
    ``load_history`` falls back to the journal when only it survives.

    Appends happen on the interpreter's event-loop thread only; close
    is idempotent and append-after-close is a silent no-op (abort
    paths race teardown)."""

    def __init__(self, journal_path):
        self.path = journal_path
        self._f = open(journal_path, "a")

    def append(self, op):
        f = self._f
        if f is None:
            return
        try:
            f.write(json.dumps(op, cls=_Encoder) + "\n")
            f.flush()
        except (OSError, ValueError):  # disk full / closed underfoot
            logger.warning("history journal append failed",
                           exc_info=True)
            self._f = None

    def close(self):
        f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:  # pragma: no cover
                pass


def open_journal(test):
    """An appendable HistoryJournal in the test's store directory
    (core.run parks it on ``test["journal"]`` for the interpreter)."""
    return HistoryJournal(make_path(test, JOURNAL_FILE))


def write_test(test):
    """Writes the serializable test map as test.json (the fressian
    analogue, store.clj:382-386)."""
    t = dict(serializable_test(test))
    t.pop("history", None)   # stored separately as history.jsonl
    t.pop("results", None)   # stored separately as results.json
    t.pop("analysis", None)  # stored separately as analysis.json
    t.pop("monitor-verdict", None)  # stored separately as monitor.json
    _dump_json(t, make_path(test, "test.json"))


def update_symlink(test, dest_parts):
    """Symlink base_dir/<dest_parts> -> the test directory
    (store.clj:316-327)."""
    src = path(test)
    if not os.path.exists(src):
        return
    dest = os.path.join(base_dir, *dest_parts)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    try:
        if os.path.islink(dest) or os.path.exists(dest):
            os.remove(dest)
        os.symlink(os.path.relpath(src, os.path.dirname(dest)), dest)
    except OSError as e:  # pragma: no cover - symlink-less filesystems
        logger.warning("couldn't update symlink %s: %s", dest, e)


def update_current_symlink(test):
    update_symlink(test, ["current"])


def update_symlinks(test):
    """current, latest, and <name>/latest (store.clj:335-343)."""
    for dest in (["current"], ["latest"], [str(test["name"]), "latest"]):
        update_symlink(test, dest)


def telemetry_flush_s(test):
    """The telemetry journal flush interval in seconds, from
    ``test["telemetry-flush-ms"]`` (default 500 ms; invalid values
    fall back to the default — planlint PL017 flags them ahead of
    time)."""
    ms = test.get("telemetry-flush-ms", DEFAULT_TELEMETRY_FLUSH_MS)
    try:
        ms = float(ms)
    except (TypeError, ValueError):
        ms = DEFAULT_TELEMETRY_FLUSH_MS
    if ms <= 0 or isinstance(test.get("telemetry-flush-ms"), bool):
        ms = DEFAULT_TELEMETRY_FLUSH_MS
    return ms / 1000.0


def open_obs_journals(test):
    """Attach the incremental telemetry journals (trace.jsonl.journal
    + metrics.json.journal in the run directory) to the run's bound
    tracer/registry, so a kill -9 mid-run still leaves readable
    telemetry — the HistoryJournal discipline applied to obs. No-op
    for unnamed or obs-off tests; failures are contained (journals
    are crash insurance, never load-bearing)."""
    o = test.get("obs") or {}
    tracer = o.get("tracer")
    registry = o.get("registry")
    flush_s = telemetry_flush_s(test)
    try:
        if tracer is not None:
            tracer.attach_journal(make_path(test, TRACE_JOURNAL_FILE),
                                  flush_s=flush_s)
        if registry is not None:
            registry.attach_journal(
                make_path(test, METRICS_JOURNAL_FILE), flush_s=flush_s)
    except Exception:  # noqa: BLE001
        logger.warning("couldn't attach telemetry journals",
                       exc_info=True)


def write_obs(test, final=False):
    """Writes the observability artifacts next to results.json:
    ``trace.jsonl`` (Chrome-trace/Perfetto span stream) and
    ``metrics.json`` (the registry snapshot). The handles live under
    test["obs"] (set by obs.run_scope; nonserializable).

    ``final=True`` (core.run's last write, after the root span closed)
    additionally retires the incremental telemetry journals: the
    atomic artifacts now strictly supersede them. The save_1/save_2
    writes keep journaling — the run is still emitting events, and a
    kill between save_1 and finalize must not lose them.

    While an incremental journal is attached, the non-final calls skip
    the full atomic dump: the journal on disk is strictly fresher than
    any mid-run snapshot could be, and re-serializing the whole event
    buffer at save_1/save_2 costs real wall clock on large traces. A
    journal-less run (attach failed, or a caller never opened one)
    keeps the old dump-at-every-save behavior as its only crash
    insurance.

    Failures are logged, never raised: telemetry is a byproduct, and a
    disk-full trace dump inside save_1 must not abort the run before
    analysis writes results.json."""
    o = test.get("obs") or {}
    tracer = o.get("tracer")
    registry = o.get("registry")
    try:
        if tracer is not None:
            if final or not tracer.journaling():
                tracer.dump(make_path(test, "trace.jsonl"))
            if final:
                tracer.close_journal(remove=True)
        if registry is not None:
            if final or not registry.journaling():
                _dump_json(registry.snapshot(),
                           make_path(test, "metrics.json"))
            if final:
                registry.close_journal(remove=True)
    except Exception:  # noqa: BLE001
        logger.warning("couldn't write obs artifacts", exc_info=True)


def write_monitor(test):
    """Writes monitor.json -- the streaming monitor's verdict block
    (verdict, detection index, detection latency, chunk/check counts)
    next to results.json. No file for unmonitored runs."""
    mv = test.get("monitor-verdict")
    if mv:
        _dump_json(mv, make_path(test, "monitor.json"))


def write_analysis(test):
    """Writes analysis.json: the static-diagnostic reports accumulated
    on the test map (planlint preflight, histlint) -- see
    jepsen_tpu.analysis. No file is written for tests that never ran an
    analyzer."""
    report = test.get("analysis")
    if report:
        _dump_json(report, make_path(test, "analysis.json"))


def write_certificate(test):
    """Writes certificate.json: the proof-carrying verdict the
    certifier built (witness, checks, VC diagnostics, re-certification
    context) -- see jepsen_tpu.analysis.certify. Byte-deterministic:
    same run artifacts, same bytes. No file for uncertified runs."""
    cert = test.get("certificate")
    if cert:
        _dump_json(cert, make_path(test, "certificate.json"))


def save_1(test):
    """Phase 1: history + test map, right after the run and before analysis
    (store.clj:388-399). Returns test."""
    write_history(test)
    write_test(test)
    write_obs(test)
    write_analysis(test)
    write_monitor(test)
    update_symlinks(test)
    return test


def save_2(test):
    """Phase 2: after computing results, re-write everything plus
    results.json (store.clj:401-413). Returns test.

    Deliberately no write_obs here: save_1 already wrote the
    crash-insurance copy, and core.run re-dumps the final artifacts
    once the root span closes moments after save_2 — serializing a
    potentially huge event buffer twice back-to-back buys nothing."""
    write_results(test)
    write_history(test)
    write_test(test)
    write_analysis(test)   # histlint findings exist only after analyze
    write_monitor(test)
    write_certificate(test)  # certify findings too (checker hook)
    update_symlinks(test)
    return test


# ---------------------------------------------------------------------------
# loading

def load(test_name, test_time):
    """Loads a stored test by name and time: the test map with its history
    re-attached, for offline re-analysis (store.clj:193-197)."""
    test = {"name": test_name, "start-time": test_time}
    with open(path(test, "test.json")) as f:
        out = json.load(f)
    out["history"] = load_history(test)
    try:
        out["results"] = load_results(test_name, test_time)
    except FileNotFoundError:
        pass
    return out


def load_history(test):
    """Loads history.jsonl; falls back to the incremental journal when
    only it survived (SIGKILL before finalize). A torn final journal
    line (killed mid-append) is dropped rather than fatal."""
    for name, salvaging in (("history.jsonl", False),
                            (JOURNAL_FILE, True)):
        hist = []
        try:
            with open(path(test, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        hist.append(h.Op(json.loads(line)))
                    except ValueError:
                        if salvaging:
                            logger.warning(
                                "dropping torn journal line in %s", name)
                            continue
                        raise
            return hist
        except FileNotFoundError:
            continue
    return []


def load_results(test_name, test_time):
    """Loads the results map (store.clj:241-248)."""
    with open(path({"name": test_name, "start-time": test_time},
                   "results.json")) as f:
        return json.load(f)


def load_run_trace(run_dir):
    """A run directory's trace events: ``trace.jsonl``, falling back
    to the incremental ``trace.jsonl.journal`` when only it survived
    (a kill -9 before finalize — exactly the run whose trace matters).
    Returns [] when neither exists."""
    from .obs import load_trace
    for name in ("trace.jsonl", TRACE_JOURNAL_FILE):
        p = os.path.join(str(run_dir), name)
        if os.path.exists(p):
            return load_trace(p)
    return []


def load_run_metrics(run_dir):
    """A run directory's metrics snapshot: ``metrics.json``, falling
    back to the journal's last parseable snapshot line. None when
    neither exists."""
    p = os.path.join(str(run_dir), "metrics.json")
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    from .obs import load_metrics_journal
    return load_metrics_journal(
        os.path.join(str(run_dir), METRICS_JOURNAL_FILE))


_results_cache = {}
_results_cache_lock = threading.Lock()


def memoized_load_results(test_name, test_time):
    """Cached load_results -- web handler threads hit this
    concurrently, so the cache dict is locked (the disk read itself
    runs outside the lock; a race loads twice, one result wins)."""
    key = (test_name, test_time)
    with _results_cache_lock:
        if key in _results_cache:
            return _results_cache[key]
    results = load_results(test_name, test_time)
    with _results_cache_lock:
        _results_cache.setdefault(key, results)
        return _results_cache[key]


# ---------------------------------------------------------------------------
# campaigns (jepsen_tpu_torch.campaign)

def campaign_path(campaign_id, *args):
    """A campaign's directory (or a file inside it):
    ``base_dir/campaigns/<id>/...``."""
    assert campaign_id, "campaign needs an id"
    return os.path.join(base_dir, CAMPAIGNS_DIR, str(campaign_id),
                        *map(str, args))


def compile_ledger_path(*args):
    """The disk-persistent compile ledger's directory (or a file inside
    it): ``base_dir/compile_ledger/...`` (the JAX package's fleet.ledger)."""
    return os.path.join(base_dir, COMPILE_LEDGER_DIR, *map(str, args))


def sync_tmp_path(*args):
    """The artifact-sync staging area (or a path inside it):
    ``base_dir/.sync-tmp/...`` (jepsen_tpu.fleet.sync). Same
    filesystem as the runs it stages for, so the publishing rename is
    atomic."""
    return os.path.join(os.path.abspath(base_dir), SYNC_TMP_DIR,
                        *map(str, args))


def campaigns():
    """All campaign ids in the store (those with a campaign.json)."""
    root = os.path.join(base_dir, CAMPAIGNS_DIR)
    try:
        return sorted(
            d for d in os.listdir(root)
            if os.path.isfile(os.path.join(root, d, "campaign.json")))
    except FileNotFoundError:
        return []


def latest_campaign():
    """The most recently updated campaign id, or None. "Updated" is
    campaign.json's mtime: write_meta rewrites it at start, resume,
    and finalize."""
    best, best_t = None, None
    for cid in campaigns():
        try:
            t = os.path.getmtime(campaign_path(cid, "campaign.json"))
        except OSError:  # pragma: no cover - raced deletion
            continue
        if best_t is None or t > best_t:
            best, best_t = cid, t
    return best


def load_campaign(campaign_id):
    """A campaign's state: campaign.json plus the cell records
    (cells.jsonl, torn last line dropped) and report.json when
    present. Returns None for an unknown campaign."""
    try:
        with open(campaign_path(campaign_id, "campaign.json")) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return None
    out = {"meta": meta, "records": load_campaign_records(campaign_id)}
    try:
        with open(campaign_path(campaign_id, "report.json")) as f:
            out["report"] = json.load(f)
    except FileNotFoundError:
        pass
    return out


def latest_campaign_records(campaign_id, records=None):
    """One record per cell, latest wins -- THE fold every consumer of
    the journal must agree on (resume skipping, the final report, the
    web view): a resumed campaign's journal keeps superseded records
    (e.g. an "aborted" row under the re-run's terminal row).

    Event records (``"event"`` key: fleet lease bookkeeping appended by
    jepsen_tpu.fleet.dispatch) are NOT outcomes and never participate
    in this fold -- a lease line after a terminal record must not
    resurrect the cell, and a lease with no terminal record must not
    read as completed. ``campaign_events`` reads them instead.

    ``records`` takes pre-parsed journal records so callers that need
    BOTH folds (fleetlint, the campaign report) read and torn-tail-skip
    ``cells.jsonl`` exactly once -- ``load_campaign_records`` is the
    only place that ever touches the file."""
    if records is None:
        records = load_campaign_records(campaign_id)
    return fold_latest_records(records)


def fold_latest_records(records):
    """The latest-per-cell outcome fold over pre-parsed records (the
    pure half of ``latest_campaign_records``)."""
    latest = {}
    for rec in records:
        if rec.get("event"):
            continue
        latest[rec.get("cell")] = rec
    return list(latest.values())


def campaign_events(campaign_id, records=None):
    """The journal's event records (lease grants/failures appended by
    the fleet dispatcher), append order. ``records`` takes pre-parsed
    journal records (see ``latest_campaign_records``)."""
    if records is None:
        records = load_campaign_records(campaign_id)
    return fold_event_records(records)


def fold_event_records(records):
    """The event-record filter over pre-parsed records (the pure half
    of ``campaign_events``)."""
    return [rec for rec in records if rec.get("event")]


def load_campaign_records(campaign_id):
    """The per-cell outcome records of a campaign, append order.
    Unparseable lines are skipped with a warning, wherever they sit: a
    process killed mid-append leaves a torn FINAL line, and a later
    resume terminates that fragment in place (journal.append_cell), so
    after a crash+resume the fragment is an interior line -- the
    journal is crash-only and every surviving record still counts."""
    out = []
    try:
        with open(campaign_path(campaign_id, "cells.jsonl")) as f:
            lines = f.readlines()
    except FileNotFoundError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            logger.warning("skipping torn campaign journal line "
                           "for %s", campaign_id)
    return out


# ---------------------------------------------------------------------------
# browsing

def test_names():
    """All test names in the store (store.clj:274-282)."""
    try:
        return sorted(
            d for d in os.listdir(base_dir)
            if os.path.isdir(os.path.join(base_dir, d))
            and not os.path.islink(os.path.join(base_dir, d))
            and d not in ("latest", "current", CAMPAIGNS_DIR,
                          COMPILE_LEDGER_DIR, SYNC_TMP_DIR))
    except FileNotFoundError:
        return []


def tests(test_name=None):
    """{name: {time: loader}} or {time: loader} for one name
    (store.clj:284-303). Loaders are zero-arg callables."""
    if test_name is None:
        return {n: tests(n) for n in test_names()}
    d = os.path.join(base_dir, str(test_name))
    out = {}
    try:
        entries = os.listdir(d)
    except FileNotFoundError:
        return out
    for t in sorted(entries):
        full = os.path.join(d, t)
        if os.path.isdir(full) and not os.path.islink(full) \
                and t != "latest":
            out[t] = (lambda n=test_name, tt=t: load(n, tt))
    return out


def latest():
    """Loads the latest test (store.clj:305-314)."""
    link = os.path.join(base_dir, "latest")
    if not os.path.exists(link):
        return None
    target = os.path.realpath(link)
    time_part = os.path.basename(target)
    name_part = os.path.basename(os.path.dirname(target))
    return load(name_part, time_part)


def delete(test_name=None, test_time=None):
    """Deletes all tests, one name, or one run (store.clj:470-478)."""
    if test_name is None:
        shutil.rmtree(base_dir, ignore_errors=True)
    elif test_time is None:
        shutil.rmtree(os.path.join(base_dir, str(test_name)),
                      ignore_errors=True)
    else:
        shutil.rmtree(path({"name": test_name, "start-time": test_time}),
                      ignore_errors=True)


# ---------------------------------------------------------------------------
# per-test logging (store.clj:415-460)

#: active per-test log handlers, in start order. A STACK, not a single
#: slot: campaign cells overlap core.runs, and the old
#: stop-previous-on-start behavior severed a still-running sibling's
#: jepsen.log. All attached handlers receive all records (process-wide
#: root logger), so parallel cells interleave lines but every cell's
#: file is complete.
_log_handlers = []
_log_lock = threading.RLock()

LOG_PATTERN = "%(asctime)s\t%(levelname)s\t[%(threadName)s] %(name)s: " \
              "%(message)s"


class _JsonFormatter(logging.Formatter):
    def format(self, record):
        return json.dumps({
            "timestamp": self.formatTime(record),
            "level": record.levelname,
            "thread": record.threadName,
            "logger": record.name,
            "message": record.getMessage(),
        })


def start_logging(test):
    """Starts logging to jepsen.log in the test's directory; updates the
    current symlink (store.clj:431-452). :logging-json? selects JSON
    structured logs. Returns the handler: overlapping runs (campaign
    cells) pass it back to ``stop_logging`` so each run detaches its
    OWN file, in any completion order."""
    with _log_lock:
        handler = logging.FileHandler(make_path(test, "jepsen.log"))
        if test.get("logging-json?"):
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(logging.Formatter(LOG_PATTERN))
        overrides = (test.get("logging") or {}).get("overrides", {})
        for pkg, level in overrides.items():
            logging.getLogger(pkg).setLevel(
                getattr(logging, str(level).upper(), logging.INFO))
        root = logging.getLogger()
        if root.level > logging.INFO or root.level == logging.NOTSET:
            root.setLevel(logging.INFO)
        root.addHandler(handler)
        _log_handlers.append(handler)
    update_current_symlink(test)
    return handler


def stop_logging(handler=None):
    """Removes a per-test log file handler (store.clj:453-460): the
    given one, or the most recently started (the single-run case)."""
    with _log_lock:
        if handler is None:
            handler = _log_handlers[-1] if _log_handlers else None
        if handler is None:
            return
        try:
            _log_handlers.remove(handler)
        except ValueError:      # already stopped: idempotent
            return
        logging.getLogger().removeHandler(handler)
        handler.close()
