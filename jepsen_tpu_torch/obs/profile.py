"""Opt-in ``torch.profiler`` capture around a run's device searches (the
port's copy of ``jepsen_tpu/obs/profile.py``, with ``torch.profiler`` in
place of ``jax.profiler``).

The telemetry plane says WHAT the search did (heartbeats, padding
accounting, duty cycle); the profiler says WHY a launch cost what it
did — per-kernel device timelines beside the host ops that issued them.
``--profile`` (``test["profile?"]``) wraps the analyze phase — the run's
device searches — in a ``torch.profiler`` capture persisted NEXT TO
``trace.jsonl``:

* **Layout.** Captures land in ``<run dir>/profile/`` (or an explicit
  ``test["profile-dir"]``) as one Chrome trace, ``TRACE_FILE``. The
  CPU activity is always on; the CUDA activity is on when the run's
  device (``test["device"]``, None: CUDA) is a card and one is present.
  A ``profile.json`` marker beside ``trace.jsonl`` records the
  capture's status and names the trace file.
* **Bounded.** ``test["profile-max-s"]`` (default 120 s) arms a timer
  that marks the capture expired: an unbounded profile of a stuck
  multi-hour search would fill the disk the run's own artifacts need.
  ``torch.profiler`` can only be stopped from the thread that started
  it (a stop from the timer thread finds no session and leaves the
  profiler's state broken), so the bound takes effect at the next scope
  boundary: the capture stops when the body exits, and the exported
  trace keeps only the events that began within the bound — as the JAX
  package's takes effect at the next dispatch boundary, not mid-kernel.
  Profiling LARGE workloads (e.g. a keyed demo's hundreds of per-key
  checks) multiplies their wall; profile compact runs.
* **Crash-tolerant (journal discipline).** The marker is written
  ``status: "capturing"`` + flushed BEFORE the profiler starts and
  atomically rewritten at stop, so a kill -9 mid-capture leaves a
  readable marker naming the capture directory — the same
  append-then-finalize contract the trace/metrics journals follow.
* **Contained.** Every failure path — torch.profiler missing, an
  unwritable directory, a start/stop/export error, a second concurrent
  capture (the profiler is process-global) — degrades to a marker with
  the reason; the run itself NEVER fails because profiling could not.
  This hides no device: the searches run where they run, profiled or
  not.

``JEPSEN_NO_PROFILER=1`` forces `available()` False — how the
containment path is exercised deterministically.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time as _time

logger = logging.getLogger(__name__)

__all__ = ["available", "scope", "profile_dir_for", "MARKER_FILE",
           "PROFILE_DIR", "DEFAULT_MAX_S", "TRACE_FILE"]

#: subdirectory of the run dir the capture lands in
PROFILE_DIR = "profile"
#: the crash-tolerant status marker written next to trace.jsonl
MARKER_FILE = "profile.json"
#: the Chrome trace the capture exports, inside the profile directory
TRACE_FILE = "torch_trace.json"
#: capture wall bound: a wedged search must not grow the capture
#: forever (the exported trace ends at the bound and the run continues)
DEFAULT_MAX_S = 120.0

#: the profiler is process-global state; a second concurrent capture
#: (overlapping runs in one process) must refuse, not corrupt the first
_capture_lock = threading.Lock()
_capturing = False


def available():
    """Whether ``torch.profiler`` capture can run here. Env
    ``JEPSEN_NO_PROFILER=1`` forces False (containment)."""
    if os.environ.get("JEPSEN_NO_PROFILER"):
        return False
    try:
        from torch import profiler as _p
        return callable(getattr(_p, "profile", None))
    except Exception:  # noqa: BLE001 - no torch / broken install
        return False


def profile_dir_for(test):
    """Where this test's capture would land: the explicit
    ``profile-dir``, else ``<run dir>/profile`` for named tests, else
    None (nowhere to persist — planlint PL019 flags it ahead of
    time)."""
    d = test.get("profile-dir")
    if d:
        return str(d)
    if test.get("name"):
        from .. import store
        try:
            return store.path(test, PROFILE_DIR)
        except Exception:  # noqa: BLE001 - store layout problems
            return None
    return None


def _write_marker(path, payload):
    """Atomic marker write (tmp + rename), flushed to disk: the
    ``status: capturing`` line must survive a kill -9 an instant
    later."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _capture_files(pdir):
    n = 0
    for _root, _dirs, files in os.walk(pdir):
        n += len(files)
    return n


def _activities(test):
    """The CPU activity, plus CUDA when the run's device is a card and
    one is present."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    dev = test.get("device")
    on_card = dev is None or torch.device(dev).type == "cuda"
    if on_card and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trim(path, keep_s):
    """Drop the events of a Chrome trace that began more than ``keep_s``
    after its first one; returns how many were dropped."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents") or []
    ts = [e["ts"] for e in evs if isinstance(e.get("ts"), (int, float))]
    if not ts:
        return 0
    cut = min(ts) + keep_s * 1e6
    kept = [e for e in evs
            if not isinstance(e.get("ts"), (int, float)) or e["ts"] <= cut]
    dropped = len(evs) - len(kept)
    if dropped:
        doc["traceEvents"] = kept
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    return dropped


@contextlib.contextmanager
def scope(test):
    """Capture a ``torch.profiler`` trace around the body when
    ``test["profile?"]`` is set; a no-op context otherwise. Never
    raises — profiling is a byproduct, and the verdict must not
    depend on it."""
    global _capturing
    if not isinstance(test, dict) or not test.get("profile?"):
        yield None
        return
    pdir = profile_dir_for(test)
    marker = None
    state = {"status": "unavailable", "dir": pdir}
    if test.get("name"):
        # the marker belongs NEXT TO trace.jsonl whatever directory
        # the capture itself lands in (an explicit profile-dir may
        # point anywhere)
        try:
            from .. import store
            marker = store.path(test, MARKER_FILE)
        except Exception:  # noqa: BLE001 - store layout problems
            marker = None
    if marker is None and pdir is not None:
        marker = os.path.join(os.path.dirname(pdir) or ".",
                              MARKER_FILE)
    try:
        max_s = float(test.get("profile-max-s") or DEFAULT_MAX_S)
    except (TypeError, ValueError):
        max_s = DEFAULT_MAX_S
    prof = None
    timer = None
    expired = threading.Event()

    def _stop(reason):
        """Stop the capture on the thread that started it and export
        it; the events past an expired bound are dropped."""
        nonlocal prof
        global _capturing
        if prof is None:
            return
        p, prof = prof, None
        try:
            p.stop()
            path = os.path.join(pdir, TRACE_FILE)
            p.export_chrome_trace(path)
            state["trace"] = TRACE_FILE
            if expired.is_set():
                state["events_dropped"] = _trim(path, max_s)
            state["status"] = "done"
        except Exception as exc:  # noqa: BLE001 - contained
            state["status"] = "failed"
            state["error"] = repr(exc)[:300]
            logger.warning("profiler stop failed", exc_info=True)
        with _capture_lock:
            _capturing = False
        state["stopped_by"] = reason

    try:
        if pdir is None:
            state["error"] = ("no profile directory: name the test or "
                              "pass profile-dir")
        elif not available():
            state["error"] = "torch.profiler unavailable"
        else:
            claimed = False
            with _capture_lock:
                if _capturing:
                    state["status"] = "skipped"
                    state["error"] = ("another capture is already "
                                      "running (the profiler is "
                                      "process-global)")
                else:
                    _capturing = claimed = True
            if claimed:
                try:
                    os.makedirs(pdir, exist_ok=True)
                    acts = _activities(test)
                    state["activities"] = sorted(a.name for a in acts)
                    if marker:
                        _write_marker(marker, {
                            "status": "capturing", "dir": pdir,
                            "max_s": max_s,
                            "started": _time.strftime("%Y%m%dT%H%M%S")})
                    from torch import profiler as _p
                    p = _p.profile(activities=acts)
                    p.start()
                except BaseException:
                    with _capture_lock:
                        _capturing = False
                    raise
                prof = p
                state["status"] = "capturing"
                timer = threading.Timer(max_s, expired.set)
                timer.daemon = True
                timer.start()
    except Exception as exc:  # noqa: BLE001 - setup must not kill runs
        state["status"] = "failed"
        state["error"] = repr(exc)[:300]
        logger.warning("profiler setup failed", exc_info=True)
    t0 = _time.monotonic()
    try:
        yield pdir if prof is not None else None
    finally:
        if timer is not None:
            timer.cancel()
        _stop("max-s-bound" if expired.is_set() else "scope-exit")
        state["wall_s"] = round(_time.monotonic() - t0, 3)
        if state.get("status") == "done" and pdir is not None:
            try:
                state["files"] = _capture_files(pdir)
            except OSError:
                pass
        if marker:
            try:
                _write_marker(marker, state)
            except Exception:  # noqa: BLE001 - marker is best effort
                logger.warning("couldn't write the profile marker",
                               exc_info=True)
        if state.get("status") != "done":
            logger.warning("torch.profiler capture: %s (%s)",
                           state.get("status"), state.get("error"))
