"""Per-dispatch phase attribution for the device WGL host loops (the
port's copy of ``jepsen_tpu/obs/phases.py``).

``wgl.device_busy_s`` alone brackets a whole dispatch chunk, so
transfer, compile and host expansion hide inside the "busy" number.
This module splits every device dispatch of the single-key loop
(``checker/torch_wgl.py``) and the key batch (``parallel/keyshard.py``)
into named phase spans:

========  ===========================================================
phase     covers
========  ===========================================================
encode    history -> op-table encoding, fast paths, pruning
plan      bucket/size planning, search build
h2d       host->device transfer of op columns and the initial carry
compile   the first device dispatch after the rollout kernel's
          library was built or loaded in this process during this
          search (its wall is nvcc's and the loader's, not stepping),
          and a dispatch that captured the search's CUDA graph
          (``checker/chunk_graph.py``), as the reference's dispatch
          that compiles its shape
device    the device bracket proper: dispatch -> a synchronize of
          the carry's stream. On the card the chunk is graph replays,
          one launch an iteration; the eager loop (the CPU, the mesh
          search) launches several hundred small kernels from Python
          per iteration
d2h       the batched progress read + final harvest reads
host      everything else on the host between dispatches: heartbeat
          bookkeeping, quantum adaptation, expansion/dedup of
          results, batch compaction rebuilds, verdict interpretation
wait      slot/queue wait -- emitted via `note_wait`
========  ===========================================================

Each lap lands twice: a ``cat="phase"`` complete span on the trace
(``wgl.phase.<name>``, so a trace reader can walk a lane and classify
every idle gap) and a ``wgl.phase_s{phase,engine}`` counter in the
registry (so the campaign fold and ``/api/metrics`` carry the same
breakdown without a trace in hand).

The session is a CURSOR, not a stack: ``lap(name)`` attributes all
wall since the previous lap/mark to ``name`` and advances the cursor,
so consecutive spans are exactly contiguous and non-overlapping by
construction — the invariant a >=95% attribution target per search
rests on. The cursor lives in ``monotonic_ns`` and is mapped
onto the tracer's clock through one constant offset captured at
session start, so contiguity survives the conversion exactly.

Cost discipline: when obs is unbound (or the run sets ``phases?:
false``) a session is two ``monotonic_ns`` reads per lap and the
engines skip the extra device synchronize entirely — the dispatch
loops' own status reads stay their only syncs.
"""

from __future__ import annotations

import time as _time

from . import current_sinks, run_config

__all__ = ["PHASES", "CAT", "METRIC", "capture", "note_wait",
           "PhaseSession"]

#: the closed phase vocabulary
PHASES = ("encode", "plan", "h2d", "compile", "device", "d2h", "host",
          "wait")

#: trace category of every phase span (a trace reader's filter)
CAT = "phase"

#: registry counter: seconds per {phase, engine}
METRIC = "wgl.phase_s"


def capture(engine):
    """Snapshot this context's sinks into a phase session for one
    search. Honors the run's ``phases?`` knob (default on whenever obs
    is bound): a disabled session measures nothing extra and emits
    nothing."""
    tr, reg = current_sinks()
    if run_config().get("phases?") is False:
        tr = reg = None
    return PhaseSession(engine, tr, reg)


def note_wait(engine, wait_s, **args):
    """Emit ONE slot/queue-wait span ending now against the caller's
    current sinks: the coalescer's enqueue->dispatch latency, the
    monitor's device-semaphore wait. These phases are measured by
    their owners (the wait brackets code outside any engine's
    session), so they enter the attribution plane through this module
    function instead of a session lap."""
    tr, reg = current_sinks()
    if run_config().get("phases?") is False:
        return
    try:
        wait_s = max(0.0, float(wait_s))
    except (TypeError, ValueError):
        return
    if reg is not None:
        reg.inc(METRIC, wait_s, phase="wait", engine=engine)
    if tr is not None:
        dur_ns = int(wait_s * 1e9)
        tr.complete("wgl.phase.wait", max(0, tr.now_ns() - dur_ns),
                    dur_ns, cat=CAT,
                    args={"engine": engine, **args})


class PhaseSession:
    """One search's phase cursor (see module docstring).

    ``totals`` accumulates seconds per phase for the session —
    engines fold it into their result diagnostics and tests pin the
    contiguity invariants against it."""

    def __init__(self, engine, tr, reg):
        self.engine = engine
        self._tr = tr
        self._reg = reg
        self.enabled = tr is not None or reg is not None
        self._cursor = _time.monotonic_ns()
        # constant monotonic->tracer clock offset: applied to every
        # span start so consecutive laps stay EXACTLY contiguous
        self._off = (tr.now_ns() - _time.monotonic_ns()) \
            if tr is not None else 0
        self._compile_pending = False
        self.totals = {}

    def note_compile(self, miss):
        """Arm the compile phase: the NEXT device lap is attributed to
        ``compile`` instead (the search's kernel library was not yet
        loaded in this process, or the dispatch captured the search's
        graph, so that dispatch's wall is the build's, the loader's or
        the capture's, not stepping). Hits arm nothing."""
        if miss:
            self._compile_pending = True

    def mark(self):
        """Reset the cursor to now, dropping the wall since the last
        lap from attribution (used only at session start)."""
        self._cursor = _time.monotonic_ns()

    def lap(self, phase, **args):
        """Attribute all wall since the previous lap/mark to ``phase``
        and advance the cursor. Returns the lap's seconds (measured
        even when disabled, so callers can reuse the number)."""
        now = _time.monotonic_ns()
        d_ns = now - self._cursor
        ts_ns = self._cursor + self._off
        self._cursor = now
        if d_ns < 0:
            return 0.0
        dt = d_ns / 1e9
        if not self.enabled:
            return dt
        if phase == "device" and self._compile_pending:
            phase = "compile"
            self._compile_pending = False
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        if self._reg is not None:
            self._reg.inc(METRIC, dt, phase=phase, engine=self.engine)
        if self._tr is not None:
            self._tr.complete(f"wgl.phase.{phase}", ts_ns, d_ns,
                              cat=CAT,
                              args={"engine": self.engine, **args})
        return dt

    def sync(self, *tensors):
        """Synchronize the current stream of each CUDA device the given
        tensors (or tuples of tensors, such as a search carry) live on,
        where the search's work runs -- but ONLY when the session is
        enabled: with phases off the dispatch loop keeps its original
        async shape (the status read remains the only sync) and pays
        nothing. CPU tensors need no synchronize. A stream, not the
        device: a device-wide synchronize fails while another thread
        captures a search graph."""
        if not self.enabled:
            return
        devices = set()
        stack = list(tensors)
        while stack:
            t = stack.pop()
            if isinstance(t, (tuple, list)):
                stack.extend(t)
            elif getattr(t, "is_cuda", False):
                devices.add(t.device)
        if devices:
            import torch
            for d in devices:
                torch.cuda.current_stream(d).synchronize()
