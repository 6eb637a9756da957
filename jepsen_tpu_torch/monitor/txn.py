"""Streaming transactional (cycle-family) check core (the PyTorch port
of ``jepsen_tpu.monitor.txn.TxnCheck``).

A from-scratch transitive closure per chunk costs O(N^3 log N). Instead
``TxnCheck`` keeps the encoded adjacency matrix and its closure
*frontier* resident across chunks (``cycle.IncrementalClosure``, on the
card above the host threshold): folding a chunk of newly committed txns
in is one delta OR plus a couple of squaring passes back to fixpoint.

Verdict semantics are the offline check's on the same cut:

* a chunk with NO closed cycle in the frontier and NO inference-level
  anomaly is exactly what the offline ``cycle/`` check would call valid
  (every Adya class needs a cycle; the inference-level classes all land
  in ``infer``'s found map), so the check answers True without
  classifying;
* suspicion (a closed cycle, or any inference anomaly) defers to the
  full offline analysis (``engine.check_txn_prefix``), so False
  verdicts, witnesses and anomaly names are always the offline
  engine's;
* garbage reads alone are "unknown".

The first False flips the run's ChainedLatch (reason
``monitor-violation``) as the WGL monitor does: ``TxnMonitor`` wraps the
core in the WGL ``Monitor``'s threading contract, and ``install_txn``
wires it from ``test["monitor"]`` with ``family: "txn"``. As there, a
monitor that cannot be built raises, and an exception on its thread is
re-raised by ``stop``/``finalize``.
"""

from __future__ import annotations

import logging
import time as _time

from .. import obs
from .. import resolve_device
from .. import robust
from ..cycle import DEFAULT_ANOMALIES, IncrementalClosure
from . import engine as mengine
from .core import ABORT_REASON, DEFAULT_CHUNK, _MonitorThread

logger = logging.getLogger(__name__)

__all__ = ["TxnCheck", "TxnMonitor", "install_txn"]


class TxnCheck:
    """Synchronous chunk-check core: consume ops, maintain the
    incremental frontier on ``device`` (None: CUDA), answer
    offline-equivalent verdicts per chunk."""

    def __init__(self, workload="append", anomalies=None, realtime=True,
                 process=False, skew_bound=0, lo=64, device=None):
        if workload not in mengine.TXN_WORKLOADS:
            raise ValueError(f"unknown txn workload {workload!r}; "
                             f"expected one of {mengine.TXN_WORKLOADS}")
        self.workload = workload
        self.anomalies = tuple(anomalies or DEFAULT_ANOMALIES)
        self.realtime = bool(realtime)
        self.process = bool(process)
        self.skew_bound = int(skew_bound or 0)
        self.device = resolve_device(device)
        self.frontier = IncrementalClosure(lo=lo, device=self.device)
        self._hist = []
        self.n_txns = 0

    def _opts(self):
        return {"anomalies": self.anomalies, "realtime": self.realtime,
                "process": self.process, "skew-bound": self.skew_bound,
                "device": self.device}

    def offer(self, op):
        """Append one history event (invokes included: realtime edges
        need invocation times)."""
        self._hist.append(op)

    def _infer(self):
        from ..cycle import append as cycle_append
        from ..cycle import wr as cycle_wr
        if self.workload == "wr":
            return cycle_wr.infer(self._hist, self._opts())
        graph, found, oks = cycle_append.infer(
            self._hist, self.anomalies, self.realtime, self.process,
            self.skew_bound)
        return graph, found, oks, found.get("garbage-read") or []

    def check(self, cancel=None):
        """One chunk check over the consumed prefix. Returns the
        offline-shaped verdict dict for this cut."""
        graph, found, oks, garbage = self._infer()
        self.n_txns = len(oks)
        self.frontier.update(graph.adj > 0)
        suspicious = set(found) - {"garbage-read"}
        if suspicious or self.frontier.has_cycle():
            return mengine.check_txn_prefix(
                self._hist, self.workload, self._opts(), cancel=cancel)
        if garbage:
            return {"valid": "unknown", "anomaly_types": [],
                    "anomalies": {"garbage-read": garbage}}
        return {"valid": True, "anomaly_types": [], "anomalies": {}}

    @property
    def history(self):
        return self._hist


class TxnMonitor(_MonitorThread):
    """One run's streaming txn monitor: the WGL `Monitor`'s threading
    contract (O(1) offer on the event-loop thread, one daemon chunk
    thread, bounded idempotent stop) over a `TxnCheck` core whose
    closure lives on ``device`` (None: CUDA)."""

    family = "txn"
    #: finalize() parks evidence as dict(evidence, spec=mon.spec);
    #: the txn family has no WGL spec
    spec = None
    _thread_name = "jepsen txn monitor"

    def __init__(self, latch, chunk=DEFAULT_CHUNK, workload="append",
                 anomalies=None, realtime=True, process=False,
                 skew_bound=0, device=None):
        self.latch = latch
        self.chunk = max(1, int(chunk))
        self.core = TxnCheck(workload=workload, anomalies=anomalies,
                             realtime=realtime, process=process,
                             skew_bound=skew_bound, device=device)
        self.engine = f"txn-{workload}"
        self.violation = None
        self.evidence = None
        self._init_thread()
        self._last_verdict = True
        self.ops_consumed = 0
        self.chunks = 0
        self.checks = 0
        self.unknown_checks = 0
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
            verdict = self._last_verdict
        out = {
            "verdict": verdict,
            "family": "txn",
            "workload": self.core.workload,
            "engine": self.engine,
            "chunk": self.chunk,
            "ops_consumed": self.ops_consumed,
            "chunks": self.chunks,
            "checks": self.checks,
            "unknown_checks": self.unknown_checks,
            "txns": self.core.n_txns,
            "closure_rebuilds": self.core.frontier.rebuilds,
            "time_to_first_verdict_s": self._t_first_verdict,
        }
        if self.core.skew_bound:
            out["skew_bound"] = self.core.skew_bound
        if self.error is not None:
            out["error"] = repr(self.error)
        if self.violation is not None:
            out.update(self.violation)
        return out

    # -- monitor thread ----------------------------------------------------

    def _step(self):
        with self._cond:
            batch = list(self._queue)
            self._queue.clear()
            self._pending_completions = 0
        if not batch:
            return
        newest = 0.0
        for op, idx, t in batch:
            self.core.offer(op)
            self.ops_consumed += 1
            newest = max(newest, t)
        self._inc("monitor.ops_consumed", len(batch))
        self.chunks += 1
        self._inc("monitor.chunks")
        t0 = _time.monotonic()
        res = self.core.check(cancel=self._cancel)
        dt = _time.monotonic() - t0
        self.checks += 1
        valid = res.get("valid")
        self._inc("monitor.checks", valid=str(valid))
        if self._reg is not None:
            self._reg.observe("monitor.check_s", dt)
        if self._t_first_verdict is None and valid in (True, False):
            self._t_first_verdict = round(
                _time.monotonic() - self._t_start, 4)
            if self._reg is not None:
                self._reg.set_gauge("monitor.time_to_first_verdict_s",
                                    self._t_first_verdict)
        if valid == "unknown":
            self.unknown_checks += 1
            if self._last_verdict is not False:
                self._last_verdict = "unknown"
            return
        self._last_verdict = valid
        if valid is False and self.violation is None:
            latency = max(0.0, _time.monotonic() - newest)
            self.violation = {
                "detected_at_index": self._n_seen - 1,
                "detection_latency_s": round(latency, 4),
                "checked_ops": len(self.core.history),
                "anomaly_types": list(res.get("anomaly_types") or ()),
            }
            self.evidence = {
                "family": "txn",
                "workload": self.core.workload,
                "opts": self.core._opts(),
                "history": list(self.core.history),
                "result": res,
            }
            self._inc("monitor.violations")
            if self._reg is not None:
                self._reg.set_gauge(
                    "monitor.detection_latency_s",
                    self.violation["detection_latency_s"])
            if self._tr is not None:
                self._tr.instant("monitor.violation", cat="monitor",
                                 args=dict(self.violation))
            logger.warning(
                "MONITOR: txn anomaly %s detected at history index %d "
                "(%.3fs after the op landed); aborting run",
                ",".join(self.violation["anomaly_types"]) or "?",
                self._n_seen - 1, latency)
            self.latch.set(ABORT_REASON)


def install_txn(test, cfg):
    """Wire a TxnMonitor from a normalized monitor config with
    ``family: "txn"`` (core.install dispatches here). Chains the run's
    abort latch and subscribes to the op-sink list exactly like the WGL
    path; the closure runs on ``cfg["engine-opts"]["device"]`` (None:
    CUDA). Returns the started monitor; a monitor that cannot be built
    raises."""
    latch = robust.ChainedLatch(test.get("abort"))
    mon = TxnMonitor(
        latch=latch,
        chunk=cfg.get("chunk") or DEFAULT_CHUNK,
        workload=cfg.get("workload", "append"),
        anomalies=cfg.get("anomalies"),
        realtime=cfg.get("realtime", True),
        process=cfg.get("process", False),
        skew_bound=cfg.get("skew-bound", cfg.get("skew_bound", 0)),
        device=(cfg.get("engine-opts") or {}).get("device"))
    test["abort"] = latch
    test.setdefault("op-sinks", []).append(mon.offer)
    obs.inc("monitor.installed", engine=mon.engine)
    return mon.start()
