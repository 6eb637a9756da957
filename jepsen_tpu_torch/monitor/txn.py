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

The monitor thread around it (``TxnMonitor``, ``install_txn``) comes
with the host harness (ROADMAP.md queue A.11).
"""

from __future__ import annotations

from .. import resolve_device
from ..cycle import DEFAULT_ANOMALIES, IncrementalClosure
from . import engine as mengine

__all__ = ["TxnCheck"]


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
