"""Transactional workload suite: the list-append and rw-register
families as first-class, CLI-runnable tests (reference
jepsen/src/jepsen/tests/cycle/append.clj wired the way a consumer
database suite would: a workload registry + clients + nemesis axes).

Histories are transactions over ``jepsen_tpu_torch.txn`` micro-ops::

    {"f": "txn", "value": [["append", 3, 2], ["r", 3, None]]}   # append
    {"f": "txn", "value": [["w", 1, 7], ["r", 1, None]]}        # wr

checked by the ``jepsen_tpu_torch.cycle`` Adya engine and streamed through
the ``family="txn"`` monitor (monitor/txn.py): the first committed
cycle aborts the run while it is still going.

The backing store is an in-process shared map behind one lock
(serializable by construction), with injectable bugs so every anomaly
path is demonstrable end to end:

* ``--bug future-read``  -- every 5th read *predicts* the next append
  (G1c-realtime: the predicted value's eventual writer precedes the
  read in the dependency graph, realtime orders them the other way);
* ``--bug dirty-read``   -- reversed list reads (incompatible-order) /
  stale register reads.

Nemesis axes (``--nemesis none|faketime|charybdefs``) reuse the real
cluster tooling -- libfaketime clock skew via ``nemesis.time`` and
CharybdeFS EIO injection -- contained into info completions when the
control plane can't reach a real cluster, so the same campaign matrix
runs against the dummy rig and a docker/SSH fleet alike.

Clock-skew soaks make naive realtime-edge inference unsound: a worker
whose clock runs 30s behind "completes" ops long before other workers
invoke theirs. The suite's checker recovers the per-node offset bound
from the clock nemesis' ``check-offsets`` completions in the history
(``skew_bound_from_history``) and feeds it to the cycle engine, which
only infers an RT edge when the realtime gap exceeds the bound.

Run it yourself::

    python -m jepsen_tpu_torch.suites.txn test --node n1 --time-limit 8
    python -m jepsen_tpu_torch.suites.txn test --workload wr --monitor
    python -m jepsen_tpu_torch.suites.txn test --bug future-read \\
        --monitor --monitor-chunk 8    # must FAIL, mid-run

The port's copy of ``jepsen_tpu/suites/txn.py``: the cycle checkers'
closures and the txn monitor run on ``--device`` (default: CUDA).
"""

from __future__ import annotations

import threading

from .. import checker as cc
from .. import resolve_device
from .. import cli
from .. import client as jclient
from .. import db as jdb
from .. import generator as gen
from .. import os as jos
from ..checker import checkers as cks
from ..cycle import skew_bound_from_offsets
from ..demo import nemesis_axis
from ..tests.cycle import append as append_workload
from ..tests.cycle import wr as wr_workload


class TxnStore:
    """Shared serializable store: per-key lists (append family) and
    per-key (current, previous) registers (wr family)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lists = {}
        self.kv = {}

    def clear(self):
        with self.lock:
            self.lists.clear()
            self.kv.clear()


class TxnDB(jdb.DB):
    def __init__(self, store):
        self.store = store

    def setup(self, test, node):
        self.store.clear()

    def teardown(self, test, node):
        pass


class ListAppendClient(jclient.Client):
    """Executes append/r micro-ops against the shared store; see the
    module docstring for the injectable bugs."""

    def __init__(self, store, bug=None):
        self.store = store
        self.bug = bug
        self._n = 0

    def open(self, test, node):
        return ListAppendClient(self.store, self.bug)

    def invoke(self, test, op):
        out = dict(op)
        txn = []
        # keys this txn itself appends to: the future-read prediction
        # must stay CROSS-txn (predicting a value this same txn then
        # appends degrades the clean G1c-realtime signal into a
        # within-txn incompatible-order)
        own_appends = {k for f, k, _ in op["value"] if f == "append"}
        with self.store.lock:
            self._n += 1
            for f, k, v in op["value"]:
                if f == "append":
                    lst = self.store.lists.setdefault(k, [])
                    # store-assigned per-key values: generated values
                    # apply out of order under concurrency, so lists
                    # would carry gaps and the future-read prediction
                    # below would name a value whose append lands far
                    # from where the read put it (incompatible-order
                    # noise instead of the clean G1c signal)
                    v = lst[-1] + 1 if lst else 1
                    lst.append(v)
                    txn.append([f, k, v])
                else:
                    got = list(self.store.lists.get(k, []))
                    if self.bug == "dirty-read" and self._n % 7 == 0 \
                            and len(got) >= 2:
                        got = got[::-1]
                    elif self.bug == "future-read" \
                            and self._n % 5 == 0 and got \
                            and k not in own_appends:
                        got = got + [max(got) + 1]
                    txn.append([f, k, got])
        out.update(type="ok", value=txn)
        return out


class RwRegisterClient(jclient.Client):
    """Executes w/r micro-ops; dirty-read serves every 7th read from
    the key's previous version."""

    def __init__(self, store, bug=None):
        self.store = store
        self.bug = bug
        self._n = 0

    def open(self, test, node):
        return RwRegisterClient(self.store, self.bug)

    def invoke(self, test, op):
        out = dict(op)
        txn = []
        with self.store.lock:
            self._n += 1
            for f, k, v in op["value"]:
                if f == "w":
                    prev = self.store.kv.get(k, (None, None))[0]
                    self.store.kv[k] = (v, prev)
                    txn.append([f, k, v])
                else:
                    cur, prev = self.store.kv.get(k, (None, None))
                    got = cur
                    if self.bug in ("dirty-read", "stale-read") \
                            and self._n % 7 == 0 and prev is not None:
                        got = prev
                    txn.append([f, k, got])
        out.update(type="ok", value=txn)
        return out


def skew_bound_from_history(history, scale=1e9):
    """Recover a realtime-skew bound (history time units; ns by
    default) from clock-nemesis completions: every ``clock_offsets``
    map in the history contributes its per-node offsets (seconds) to
    one max-min envelope."""
    offsets = []
    for op in history or ():
        co = op.get("clock_offsets") if isinstance(op, dict) else None
        if isinstance(co, dict):
            offsets.extend(float(v) for v in co.values()
                           if isinstance(v, (int, float)))
    if not offsets:
        return 0
    return int(skew_bound_from_offsets(offsets, scale))


def _checker(workload_mod, opts):
    """The workload's cycle checker, made skew-aware: the realtime
    bound is recovered from the history THIS run produced (an explicit
    --skew-bound-s wins)."""
    fixed = opts.get("skew-bound")
    base = workload_mod.checker(dict(opts.get("checker-opts") or {}))

    from ..checker.core import FnChecker

    def run(test, hist, copts):
        bound = fixed if fixed is not None \
            else skew_bound_from_history(hist)
        inner = dict(opts.get("checker-opts") or {})
        if bound:
            inner["skew-bound"] = int(bound)
        return workload_mod.checker(inner).check(test, hist, copts)

    return FnChecker(run, name=f"txn-{getattr(base, 'name', 'cycle')}")


def append_family(opts):
    store = opts["_store"]
    w = append_workload.test(opts.get("checker-opts"))
    return {**w,
            "checker": _checker(append_workload, opts),
            "client": ListAppendClient(store, opts.get("bug")),
            "generator": gen.stagger(1.0 / opts.get("rate", 100),
                                     w["generator"])}


def wr_family(opts):
    store = opts["_store"]
    w = wr_workload.test(opts.get("checker-opts"))
    return {**w,
            "checker": _checker(wr_workload, opts),
            "client": RwRegisterClient(store, opts.get("bug")),
            "generator": gen.stagger(1.0 / opts.get("rate", 100),
                                     w["generator"])}


WORKLOADS = {
    "append": append_family,
    "wr": wr_family,
}


def txn_test(opts):
    """Build the suite's test map from parsed CLI options (the
    campaign/worker builder: ``jepsen_tpu_torch.suites.txn:txn_test``)."""
    opts = dict(opts)
    # no card, no run: fail here, not in the contained checker
    resolve_device(opts.get("device"))
    store = TxnStore()
    opts["_store"] = store
    wname = opts.get("workload", "append")
    opts.setdefault("checker-opts", {
        "key-count": int(opts.get("key-count", 3)),
        "max-txn-length": int(opts.get("max-txn-length", 3)),
    })
    if opts.get("device") is not None:
        # the cycle checkers' closures run on the run's device
        opts["checker-opts"] = {**opts["checker-opts"],
                                "device": opts["device"]}
    if opts.get("skew-bound-s") is not None:
        opts["skew-bound"] = int(float(opts["skew-bound-s"]) * 1e9)
    workload = WORKLOADS[wname](opts)
    nem, nem_gen = nemesis_axis(opts.get("nemesis"))
    body = gen.clients(workload["generator"])
    if nem_gen is not None:
        body = gen.nemesis(nem_gen, body)
    generator = gen.time_limit(opts.get("time-limit", 8), body)
    checker = cc.compose({
        "workload": workload["checker"],
        "stats": cks.stats(),
        "exceptions": cks.unhandled_exceptions(),
    })
    test = {
        "name": f"txn-{wname}"
                + (f"-{opts['bug']}" if opts.get("bug") else "")
                + (f"-{opts['nemesis']}"
                   if opts.get("nemesis") not in (None, "none") else ""),
        "nodes": opts.get("nodes") or ["n1"],
        "concurrency": opts.get("concurrency")
        or len(opts.get("nodes") or ["n1"]) * 3,
        "ssh": opts.get("ssh", {"dummy?": True}),
        "os": jos.noop,
        "db": TxnDB(store),
        "nemesis": nem,
        "client": workload["client"],
        "generator": generator,
        "checker": checker,
    }
    for k in ("op-timeout-ms", "time-limit-s", "abort-grace-s",
              "monitor", "monitor-chunk", "progress-interval-s",
              "telemetry-flush-ms", "device"):
        if opts.get(k) is not None:
            test[k] = opts[k]
    if test.get("monitor"):
        mcfg = test["monitor"]
        if mcfg is True:
            mcfg = {}
        elif isinstance(mcfg, int):
            mcfg = {"chunk": mcfg}
        else:
            mcfg = dict(mcfg)
        mcfg.setdefault("family", "txn")
        mcfg.setdefault("workload", wname)
        if opts.get("skew-bound"):
            mcfg.setdefault("skew-bound", int(opts["skew-bound"]))
        if opts.get("device") is not None:
            mcfg["engine-opts"] = {**(mcfg.get("engine-opts") or {}),
                                   "device": opts["device"]}
        test["monitor"] = mcfg
    return test


def _opt_spec(parser):
    parser.add_argument("--workload", default="append",
                        choices=sorted(WORKLOADS))
    parser.add_argument("--bug", default=None,
                        choices=["future-read", "dirty-read",
                                 "stale-read"],
                        help="inject a consistency bug the cycle "
                             "checker (and live monitor) must catch")
    parser.add_argument("--nemesis", default="none",
                        choices=["none", "faketime", "charybdefs"],
                        help="fault axis: libfaketime clock skew or "
                             "CharybdeFS EIO injection (no-ops under "
                             "the dummy rig)")
    parser.add_argument("--rate", type=float, default=100,
                        help="approximate txns per second per thread")
    parser.add_argument("--key-count", type=int, default=3)
    parser.add_argument("--max-txn-length", type=int, default=3)
    parser.add_argument("--skew-bound-s", type=float, default=None,
                        help="explicit realtime-skew bound in seconds "
                             "(default: recovered from clock-nemesis "
                             "check-offsets completions)")


def main(argv=None):
    cmds = {}
    cmds.update(cli.single_test_cmd({"test-fn": txn_test,
                                     "opt-spec": _opt_spec}))
    cmds.update(cli.serve_cmd())
    cli.run(cmds, argv)


if __name__ == "__main__":
    cli.hard_main(main)
