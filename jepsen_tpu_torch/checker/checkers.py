"""The linearizability checker: histories in, verdict maps out (reference
jepsen/src/jepsen/checker.clj:185-216, mirroring
``jepsen_tpu.checker.checkers.Linearizable``).

``linearizable`` dispatches on "algorithm" as the reference dispatches to
knossos (checker.clj:199-202): "wgl" runs the sequential CPU oracle,
"linear" just-in-time linearization on the CPU (``linear``), "jax-wgl"
the batched device search (``torch_wgl``; the name is the JAX package's,
so test maps carry over), and "competition", the default as in the JAX
package and knossos, races all three: the first definite verdict wins.
"batch" is accepted as in the JAX package: a single history under it
races like "competition", and the ``independent`` checker batches it.

Under "jax-wgl" a history is planned first (``analysis/searchplan.py``):
sealed quiescent cuts slice it into segments that run as one key batch
(``parallel.check_batch_encoded``) and merge back into one verdict. Opt
out with ``test["searchplan?"] = False``. Unlike the JAX package, a
fault of the planner or of the planned batch raises: it does not fall
back to the flat search.

An invalid verdict renders its witness as ``linear.png``
(``linear_report``), as the JAX package does; the render is contained,
so a plotting failure (no matplotlib on the machine) is logged and the
verdict returned unchanged. Unlike the JAX package, the render gets the
checker's own ``opts``, so a per-key file lands in the key's
subdirectory (ROADMAP.md C.5), and a test map without a store directory
(no ``name`` or ``start-time``) renders nothing, as the JAX package's
per-key files skip it (``jepsen_tpu/independent.py:443``).

``engine_opts["mesh"]`` (a 1-D ``DeviceMesh``) under "jax-wgl" runs ONE
search sharded over the mesh's ranks (``parallel.check_encoded_sharded``;
every rank calls the checker with the same history), unplanned, as the
JAX package does; the ``independent`` checker hands the mesh to the
mesh key batch instead. A mesh under any other algorithm raises
ValueError: the JAX package would fail inside a racer.

The module also carries the JAX package's host checkers, copied
unchanged over the port's host models: ``unhandled_exceptions``,
``stats``, ``queue``, ``set_checker``, ``set_full``, ``total_queue`` (with
``expand_queue_drain_ops``), ``unique_ids``, ``counter`` and
``log_file_pattern`` (checker.clj:124-881).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import logging
import re
import sys
import threading
import time

from .. import history as h
from .. import obs
from ..models import base as mbase
from .core import Checker, merge_valid

__all__ = ["unhandled_exceptions", "stats", "Linearizable", "linearizable",
           "join_racers", "set_checker", "queue", "set_full",
           "expand_queue_drain_ops", "total_queue", "unique_ids",
           "counter", "log_file_pattern"]

logger = logging.getLogger(__name__)

ALGORITHMS = ("competition", "batch", "jax-wgl", "linear", "wgl")

#: the competitions whose racers ``join_racers`` has not joined yet
_races = []
_KEEP_RACES = 64
_races_lock = threading.Lock()

#: the interpreter's thread switch interval while a race runs. Every
#: torch call of the device racer releases the GIL and must take it back
#: from the two CPU racers, which hold it in pure-Python loops, so each
#: take waits up to an interval: on the cas-register main-path history
#: the device racer took 27.9-38.1 s at the default 5 ms, 6.5-13.1 s at
#: 50 us and 3.5-5.6 s at 5 us, against 0.36-0.52 s alone, in one H100
#: run (``race_ab.py``, PERF.md). Set while any race runs, restored when
#: the last one ends.
RACE_SWITCH_INTERVAL = 5e-6
#: the switch interval while a streaming monitor's check runs beside the
#: interpreter's busy workers (``monitor/``), for the same reason. The
#: command line's monitored dirty-read demo run (50 workers, chunk 8)
#: reached its first verdict after 27 s at the default 5 ms on the CPU,
#: 1.6 s at 5 us. On an H100 (``monitor_ab.py``, PERF.md) it aborted
#: within 0.48-1.33 s in six runs at 50 us; at 5 ms it took 1.23-7.72 s
#: and in one run of six the 8 s run ended first. 5 us cut the
#: interpreter to 230-260 client ops/s; 50 us costs it ~18% against
#: 5 ms (542-768 against 568-955 in four turns).
MONITOR_SWITCH_INTERVAL = 5e-5
#: the intervals of the scopes now open (``short_switch``)
_switch = {"open": [], "saved": None}


@contextlib.contextmanager
def short_switch(interval=None):
    """Run the body with the interpreter's switch interval at
    ``interval`` (default ``RACE_SWITCH_INTERVAL``): a thread whose torch
    calls each release the GIL (a device racer, a monitor's check) then
    takes it back from busy pure-Python threads (the CPU racers, the
    interpreter's workers) within the interval, not within the default
    5 ms. Concurrent and nested scopes run at the shortest interval open;
    the last to leave restores the saved one."""
    interval = RACE_SWITCH_INTERVAL if interval is None else interval
    with _races_lock:
        if not _switch["open"]:
            _switch["saved"] = sys.getswitchinterval()
        _switch["open"].append(interval)
        sys.setswitchinterval(min(_switch["open"]))
    try:
        yield
    finally:
        _leave_switch(interval)


def _leave_switch(interval):
    """Close one ``short_switch`` scope: the shortest interval still
    open, or the saved one once none is."""
    with _races_lock:
        _switch["open"].remove(interval)
        sys.setswitchinterval(min(_switch["open"])
                              if _switch["open"] else _switch["saved"])


class _UnhandledExceptions(Checker):
    """Aggregates info ops carrying exceptions by class
    (checker.clj:124-151)."""

    def check(self, test, hist, opts=None):
        exes = [o for o in hist
                if o.get("exception") and o.get("type") == "info"]
        groups = collections.defaultdict(list)
        for o in exes:
            groups[o.get("exception")].append(o)
        out = sorted(groups.values(), key=len, reverse=True)
        result = {"valid": True}
        if out:
            result["exceptions"] = [
                {"count": len(ops), "class": ops[0].get("exception"),
                 "example": ops[0]} for ops in out]
        return result


def unhandled_exceptions():
    return _UnhandledExceptions()


def _stats_map(hist):
    ok = sum(1 for o in hist if h.ok(o))
    fail = sum(1 for o in hist if h.fail(o))
    info = sum(1 for o in hist if h.info(o))
    return {"valid": ok > 0, "count": ok + fail + info,
            "ok-count": ok, "fail-count": fail, "info-count": info}


class _Stats(Checker):
    """ok/fail/info counts overall and by :f; valid iff every f saw an ok
    (checker.clj:153-183)."""

    def check(self, test, hist, opts=None):
        hist = [o for o in hist
                if not h.invoke(o) and o.get("process") != "nemesis"]
        by_f = collections.defaultdict(list)
        for o in hist:
            by_f[o.get("f")].append(o)
        groups = {f: _stats_map(sub) for f, sub in sorted(
            by_f.items(), key=lambda kv: str(kv[0]))}
        out = _stats_map(hist)
        out["by-f"] = groups
        out["valid"] = merge_valid([g["valid"] for g in groups.values()])
        return out


def stats():
    return _Stats()


class Linearizable(Checker):
    """THE gate to the linearizability engines (checker.clj:185-216).
    algorithm: "wgl" (sequential CPU oracle), "linear" (JIT
    linearization on the CPU; bounded config set, may return "unknown"
    on overflow), "jax-wgl" (the batched device search) or the default
    "competition" (races all three; the first definite verdict wins;
    "batch" races the same way on a single history). ``engine_opts`` go
    to ``torch_wgl.check_encoded`` (``device``, ``rollout_kernel``,
    budgets, ``checkpoint``); ``init_ops`` establish the initial state as
    in the JAX package."""

    def __init__(self, model, algorithm="competition", engine_opts=None,
                 init_ops=None):
        assert model is not None, \
            "the linearizable checker requires a model"
        self.spec = mbase.model_spec(model)
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.algorithm = algorithm
        self.engine_opts = engine_opts or {}
        if self.engine_opts.get("mesh") is not None \
                and algorithm != "jax-wgl":
            raise ValueError(
                f"engine_opts['mesh'] needs algorithm 'jax-wgl' (the "
                f"sharded device search), not {algorithm!r}")
        self.init_ops = list(init_ops or [])

    @property
    def device(self):
        """Where the device engine runs: ``engine_opts["device"]``, else
        the mesh's device, else None (CUDA)."""
        mesh = self.engine_opts.get("mesh")
        if mesh is not None:
            from ..parallel.keyshard import mesh_device
            return mesh_device(mesh, self.engine_opts.get("device"))
        return self.engine_opts.get("device")

    def prepare_history(self, client_hist):
        """Prepend the init ops as already-completed pairs ordered before
        every real op (negative indices), as the JAX package does."""
        if not self.init_ops:
            return client_hist
        lo = min((o.get("index", 0) for o in client_hist), default=0)
        synth = []
        for j, op in enumerate(self.init_ops):
            base = lo - 2 * (len(self.init_ops) - j)
            synth.append({"type": "invoke", "process": -1,
                          "f": op["f"], "value": op.get("value"),
                          "index": base, "time": base})
            synth.append({"type": "ok", "process": -1,
                          "f": op["f"], "value": op.get("value"),
                          "index": base + 1, "time": base + 1})
        return synth + client_hist

    def check(self, test, hist, opts=None):
        from . import linear, torch_wgl, wgl
        client_hist = self.prepare_history(h.client_ops(hist))
        a = None
        mesh = self.engine_opts.get("mesh")
        if self.algorithm == "jax-wgl" and mesh is None:
            a = self._check_planned(test, client_hist)
        if a is None:
            e, init_state = self.spec.encode(client_hist)
            if self.algorithm == "wgl":
                a = wgl.check_encoded(self.spec, e, init_state)
            elif self.algorithm == "linear":
                a = linear.check_encoded(self.spec, e, init_state)
            elif mesh is not None:
                a = self._check_sharded(e, init_state)
            elif self.algorithm == "jax-wgl":
                a = torch_wgl.check_encoded(self.spec, e, init_state,
                                            **self.engine_opts)
            else:
                a = self._competition(e, init_state)
        # truncate heavyweight fields (checker.clj:213-216: "writing
        # these can take *hours*"): at most 10 paths / 10 configs
        if "final_paths" in a:
            a["final_paths"] = a["final_paths"][:10]
        if "configs" in a:
            a["configs"] = a["configs"][:10]
        if a.get("valid") is False and isinstance(test, dict) \
                and test.get("name") and test.get("start-time"):
            # render the failure witness like the reference's linear.svg
            # (checker.clj:206-212) into the test's store directory (a
            # test map without one has nowhere to put it); the verdict is
            # final here, and plotting never changes it
            try:
                from . import linear_report
                linear_report.render_analysis(test, client_hist, a, opts)
            except Exception:  # noqa: BLE001 - host-only plotting
                logger.warning("couldn't render linear.png",
                               exc_info=True)
        a["valid?"] = a["valid"]
        return a

    #: engine_opts the mesh-sharded search takes
    _SHARDED_OPTS = frozenset({"max_configs", "frontier_width",
                               "stack_size", "table_size", "timeout_s",
                               "chunk_iters", "steal", "rollout_seeds",
                               "device"})

    def _check_sharded(self, e, init_state):
        """ONE search sharded over ``engine_opts["mesh"]``
        (``parallel/searchshard.py``): the options the sharded engine
        supports are forwarded, the rest dropped with a warning."""
        from .. import parallel
        opts = {k: v for k, v in self.engine_opts.items() if k != "mesh"}
        dropped = sorted(set(opts) - self._SHARDED_OPTS)
        if dropped:
            logger.warning("engine_opts %s are not supported by the "
                           "mesh-sharded search; ignoring", dropped)
        return parallel.check_encoded_sharded(
            self.spec, e, init_state, self.engine_opts["mesh"],
            **{k: v for k, v in opts.items() if k in self._SHARDED_OPTS})

    #: engine_opts the planned batch path takes: everything
    #: check_batch_encoded supports, checkpoint/resume included (its
    #: fingerprint covers the per-segment inputs, so a rerun of the same
    #: plan resumes). The rest are single-search-only (confirm,
    #: rollout_kernel, rollout_depth).
    _PLANNED_OPTS = frozenset({"max_configs", "chunk_iters", "timeout_s",
                               "frontier_width", "stack_size",
                               "table_size", "rollout_seeds",
                               "checkpoint", "checkpoint_every_s",
                               "device"})

    def _check_planned(self, test, client_hist):
        """Consult the search plan for this (already init-op-prepared)
        client history: when sealed quiescent cuts slice it into >= 2
        segments, run them as one batched device call and merge. Returns
        None when planning is off or yields no reduction; the caller then
        runs the flat search. A fault raises."""
        if not isinstance(test, dict):
            return None
        from ..analysis import searchplan
        if not searchplan.segments_enabled(test):
            return None
        unsupported = set(self.engine_opts) - self._PLANNED_OPTS
        if "confirm" in unsupported:
            # oracle confirmation changes the result contract; the flat
            # search honors it, so planning steps aside
            return None
        t0 = time.monotonic()
        segs, info = searchplan.plan_segments(
            self.spec, client_hist, searchplan.min_segment(test))
        if len(segs) < 2:
            return None
        if unsupported:
            logger.warning(
                "engine_opts %s are not supported by the planned batch "
                "search; ignoring", sorted(unsupported))
        plan_s = time.monotonic() - t0
        from .. import parallel
        pairs = [self.spec.encode(s.events) for s in segs]
        eopts = {k: v for k, v in self.engine_opts.items()
                 if k in self._PLANNED_OPTS}
        results = parallel.check_batch_encoded(self.spec, pairs, **eopts)
        # stamp segment provenance onto each normalized witness before the
        # merge folds them: the certifier re-derives the same cuts and
        # matches index/count/seed exactly
        for i, (r, s) in enumerate(zip(results, segs)):
            w = r.get("witness")
            if isinstance(w, dict):
                w["segment"] = {"index": i, "count": len(segs),
                                "seed": s.seed}
        merged = searchplan.merge_segment_results(results, info, plan_s)
        obs.inc("checker.planned_checks", valid=str(merged.get("valid")))
        obs.observe("checker.plan_s", plan_s)
        return merged

    def _competition(self, e, init_state):
        """Race the sequential oracle (2M configs) and the JIT
        linearizer (200k) against the device engine; the first *definite*
        verdict wins (knossos.competition semantics, checker.clj:199-202).
        If the first engine to finish returns "unknown" (a budget
        overflow), wait for the others and prefer a definite verdict. An
        exception in any racer is re-raised once the race is decided:
        it never turns into "unknown" while another racer's verdict is
        returned. The losers are asked to stop and joined briefly, as in
        the JAX package; ``join_racers`` waits for the stragglers."""
        from . import linear, torch_wgl, wgl
        cancel = threading.Event()
        first_done = threading.Event()
        race = _Race()
        engines = [
            ("wgl", lambda: wgl.check_encoded(
                self.spec, e, init_state, max_configs=2_000_000,
                cancel=cancel)),
            ("linear", lambda: linear.check_encoded(
                self.spec, e, init_state, max_configs=200_000,
                cancel=cancel)),
            ("jax-wgl", lambda: torch_wgl.check_encoded(
                self.spec, e, init_state, cancel=cancel,
                **self.engine_opts)),
        ]
        with _races_lock:
            # keep the last _KEEP_RACES for join_racers; an older race is
            # dropped once its racers have ended with nothing to raise
            while len(_races) >= _KEEP_RACES and _races[0].settled():
                _races.pop(0)
            _races.append(race)
        with short_switch():
            threads = [race.start(name, fn, first_done)
                       for name, fn in engines]
            # wait for the first DEFINITE verdict (or everyone to finish)
            while True:
                first_done.wait()
                with race.lock:
                    first_done.clear()
                    done = [race.racers[nm] for nm in race.order]
                    definite = [r for r in done if r["error"] is None
                                and r["result"]["valid"] != "unknown"]
                    if definite or len(done) == len(threads):
                        race.decided = time.monotonic()
                        break
            # ask the losing engines to stop (checked between device
            # chunks and every few thousand host configs); join briefly
            cancel.set()
            for t in threads:
                t.join(timeout=0.5)
        with race.lock:
            err = race.unraised_error()
        if err is not None:
            raise err
        winner = (definite or done)[0]
        r = dict(winner["result"])
        r["engine"] = winner["engine"]
        race.winner = winner["engine"]
        obs.inc("checker.competition_wins", engine=r["engine"])
        obs.instant("checker.competition", cat="checker",
                    winner=r["engine"], valid=str(r.get("valid")))
        return r


class _Race:
    """One competition's racers: per racer its thread, start and end
    times, result or exception."""

    def __init__(self):
        self.lock = threading.Lock()
        self.racers = {}
        self.order = []          # engine names, in the order they ended
        self.started = time.monotonic()
        self.decided = None
        self.winner = None

    def start(self, name, fn, first_done):
        rec = {"engine": name, "t0": None, "t1": None, "result": None,
               "error": None, "raised": False}
        self.racers[name] = rec

        def run():
            rec["t0"] = time.monotonic()
            try:
                rec["result"] = fn()
            except Exception as exc:  # noqa: BLE001 - re-raised by the race
                rec["error"] = exc
            with self.lock:
                rec["t1"] = time.monotonic()
                self.order.append(name)
            first_done.set()

        # each racer runs in a copy of the caller's contextvars
        t = threading.Thread(target=contextvars.copy_context().run,
                             args=(run,), daemon=True,
                             name=f"competition-{name}")
        rec["thread"] = t
        t.start()
        return t

    def settled(self):
        """Every racer has ended and none holds an unseen exception."""
        with self.lock:
            return all(r["t1"] is not None and (r["error"] is None
                                                or r["raised"])
                       for r in self.racers.values())

    def unraised_error(self):
        """The first exception of an ended racer that no caller has seen
        (the device racer's first), marked as seen."""
        for name in ("jax-wgl", "wgl", "linear"):
            rec = self.racers.get(name)
            if rec and rec["t1"] is not None and rec["error"] is not None \
                    and not rec["raised"]:
                rec["raised"] = True
                return rec["error"]
        return None

    def summary(self):
        ended = [r["t1"] for r in self.racers.values()]
        return {"winner": self.winner,
                "decided_s": (self.decided - self.started
                              if self.decided else None),
                "exit_after_verdict_s": (max(0.0, max(ended) - self.decided)
                                         if self.decided else None),
                "racers": {
                    name: {"wall_s": r["t1"] - r["t0"],
                           "valid": (r["result"]["valid"]
                                     if r["result"] is not None else None),
                           "error": (r["result"].get("error")
                                     if r["result"] is not None
                                     else repr(r["error"]))}
                    for name, r in self.racers.items()}}


def join_racers():
    """Wait for every racer of every competition started so far to end
    (a cancelled device racer stops at its next chunk boundary) and
    return one summary per competition: the winner, the seconds to the
    verdict, the seconds the last racer took to exit after it, and each
    racer's wall, verdict and error. A racer exception that no check has
    raised yet (a straggler's) is raised here."""
    with _races_lock:
        races = list(_races)
        _races.clear()
    for race in races:
        for rec in race.racers.values():
            rec["thread"].join()
    out = [race.summary() for race in races]
    for race in races:
        err = race.unraised_error()
        if err is not None:
            raise err
    return out


def linearizable(opts):
    """linearizable({"model": ..., "algorithm": ...})
    (checker.clj:185-216)."""
    if isinstance(opts, dict):
        return Linearizable(opts["model"], opts.get("algorithm",
                                                    "competition"),
                            opts.get("engine_opts"),
                            opts.get("init-ops"))
    return Linearizable(opts)


class _Queue(Checker):
    """Model-fold queue check: non-failing enqueues count, only ok
    dequeues count (checker.clj:218-238)."""

    def __init__(self, model):
        self.model = model

    def check(self, test, hist, opts=None):
        state = self.model
        for op in hist:
            f = op.get("f")
            take = (f == "enqueue" and h.invoke(op)) or \
                   (f == "dequeue" and h.ok(op))
            if not take:
                continue
            state = state.step(op)
            if mbase.is_inconsistent(state):
                return {"valid": False, "error": state.msg}
        return {"valid": True, "final-queue": state}


def queue(model):
    return _Queue(model)


class _SetChecker(Checker):
    """adds + final read: lost/unexpected/recovered analysis
    (checker.clj:240-291)."""

    def check(self, test, hist, opts=None):
        attempts = {o.get("value") for o in hist
                    if h.invoke(o) and o.get("f") == "add"}
        adds = {o.get("value") for o in hist
                if h.ok(o) and o.get("f") == "add"}
        final_read = None
        for o in hist:
            if h.ok(o) and o.get("f") == "read":
                final_read = o.get("value")
        if final_read is None:
            return {"valid": "unknown", "error": "Set was never read"}
        final = set(final_read)
        ok = final & attempts
        unexpected = final - attempts
        lost = adds - final
        recovered = ok - adds
        return {"valid": not lost and not unexpected,
                "attempt-count": len(attempts),
                "acknowledged-count": len(adds),
                "ok-count": len(ok),
                "lost-count": len(lost),
                "recovered-count": len(recovered),
                "unexpected-count": len(unexpected),
                "ok": sorted(ok), "lost": sorted(lost),
                "unexpected": sorted(unexpected),
                "recovered": sorted(recovered)}


def set_checker():
    return _SetChecker()


class _SetFullElement:
    """Per-element timeline state (checker.clj SetFullElement,
    :300-340)."""

    __slots__ = ("element", "known", "last_present", "last_absent")

    def __init__(self, element):
        self.element = element
        self.known = None
        self.last_present = None
        self.last_absent = None

    def add_ok(self, op):
        if self.known is None:
            self.known = op

    def read_present(self, inv, op):
        if self.known is None:
            self.known = op
        if self.last_present is None or \
                self.last_present["index"] < inv["index"]:
            self.last_present = inv

    def read_absent(self, inv, op):
        if self.last_absent is None or \
                self.last_absent["index"] < inv["index"]:
            self.last_absent = inv

    def results(self):
        """Outcome classification (checker.clj:346-405)."""
        idx = lambda o, d=-1: o["index"] if o is not None else d  # noqa:E731
        stable = bool(self.last_present is not None and
                      idx(self.last_absent) < idx(self.last_present))
        lost = bool(self.known is not None and
                    self.last_absent is not None and
                    idx(self.last_present) < idx(self.last_absent) and
                    self.known["index"] < idx(self.last_absent))
        never_read = not (stable or lost)
        known_time = self.known["time"] if self.known else None
        stable_latency = None
        lost_latency = None
        if stable:
            stable_time = (self.last_absent["time"] + 1
                           if self.last_absent else 0)
            stable_latency = int(max(0, stable_time - known_time) / 1e6)
        if lost:
            lost_time = (self.last_present["time"] + 1
                         if self.last_present else 0)
            lost_latency = int(max(0, lost_time - known_time) / 1e6)
        return {"element": self.element,
                "outcome": ("stable" if stable else
                            "lost" if lost else "never-read"),
                "stable-latency": stable_latency,
                "lost-latency": lost_latency,
                "known": self.known,
                "last-absent": self.last_absent,
                "never_read": never_read}


def _frequency_distribution(points, values):
    values = sorted(values)
    if not values:
        return None
    n = len(values)
    return {p: values[min(n - 1, int(n * p))] for p in points}


class _SetFull(Checker):
    """Per-element stable/lost timeline analysis with latency quantiles
    (checker.clj:294-592)."""

    def __init__(self, linearizable=False):
        self.linearizable = linearizable

    def check(self, test, hist, opts=None):
        hist = h.ensure_indexed(hist)
        elements = {}
        reads = {}
        dups = {}
        for op in hist:
            if not isinstance(op.get("process"), int):
                continue
            f = op.get("f")
            v = op.get("value")
            p = op.get("process")
            if f == "add":
                if h.invoke(op):
                    elements[v] = _SetFullElement(v)
                elif h.ok(op) and v in elements:
                    elements[v].add_ok(op)
            elif f == "read":
                if h.invoke(op):
                    reads[p] = op
                elif h.fail(op):
                    reads.pop(p, None)
                elif h.ok(op):
                    inv = reads.pop(p, op)
                    counts = collections.Counter(v)
                    for k, c in counts.items():
                        if c > 1:
                            dups[k] = max(dups.get(k, 0), c)
                    vs = set(v)
                    for el, state in elements.items():
                        if el in vs:
                            state.read_present(inv, op)
                        else:
                            state.read_absent(inv, op)
        rs = [elements[k].results()
              for k in sorted(elements, key=lambda x: (str(type(x)), x))]
        outcomes = collections.defaultdict(list)
        for r in rs:
            outcomes[r["outcome"]].append(r)
        stale = [r for r in outcomes["stable"]
                 if r["stable-latency"] and r["stable-latency"] > 0]
        valid = (False if outcomes["lost"] else
                 "unknown" if not outcomes["stable"] else
                 False if self.linearizable and stale else True)
        if dups:
            valid = False
        out = {"valid": valid,
               "attempt-count": len(rs),
               "stable-count": len(outcomes["stable"]),
               "lost-count": len(outcomes["lost"]),
               "lost": sorted(r["element"] for r in outcomes["lost"]),
               "never-read-count": len(outcomes["never-read"]),
               "never-read": sorted(r["element"]
                                    for r in outcomes["never-read"]),
               "stale-count": len(stale),
               "stale": sorted(r["element"] for r in stale),
               "worst-stale": sorted(stale, key=lambda r:
                                     -(r["stable-latency"] or 0))[:8],
               "duplicated-count": len(dups),
               "duplicated": dups}
        points = (0, 0.5, 0.95, 0.99, 1)
        sl = [r["stable-latency"] for r in rs
              if r["stable-latency"] is not None]
        ll = [r["lost-latency"] for r in rs
              if r["lost-latency"] is not None]
        if sl:
            out["stable-latencies"] = _frequency_distribution(points, sl)
        if ll:
            out["lost-latencies"] = _frequency_distribution(points, ll)
        return out


def set_full(checker_opts=None):
    opts = checker_opts or {}
    return _SetFull(linearizable=opts.get("linearizable?", False))


def expand_queue_drain_ops(hist):
    """Expand ok :drain ops into dequeue invoke/ok pairs
    (checker.clj:594-626)."""
    out = []
    for op in hist:
        if op.get("f") != "drain":
            out.append(op)
        elif h.invoke(op) or h.fail(op):
            continue
        elif h.ok(op):
            for element in op.get("value") or []:
                inv = dict(op)
                inv.update(type="invoke", f="dequeue", value=None)
                comp = dict(op)
                comp.update(type="ok", f="dequeue", value=element)
                out.extend([inv, comp])
        else:
            raise ValueError(
                f"not sure how to handle a crashed drain: {op!r}")
    return out


class _TotalQueue(Checker):
    """Multiset conservation: what goes in must come out
    (checker.clj:628-687)."""

    def check(self, test, hist, opts=None):
        hist = expand_queue_drain_ops(hist)
        attempts = collections.Counter(
            o.get("value") for o in hist
            if h.invoke(o) and o.get("f") == "enqueue")
        enqueues = collections.Counter(
            o.get("value") for o in hist
            if h.ok(o) and o.get("f") == "enqueue")
        dequeues = collections.Counter(
            o.get("value") for o in hist
            if h.ok(o) and o.get("f") == "dequeue")
        ok = dequeues & attempts
        unexpected = collections.Counter(
            {k: v for k, v in dequeues.items() if k not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        return {"valid": not lost and not unexpected,
                "attempt-count": sum(attempts.values()),
                "acknowledged-count": sum(enqueues.values()),
                "ok-count": sum(ok.values()),
                "unexpected-count": sum(unexpected.values()),
                "duplicated-count": sum(duplicated.values()),
                "lost-count": sum(lost.values()),
                "recovered-count": sum(recovered.values()),
                "lost": dict(lost), "unexpected": dict(unexpected),
                "duplicated": dict(duplicated),
                "recovered": dict(recovered)}


def total_queue():
    return _TotalQueue()


class _UniqueIds(Checker):
    """Are generated IDs distinct? (checker.clj:689-734)"""

    def check(self, test, hist, opts=None):
        attempted = sum(1 for o in hist
                        if h.invoke(o) and o.get("f") == "generate")
        acks = [o.get("value") for o in hist
                if h.ok(o) and o.get("f") == "generate"]
        counts = collections.Counter(acks)
        dups = {k: v for k, v in counts.items() if v > 1}
        rng = [min(acks), max(acks)] if acks else None
        top_dups = dict(sorted(dups.items(), key=lambda kv: -kv[1])[:48])
        return {"valid": not dups,
                "attempted-count": attempted,
                "acknowledged-count": len(acks),
                "duplicated-count": len(dups),
                "duplicated": top_dups,
                "range": rng}


def unique_ids():
    return _UniqueIds()


class _Counter(Checker):
    """Bounds-interval counter check: each read must fall within
    [sum of ok adds at invoke, sum of attempted adds at completion]
    (checker.clj:737-795)."""

    def check(self, test, hist, opts=None):
        hist = [o for o in h.complete(hist)
                if not h.fail(o) and not o.get("fails?")]
        lower = 0
        upper = 0
        pending = {}
        reads = []
        for op in hist:
            key = (op.get("type"), op.get("f"))
            if key == ("invoke", "read"):
                pending[op["process"]] = [lower, op.get("value")]
            elif key == ("ok", "read"):
                r = pending.pop(op["process"], None)
                if r is not None:
                    reads.append(r + [upper])
            elif key == ("invoke", "add"):
                v = op.get("value") or 0
                # a pending add widens the bound in its direction; a
                # negative add lowers the reachable floor instead
                if v >= 0:
                    upper += v
                else:
                    lower += v
            elif key == ("ok", "add"):
                v = op.get("value") or 0
                if v >= 0:
                    lower += v
                else:
                    upper += v
        errors = [r for r in reads
                  if not (r[0] <= r[1] <= r[2])]
        return {"valid": not errors, "reads": reads, "errors": errors}


def counter():
    return _Counter()


class _LogFilePattern(Checker):
    """Greps downloaded node logs in the store dir for a pattern
    (checker.clj:839-881)."""

    def __init__(self, pattern, filename):
        self.pattern = re.compile(pattern)
        self.filename = filename

    def check(self, test, hist, opts=None):
        from .. import store
        try:
            paths = {node: store.path(test, node, self.filename)
                     for node in test.get("nodes", [])}
        except (AssertionError, KeyError):
            return {"valid": "unknown",
                    "error": "no store directory for this test"}
        matches = []
        for node, path in paths.items():
            try:
                with open(path, errors="replace") as f:
                    for line in f:
                        if self.pattern.search(line):
                            matches.append({"node": node,
                                            "line": line.rstrip("\n")})
            except FileNotFoundError:
                continue
        return {"valid": not matches, "count": len(matches),
                "matches": matches}


def log_file_pattern(pattern, filename):
    return _LogFilePattern(pattern, filename)
