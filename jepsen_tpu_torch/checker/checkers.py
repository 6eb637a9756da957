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
"""

from __future__ import annotations

import contextvars
import logging
import sys
import threading
import time

from .. import history as h
from .. import obs
from ..models import base as mbase
from .core import Checker

__all__ = ["Linearizable", "linearizable", "join_racers"]

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
_switch = {"races": 0, "saved": None}


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
        if "mesh" in self.engine_opts:
            raise NotImplementedError(
                "engine_opts['mesh'] is not ported to jepsen_tpu_torch "
                "yet: ROADMAP.md queue A, A.10 (the multi-device search)")
        self.init_ops = list(init_ops or [])

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
        if self.algorithm == "jax-wgl":
            a = self._check_planned(test, client_hist)
        if a is None:
            e, init_state = self.spec.encode(client_hist)
            if self.algorithm == "wgl":
                a = wgl.check_encoded(self.spec, e, init_state)
            elif self.algorithm == "linear":
                a = linear.check_encoded(self.spec, e, init_state)
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
            if _switch["races"] == 0:
                _switch["saved"] = sys.getswitchinterval()
                sys.setswitchinterval(RACE_SWITCH_INTERVAL)
            _switch["races"] += 1
        try:
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
        finally:
            with _races_lock:
                _switch["races"] -= 1
                if _switch["races"] == 0:
                    sys.setswitchinterval(_switch["saved"])
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
