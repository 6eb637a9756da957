"""Checker protocol + combinators (reference jepsen/src/jepsen/checker.clj).

A checker examines a history and returns a map with a ``valid`` key:
True, False, or "unknown" (couldn't decide). Validity merges with
False > "unknown" > True (checker.clj:29-50).

The part of ``jepsen_tpu.checker.core`` the port needs: validity merging,
the checker protocol and its combinators; ``check``, which lints the
history (``lint_history``, histlint) and reports its search plan
(``plan_history``, the plan report of record) once per test map before
the checker runs, and certifies a decided Linearizable verdict after it
returns (``certify_verdict``, ``analysis/certify.py``); and
``check_safe``, which traces every (sub)checker run.
"""

from __future__ import annotations

import logging
import threading
import traceback

from .. import history as h
from .. import obs
from ..util import real_pmap

__all__ = ["Checker", "check", "check_safe", "compose", "concurrency_limit",
           "noop", "unbridled_optimism", "merge_valid", "valid_prio",
           "lint_history", "plan_history", "certify_verdict"]

logger = logging.getLogger(__name__)


def valid_prio(v):
    """Validity severity: false dominates, then unknown, then true
    (checker.clj:29-39)."""
    if v is False:
        return 0
    if v == "unknown" or v is None:
        return 1
    return 2


def merge_valid(valids):
    """Merge a collection of validity values (checker.clj:41-50)."""
    out = True
    for v in valids:
        if valid_prio(v) < valid_prio(out):
            out = v
    return out


class Checker:
    """check(test, history, opts) -> {"valid": ..., ...} (checker.clj:52-67).

    opts is a map like {"history-file": ..., "subdirectory": ...} used by
    checkers that write files.
    """

    def check(self, test, hist, opts=None):  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, test, hist, opts=None):
        return self.check(test, hist, opts or {})


class FnChecker(Checker):
    def __init__(self, fn, name=None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "checker")

    def check(self, test, hist, opts=None):
        return self.fn(test, hist, opts or {})

    def __repr__(self):
        return f"<checker {self.name}>"


def as_checker(c) -> Checker:
    if isinstance(c, Checker):
        return c
    if callable(c):
        return FnChecker(c)
    raise TypeError(f"not a checker: {c!r}")


def checker_name(checker):
    """Human-readable checker name for spans/metrics."""
    return getattr(checker, "name", None) or type(checker).__name__


_lint_lock = threading.Lock()


def lint_history(test, hist):
    """Run histlint over ``hist`` once per test map, before checkers see
    it: diagnostics land in ``test["analysis"]["history"]``
    (``store.write_analysis`` persists them as analysis.json) and error
    findings are logged. Opt out per test with ``test["analysis?"] =
    False``. Runs at most once per test dict -- Compose fans every
    subchecker back through check(), and the history doesn't change.

    Lint failures are contained: a bug in the analyzer must never
    change a verdict."""
    if not isinstance(test, dict) or not test.get("analysis?", True):
        return
    with _lint_lock:
        if test.get("analysis-done?"):
            return
        test["analysis-done?"] = True
    try:
        from .. import analysis
        diags = analysis.run_analyzer(
            "histlint", analysis.lint_test_history, test, hist)
        report = analysis.to_json(diags)
        test.setdefault("analysis", {})["history"] = report
        errs = analysis.errors(diags)
        if errs:
            logger.warning(
                "%s", analysis.render_text(
                    errs, title="history lint found structural "
                                "defects; the verdict below may not "
                                "be trustworthy:"))
    except Exception:  # noqa: BLE001 - telemetry, never verdict-bearing
        logger.warning("history lint crashed", exc_info=True)


def plan_history(test, hist):
    """Run the search planner over ``hist`` once per test map, next to
    histlint: the SearchPlan's SP/JX007 diagnostics land in
    ``test["analysis"]["searchplan"]`` with the plan summary alongside.
    The executing checkers (Linearizable, independent's batched path)
    derive their own segments -- this hook is the report of record, and
    like histlint it is contained: a planner fault must never change a
    verdict. Opt out per test with ``test["searchplan?"] = False`` (or
    ``test["analysis?"] = False`` for all analyzers)."""
    if not isinstance(test, dict) or not test.get("analysis?", True):
        return
    from ..analysis import searchplan
    if not searchplan.enabled(test):
        return
    with _lint_lock:
        if test.get("searchplan-done?"):
            return
        test["searchplan-done?"] = True
    try:
        from .. import analysis
        holder = {}

        def build():
            plan = searchplan.build_plan(test, hist)
            if plan is None:
                return []
            holder["summary"] = plan.summary()
            return plan.diagnostics

        diags = analysis.run_analyzer("searchplan", build)
        summary = holder.get("summary")
        if summary is not None:
            report = analysis.to_json(diags)
            report["summary"] = summary
            test.setdefault("analysis", {})["searchplan"] = report
    except Exception:  # noqa: BLE001 - telemetry, never verdict-bearing
        logger.warning("search planning crashed", exc_info=True)


def certify_verdict(checker, test, hist, result, key=None):
    """Certify a decided Linearizable verdict from its own artifacts,
    after the checker returns: replay the witness through the CPU model
    (VC001-VC003), cross-check invalid verdicts through an independent
    engine (VC008), and run the sampled differential (VC010), its
    device-engine replay on the checker's device. Findings land in
    ``test["analysis"]["certify"]`` and the full proof in
    ``test["certificate"]``; error findings are logged. Opt out per test
    with ``test["certify?"] = False``. Runs at most once per test dict.

    Certification is contained as in the JAX package: a certifier fault
    must never flip a verdict."""
    if not isinstance(result, dict) \
            or result.get("valid") not in (True, False):
        return
    try:
        from ..analysis import certify
        if not certify.enabled(test):
            return
        from .checkers import Linearizable
        if not isinstance(checker, Linearizable):
            return
        with _lint_lock:
            if test.get("certify-done?"):
                return
            test["certify-done?"] = True
        from .. import analysis
        cfg = certify.config(test)
        client = checker.prepare_history(h.client_ops(hist))
        holder = {}

        def build():
            cert, diags = certify.certify_with_diagnostics(
                checker.spec, client, result, test=test,
                samples=cfg["samples"], budget=cfg["budget"],
                init_ops=checker.init_ops, key=key,
                device=checker.device)
            holder["cert"] = cert
            return diags

        diags = analysis.run_analyzer("certify", build)
        cert = holder["cert"]
        report = analysis.to_json(diags)
        report["summary"] = {"verdict": cert["verdict"],
                             "engine": cert["engine"],
                             "checks": cert["checks"]}
        test.setdefault("analysis", {})["certify"] = report
        test["certificate"] = cert
        errs = analysis.errors(diags)
        if obs.enabled():
            obs.inc("analysis.certify.runs",
                    verdict=str(result.get("valid")))
            if errs:
                obs.inc("analysis.certify.vc_errors", len(errs))
        if errs:
            logger.warning(
                "%s", analysis.render_text(
                    errs, title="verdict certification FAILED; the "
                                "verdict above does not replay from its "
                                "own witness:"))
    except Exception:  # noqa: BLE001 - contained, never verdict-bearing
        logger.warning("verdict certification crashed", exc_info=True)


def check(checker, test, hist, opts=None):
    """Lint and plan an indexed history (once per test map), run the
    checker over it, then certify its verdict (``certify_verdict``)."""
    hist = h.ensure_indexed(hist)
    lint_history(test, hist)
    plan_history(test, hist)
    result = as_checker(checker).check(test, hist, opts or {})
    certify_verdict(checker, test, hist, result)
    return result


def check_safe(checker, test, hist, opts=None):
    """Like check, but exceptions become {"valid": "unknown"}
    (checker.clj:74-85). Every (sub)checker run -- Compose fans out
    through here too -- gets a trace span + latency observation."""
    name = checker_name(checker)
    t0 = obs.now_ns()
    try:
        result = check(checker, test, hist, opts)
    except Exception:  # noqa: BLE001 - mirrors reference behavior
        result = {"valid": "unknown", "error": traceback.format_exc()}
    if obs.enabled():
        dur = obs.now_ns() - t0
        obs.complete(f"checker.{name}", t0, dur, cat="checker",
                     valid=str(result.get("valid")))
        obs.observe("checker.check_s", dur / 1e9, checker=name)
        obs.inc("checker.checks", checker=name,
                valid=str(result.get("valid")))
    return result


class Compose(Checker):
    """Map of name -> checker, run in parallel; result map of name -> result
    with merged validity (checker.clj:87-99)."""

    def __init__(self, checker_map):
        self.checker_map = {k: as_checker(c) for k, c in checker_map.items()}

    def check(self, test, hist, opts=None):
        items = list(self.checker_map.items())
        results = real_pmap(
            lambda kv: (kv[0], check_safe(kv[1], test, hist, opts)), items)
        rmap = dict(results)
        return {"valid": merge_valid([r.get("valid") for r in rmap.values()]),
                **rmap}


def compose(checker_map):
    return Compose(checker_map)


class _Noop(Checker):
    def check(self, test, hist, opts=None):
        return {"valid": True}


def noop():
    return _Noop()


class _Optimism(Checker):
    def check(self, test, hist, opts=None):
        return {"valid": True, "everything-looks-good?": "definitely"}


def unbridled_optimism():
    """Everything is awesome! (checker.clj:118-122)"""
    return _Optimism()


_limit_semaphores = {}
_limit_lock = threading.Lock()


class ConcurrencyLimit(Checker):
    """At most ``limit`` concurrent executions of this checker across
    threads, keyed by ``key`` -- memory governance for expensive checkers
    (checker.clj:101-116). Limits under one key share the first one's
    semaphore, whatever their own ``limit``."""

    def __init__(self, limit, checker, key=None):
        self.checker = as_checker(checker)
        self.key = key if key is not None else id(self)
        with _limit_lock:
            if self.key not in _limit_semaphores:
                _limit_semaphores[self.key] = threading.Semaphore(limit)
            self.sem = _limit_semaphores[self.key]

    def check(self, test, hist, opts=None):
        with self.sem:
            return self.checker.check(test, hist, opts)


def concurrency_limit(limit, checker, key=None):
    return ConcurrencyLimit(limit, checker, key)
