"""Checker protocol + combinators (reference jepsen/src/jepsen/checker.clj).

A checker examines a history and returns a map with a ``valid`` key:
True, False, or "unknown" (couldn't decide). Validity merges with
False > "unknown" > True (checker.clj:29-50).

The part of ``jepsen_tpu.checker.core`` the port needs: validity merging,
the checker protocol and its combinators, and ``check``, which certifies
a decided Linearizable verdict after the checker returns
(``certify_verdict``, ``analysis/certify.py``), and ``check_safe``,
which traces every (sub)checker run. The history lint and the plan
report of record that ``jepsen_tpu.checker.core.check`` also runs
(``lint_history``, ``plan_history``) wait for the host harness
(ROADMAP.md A.11(a)).
"""

from __future__ import annotations

import logging
import threading
import traceback

from .. import history as h
from .. import obs
from ..util import real_pmap

__all__ = ["Checker", "check", "check_safe", "compose", "noop",
           "unbridled_optimism", "merge_valid", "valid_prio",
           "certify_verdict"]

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


_certify_lock = threading.Lock()


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
        with _certify_lock:
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
                device=checker.engine_opts.get("device"))
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
    """Run a checker over an indexed history, then certify its verdict
    (``certify_verdict``)."""
    hist = h.ensure_indexed(hist)
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
