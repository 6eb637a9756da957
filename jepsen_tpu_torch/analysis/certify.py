"""certify -- proof-carrying verdicts: static certification of every
linearizability result from its own artifacts (VC001-VC012), a copy of
the in-memory half of ``jepsen_tpu/analysis/certify.py`` and of its disk
path (``certify_run``).

A linearizability verdict is cheaply *certifiable* from a witness order
even when *finding* it is NP-hard: a claimed linearization is checked in
O(n) model steps ("Proving Linearizability Using Partial Orders", arxiv
1701.05463). Every verdict of the port's device search -- whose greedy
rollout is a hand-written CUDA kernel -- carries an independently
checked proof.

Three certification passes, all pure post-hoc reads of a result's
artifacts:

* **valid verdicts** -- replay the normalized witness
  (``result["witness"]``, checker/witness.py schema 1) through the CPU
  model step function: every transition legal from the model's init
  state (VC001), the order respects real-time precedence (VC002), every
  ok op linearized (VC003). Searchplan segment merges re-certify per
  segment against a replanned cut with seed pairs honored (VC007).
* **invalid verdicts** -- bounded cross-check of the reported failing
  segment through the CPU ``linear`` engine: a refutation is VC008;
  exhausting the budget is "unconfirmed" info (VC009), never fatal.
* **differential** -- sample N encoded segments and replay them through
  the port's device engine (``torch_wgl``, on the caller's device; its
  engine name stays "jax-wgl") vs ``linear`` vs ``wgl``; any
  definite-verdict divergence is VC010.

Containment: findings NEVER flip a verdict. The in-run hook
(``checker.core.certify_verdict``) wraps this module in try/except.
Every engine replay runs with the obs sinks suppressed (``_quiet_replay``),
so a certified check reports the same search series as an uncertified
one.

Code catalogue:
  VC001 error  illegal transition replaying a witness order
  VC002 error  witness order violates real-time precedence
  VC003 error  valid verdict but the witness misses ok op(s)
  VC004 error  witness verdict disagrees with the result's (flip)
  VC005 error  malformed witness (schema/rows/indices inconsistent)
  VC006 info   device-engine verdict carries no witness (drift)
  VC007 error  segment provenance/re-certification mismatch
  VC008 error  cross-check REFUTES the invalid verdict
  VC009 info   certification budget exhausted; claim unconfirmed
  VC010 error  differential divergence between engines
  VC011 info   differential sample undecided / partial coverage
  VC012 error  persisted certificate unreadable or disagreeing with the
               run's results.json (``certify_run``, over a run directory
               written by the port's ``store``; a txn-family certificate
               is re-certified from the run's history, where the JAX
               package reports VC012 on it: ROADMAP.md C.9)
  VC013 error  cycle witness does not replay through host-side
               dependency inference (txn family: missing edge, wrong
               edge type, or class/edge-composition mismatch;
               ``certify_cycle_witness``, ``certify_txn_verdict``)

``certify_monitor`` certifies a streaming monitor's violation from the
evidence it parked (both families); ``certify_campaign`` certifies a
deterministic sample of a campaign's cell run directories with
``certify_run`` (the campaign scheduler's finalize block).
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from .. import history as h
from ..history import INF_TIME
from ..xp import NP
from .diagnostics import ERROR, INFO, diag, severity_counts, to_json

logger = logging.getLogger(__name__)

#: certificate schema version
SCHEMA = 1

#: engines whose verdicts come off the device -- a missing witness on
#: a decided verdict here is the schema-drift tripwire (VC006); the
#: CPU engines and the polynomial fast paths legitimately emit none
DEVICE_ENGINES = ("jax-wgl", "jax-wgl-sharded")

#: differential segments sampled per run (test["certify"]["samples"])
DEFAULT_SAMPLES = 1

#: config budget for the bounded CPU cross-check and differential
#: replays (test["certify"]["budget"]); step budget is 50x it
DEFAULT_BUDGET = 100_000


def enabled(test):
    """Is verdict certification on for this test map? (default: yes;
    ``test["certify?"] = False`` opts out, ``analysis?`` gates every
    analyzer)."""
    return bool(isinstance(test, dict) and test.get("analysis?", True)
                and test.get("certify?", True) is not False)


def config(test):
    """The certify knobs a test map requests, defaults filled in."""
    raw = test.get("certify") if isinstance(test, dict) else None
    raw = raw if isinstance(raw, dict) else {}
    samples = raw.get("samples", DEFAULT_SAMPLES)
    budget = raw.get("budget", DEFAULT_BUDGET)
    if not isinstance(samples, int) or isinstance(samples, bool):
        samples = DEFAULT_SAMPLES
    if not isinstance(budget, int) or isinstance(budget, bool) \
            or budget <= 0:
        budget = DEFAULT_BUDGET
    return {"samples": samples, "budget": budget}


# ---------------------------------------------------------------------------
# witness replay: the O(n) certificate check

def _witness_diags(spec, e, init_state, w, verdict, checks, scope=""):
    """Certify ONE normalized witness against the encoded history it
    claims to cover: schema shape (VC005), verdict agreement (VC004),
    ok-op completeness for valid verdicts (VC003), then the replay --
    real-time precedence (VC002) and model-step legality (VC001) for
    every ordered row. Returns diagnostics; appends a check record."""
    loc = f"certificate.witness{scope}"
    name = f"witness{scope}"
    diags = []
    n = len(e)
    lin_rows = w.get("linearized_rows")
    rows_ok = isinstance(lin_rows, list) and all(
        isinstance(i, int) and not isinstance(i, bool) and 0 <= i < n
        for i in lin_rows)
    if w.get("schema") != SCHEMA or not rows_ok \
            or w.get("rows") != n or w.get("n_ok") != int(e.n_ok) \
            or len(set(lin_rows)) != len(lin_rows):
        diags.append(diag(
            "VC005", ERROR,
            "malformed witness: schema/rows/n_ok/row indices are "
            f"inconsistent with the encoded history ({n} row(s), "
            f"{int(e.n_ok)} ok)", loc,
            "a hand-edited or stale witness certifies nothing; "
            "regenerate the certificate by re-running the check"))
        checks.append({"name": name, "status": "malformed"})
        return diags
    if bool(w.get("verdict")) != (verdict is True):
        diags.append(diag(
            "VC004", ERROR,
            f"witness supports verdict {bool(w.get('verdict'))} but "
            f"the result records {verdict}: certificate and verdict "
            "have been flipped apart", loc,
            "one of the two was modified after the search decided; "
            "treat the verdict as untrusted"))
    is_ok = np.asarray(e.is_ok, bool)
    lin_set = set(lin_rows)
    if verdict is True:
        missing = [int(i) for i in np.flatnonzero(is_ok)
                   if int(i) not in lin_set]
        if missing:
            diags.append(diag(
                "VC003", ERROR,
                f"valid verdict but the witness linearizes only "
                f"{len(lin_set)} row(s); ok row(s) {missing[:8]} are "
                "missing -- the claimed proof does not cover the "
                "history", loc,
                "a valid verdict's witness must linearize every ok "
                "op"))
    order = w.get("order")
    if order is None:
        diags.append(diag(
            "VC009", INFO,
            "witness carries no replayable order (the final_path "
            "replay budget ran out when it was built); the "
            "linearized set stands unreplayed", loc))
        checks.append({"name": name, "status": "unreplayed"})
        return diags
    if not isinstance(order, list) or sorted(order) != sorted(lin_set):
        diags.append(diag(
            "VC005", ERROR,
            "malformed witness: order is not a permutation of "
            "linearized_rows", loc,
            "regenerate the certificate by re-running the check"))
        checks.append({"name": name, "status": "malformed"})
        return diags

    invoke = np.asarray(e.invoke_idx, np.int64)
    rets = np.asarray(e.return_idx, np.int64)
    f = np.asarray(e.f)
    args = np.asarray(e.args).reshape(n, -1)
    rvals = np.asarray(e.ret).reshape(n, -1)
    unlin = np.ones(n, bool)
    state = np.asarray(init_state, np.int32)
    for k, i in enumerate(order):
        r_min = int(rets[unlin].min()) if unlin.any() else INF_TIME
        if not int(invoke[i]) < r_min:
            diags.append(diag(
                "VC002", ERROR,
                f"witness order violates real-time precedence at step "
                f"{k}: row {i} invokes at index {int(invoke[i])} but "
                f"an unlinearized op already returned at {r_min} -- "
                "the claimed order linearizes an op after a "
                "real-time-earlier op completed", f"{loc}.order[{k}]",
                "no legal linearization can order these ops this way; "
                "the witness (or the history) was tampered with"))
            checks.append({"name": name, "status": "replay-failed",
                           "step": k})
            return diags
        state2, okt = spec.step(state, f[i], args[i], rvals[i], NP)
        if not bool(okt):
            diags.append(diag(
                "VC001", ERROR,
                f"witness order is not a legal linearization: the "
                f"model rejects row {i} at step {k} (illegal "
                "transition from the replayed state)",
                f"{loc}.order[{k}]",
                "the certificate's proof does not replay; treat the "
                "verdict as untrusted"))
            checks.append({"name": name, "status": "replay-failed",
                           "step": k})
            return diags
        state = np.asarray(state2, np.int32)
        unlin[i] = False
    checks.append({"name": name, "status": "replayed",
                   "steps": len(order)})
    return diags


# ---------------------------------------------------------------------------
# searchplan segment re-certification

def _segment_diags(spec, client_hist, result, min_seg, checks):
    """A planned (segment-merged) result re-certifies per segment: the
    cuts replan deterministically from the same history, so witness
    provenance (index/count/seed pair) must match exactly (VC007),
    and each segment witness replays against its own encoding."""
    sp = result.get("searchplan")
    wits = result.get("witnesses")
    if not isinstance(sp, dict) or not isinstance(wits, list):
        return []
    from . import searchplan
    diags = []
    segs, _info = searchplan.plan_segments(spec, client_hist, min_seg)
    if len(segs) != sp.get("segments") or len(wits) != len(segs):
        diags.append(diag(
            "VC007", ERROR,
            f"segment provenance inconsistent: the result merged "
            f"{sp.get('segments')} segment(s) carrying {len(wits)} "
            f"witness slot(s), but replanning the same history yields "
            f"{len(segs)}", "certificate.segments",
            "segmentation is deterministic -- a count mismatch means "
            "the history or the certificate changed after the check"))
        return diags
    verdict = result.get("valid")
    for i, (seg, w) in enumerate(zip(segs, wits)):
        if not isinstance(w, dict):
            checks.append({"name": f"witness.segment[{i}]",
                           "status": "absent"})
            continue
        prov = w.get("segment")
        if not (isinstance(prov, dict) and prov.get("index") == i
                and prov.get("count") == len(segs)
                and prov.get("seed") == seg.seed):
            diags.append(diag(
                "VC007", ERROR,
                f"segment {i} witness provenance does not match the "
                "replanned segment (index/count/seed pair)",
                f"certificate.segments[{i}]",
                "the seed pair is part of the proof: a segment "
                "certified under a different seed proves nothing "
                "about this cut"))
            continue
        # the segment's expected verdict: a valid merge requires every
        # segment valid; an invalid merge pins only the failing one
        claim = bool(w.get("verdict"))
        if verdict is True:
            expect = True
        elif verdict is False and i == sp.get("failed_segment"):
            expect = False
        else:
            expect = claim
        e_s, init_s = spec.encode(seg.events)
        diags += _witness_diags(spec, e_s, init_s, w, expect, checks,
                                scope=f".segment[{i}]")
    return diags


# ---------------------------------------------------------------------------
# invalid verdicts: bounded independent cross-check

def _quiet_replay(fn, *args, **kwargs):
    """Run an engine replay with the obs sinks suppressed for this
    context: certification re-searches are analysis overhead, and
    letting them bump wgl.searches / chunk counters would corrupt the
    run's own search accounting (one logical search per check)."""
    from .. import obs
    with obs.sink_scope(None, None):
        return fn(*args, **kwargs)


def _linear_check(spec, e, init_state, budget):
    from ..checker import linear
    return linear.check_encoded(spec, e, init_state,
                                max_configs=budget,
                                max_steps=50 * budget)


def _cross_check_diags(spec, client_hist, e, init_state, result,
                       min_seg, budget, checks,
                       engine_fn=_linear_check, cross_name="linear"):
    """Certify an invalid verdict's failing evidence by re-deciding it
    through an independent CPU engine under a budget: refuted = VC008
    error, budget exhausted = VC009 info (never fatal), confirmed =
    a check record."""
    diags = []
    target, scope = (e, init_state), "history"
    sp = result.get("searchplan")
    if isinstance(sp, dict) and isinstance(sp.get("failed_segment"),
                                           int):
        from . import searchplan
        segs, _ = searchplan.plan_segments(spec, client_hist, min_seg)
        i = sp["failed_segment"]
        if len(segs) == sp.get("segments") and 0 <= i < len(segs):
            target = spec.encode(segs[i].events)
            scope = f"segment {i}"
        # count mismatches fall back to the whole history; the
        # segment pass reports VC007 for them
    et, it = target
    r = _quiet_replay(engine_fn, spec, et, it, budget)
    v = r.get("valid")
    if v is True:
        diags.append(diag(
            "VC008", ERROR,
            f"cross-check REFUTES the invalid verdict: the "
            f"{cross_name} engine linearizes the reported failing "
            f"{scope} ({int(r.get('configs_explored') or 0)} "
            "config(s) explored)", "certificate.cross-check",
            "one of the two engines mis-decided; treat the recorded "
            "verdict as untrusted and rerun with confirm"))
        checks.append({"name": "cross-check", "status": "refuted",
                       "engine": cross_name, "scope": scope})
    elif v is False:
        checks.append({"name": "cross-check", "status": "confirmed",
                       "engine": cross_name, "scope": scope,
                       "configs": int(r.get("configs_explored") or 0)})
    else:
        diags.append(diag(
            "VC009", INFO,
            f"cross-check of the failing {scope} exhausted its budget "
            f"({r.get('error')}); the invalid verdict stands "
            "unconfirmed", "certificate.cross-check",
            "raise test['certify']['budget'] to push the bounded "
            "re-decision further"))
        checks.append({"name": "cross-check", "status": "unconfirmed",
                       "engine": cross_name, "scope": scope})
    return diags


# ---------------------------------------------------------------------------
# differential harness: the miscompilation tripwire

def _diff_device(spec, e, init_state, budget, device=None):
    from ..checker import torch_wgl
    return torch_wgl.check_encoded(spec, e, init_state, device=device)


def _diff_linear(spec, e, init_state, budget, device=None):
    return _linear_check(spec, e, init_state, budget)


def _diff_wgl(spec, e, init_state, budget, device=None):
    from ..checker import wgl
    return wgl.check_encoded(spec, e, init_state, max_configs=budget)


#: engine table the differential harness replays through; module-level
#: so tests can seed a lying engine and assert VC010 fires
DIFF_ENGINES = {"jax-wgl": _diff_device, "linear": _diff_linear,
                "wgl": _diff_wgl}


def _differential_diags(spec, client_hist, result, samples, budget,
                        min_seg, checks, device=None):
    """Sample encoded segments deterministically (largest first -- no
    RNG, no clock: certificates stay byte-identical across reruns)
    and replay each through the engine table. Definite verdicts must
    agree (VC010); undecided engines degrade coverage (VC011)."""
    from . import searchplan
    diags = []
    engines = ["linear", "wgl"]
    if result.get("engine") in DEVICE_ENGINES:
        # only results that came off the device pay for a device
        # replay; CPU-won results cross CPU engines only
        engines.insert(0, "jax-wgl")
    segs, _ = searchplan.plan_segments(spec, client_hist, min_seg)
    if not segs:
        return diags
    k = max(0, min(int(samples), len(segs)))
    chosen = sorted(sorted(range(len(segs)),
                           key=lambda i: (-segs[i].rows, i))[:k])
    for i in chosen:
        e_s, init_s = spec.encode(segs[i].events)
        got = {}
        for nm in engines:
            try:
                got[nm] = _quiet_replay(DIFF_ENGINES[nm], spec, e_s,
                                        init_s, budget,
                                        device=device).get("valid")
            except Exception:  # noqa: BLE001 - coverage note, not fatal
                logger.warning("differential engine %s crashed", nm,
                               exc_info=True)
                got[nm] = "unknown"
        definite = {nm: v for nm, v in got.items()
                    if v in (True, False)}
        if len(segs) == 1 and result.get("valid") in (True, False):
            # a single-segment sample covers the whole history: the
            # recorded verdict is one more engine output to agree with
            definite["recorded"] = result["valid"]
        if len(set(definite.values())) > 1:
            diags.append(diag(
                "VC010", ERROR,
                f"differential divergence on segment {i}: "
                f"{definite} -- the engines disagree on the same "
                "encoded input (miscompilation tripwire)",
                f"certificate.differential[{i}]",
                "rerun the device engine with confirm=True and bisect "
                "the kernel change that split the verdicts"))
        undecided = [nm for nm in got if got[nm] not in (True, False)]
        if undecided:
            diags.append(diag(
                "VC011", INFO,
                f"differential sample {i}: engine(s) {undecided} "
                "undecided within budget; coverage is partial",
                f"certificate.differential[{i}]"))
        checks.append({"name": "differential", "segment": i,
                       "rows": segs[i].rows,
                       "verdicts": {nm: (v if v in (True, False)
                                         else "unknown")
                                    for nm, v in got.items()}})
    return diags


# ---------------------------------------------------------------------------
# main entry: certify one result

def certify_with_diagnostics(spec, client_hist, result, test=None,
                             samples=DEFAULT_SAMPLES,
                             budget=DEFAULT_BUDGET, init_ops=None,
                             differential=True, key=None, device=None):
    """Certify one Linearizable result against its (already
    init-op-prepared) client history. Returns ``(certificate,
    diagnostics)``: the certificate is a byte-deterministic dict -- it
    carries the witness (the proof), the checks that ran, the findings,
    and the context needed to re-certify it later. ``key``: the independent-workload key the
    history was split on, recorded so the disk path can re-derive the
    same subhistory. ``device``: where the differential's device-engine
    replay runs (None means CUDA, as every entry point of the port)."""
    from . import searchplan
    min_seg = searchplan.min_segment(test)
    checks = []
    diags = []
    e, init_state = spec.encode(client_hist)
    verdict = result.get("valid") if isinstance(result, dict) else None
    w = result.get("witness") if isinstance(result, dict) else None
    wits = result.get("witnesses") if isinstance(result, dict) else None
    engine = result.get("engine") if isinstance(result, dict) else None

    if verdict in (True, False):
        if isinstance(w, dict) and w.get("segment") is None:
            diags += _witness_diags(spec, e, init_state, w, verdict,
                                    checks)
        elif not isinstance(w, dict) and not isinstance(wits, list):
            if engine in DEVICE_ENGINES:
                diags.append(diag(
                    "VC006", INFO,
                    f"device engine {engine} decided {verdict} but "
                    "attached no normalized witness (schema drift?); "
                    "nothing to replay", "certificate.witness",
                    "every device engine emits result['witness'] "
                    "since witness schema 1 -- look for a path still "
                    "returning the old result shape"))
                checks.append({"name": "witness", "status": "absent"})
            else:
                # CPU engines / polynomial fast paths legitimately
                # carry no replayable witness: a note, not a finding
                checks.append({
                    "name": "witness", "status": "absent",
                    "detail": f"engine {engine or 'fast-path'} emits "
                              "no replayable witness"})
        diags += _segment_diags(spec, client_hist, result, min_seg,
                                checks)
        if verdict is False:
            diags += _cross_check_diags(spec, client_hist, e,
                                        init_state, result, min_seg,
                                        budget, checks)
        if differential and samples > 0:
            diags += _differential_diags(spec, client_hist, result,
                                         samples, budget, min_seg,
                                         checks, device)
    else:
        checks.append({"name": "verdict", "status": "skipped",
                       "detail": f"verdict {verdict!r}: an undecided "
                                 "result certifies nothing"})

    cert = {"schema": SCHEMA,
            "model": str(spec.name),
            "engine": engine,
            "verdict": verdict,
            "rows": int(len(e)),
            "n_ok": int(e.n_ok),
            "witness": w if isinstance(w, dict) else None,
            "witnesses": wits if isinstance(wits, list) else None,
            "searchplan": (result.get("searchplan")
                           if isinstance(result, dict) else None),
            "context": {"model": str(spec.name),
                        "init_ops": list(init_ops or []),
                        "min_segment": min_seg,
                        "samples": int(samples),
                        "budget": int(budget),
                        "key": key},
            "checks": checks}
    rep = to_json(diags)
    cert["diagnostics"] = rep["diagnostics"]
    cert["counts"] = rep["counts"]
    return cert, diags


# ---------------------------------------------------------------------------
# cycle-family (txn) witnesses: replay the implicated cycle host-side

#: per-class edge-composition rules (base names; -realtime/-process
#: variants additionally require >=1 edge of the extending type)
_CYCLE_RULES = {
    "G0": {"allowed": {"ww"}, "rw": (0, 0)},
    "G1c": {"allowed": {"ww", "wr"}, "require": "wr", "rw": (0, 0)},
    "G-single": {"allowed": {"ww", "wr", "rw"}, "rw": (1, 1)},
    "G2": {"allowed": {"ww", "wr", "rw"}, "rw": (2, None)},
}


def _txn_graph(history, workload, opts):
    """Re-infer the dependency graph the verdict claims to come from."""
    from ..cycle import DEFAULT_ANOMALIES
    opts = dict(opts or {})
    if workload == "wr":
        from ..cycle import wr as engine
        graph, _found, oks, _garbage = engine.infer(list(history), opts)
        return graph, oks
    from ..cycle import append as engine
    graph, _found, oks = engine.infer(
        list(history),
        tuple(opts.get("anomalies", DEFAULT_ANOMALIES)),
        opts.get("realtime", True), opts.get("process", False),
        opts.get("skew-bound", opts.get("skew_bound", 0)))
    return graph, oks


def certify_cycle_witness(result, history, workload="append", opts=None,
                          checks=None):
    """Certify a cycle-family (txn) verdict's witnesses: re-run the
    host-side dependency inference over the history and replay every
    implicated cycle through the re-inferred graph -- each claimed edge
    must exist with its claimed type bits, and the cycle's edge
    composition must match its anomaly class (G0 ww-only, G1c >=1 wr,
    G-single exactly 1 rw, G2 >=2 rw; *-realtime/-process need an edge
    of the extending type). Any mismatch is VC013. Returns
    diagnostics; appends per-witness check records.

    An edge can carry several types at once (``ww+wr+rw``): such an
    edge serves the class as any one of them, as the classifier uses it
    (a G-single's return path runs over ww/wr edges, whatever rw bits
    they also carry). The JAX package counts every edge carrying rw as
    an anti-dependency and every type of an edge against the class, so
    it reports VC013 on such valid witnesses (ROADMAP.md C.6)."""
    diags = []
    checks = checks if checks is not None else []
    anomalies = (result or {}).get("anomalies")
    wits = [(cls, w) for cls, ws in (anomalies or {}).items()
            if isinstance(ws, list)
            for w in ws
            if isinstance(w, dict) and isinstance(w.get("steps"), list)]
    if not wits:
        checks.append({"name": "cycle-witness", "status": "skipped",
                       "detail": "no cycle witnesses in the result"})
        return diags
    try:
        graph, oks = _txn_graph(history, workload, opts)
    except Exception as exc:  # noqa: BLE001 - reported, never raised
        diags.append(diag(
            "VC013", ERROR,
            f"cycle-witness replay inference crashed: {exc!r}",
            location="certificate.cycle_witness",
            fix_hint="the history artifact no longer matches the "
                     "verdict; re-run the offline checker"))
        checks.append({"name": "cycle-witness", "status": "failed",
                       "detail": repr(exc)})
        return diags
    for cls, w in wits:
        loc = f"certificate.cycle_witness[{cls}]"
        problems = []
        base = cls.replace("-realtime", "").replace("-process", "")
        rule = _CYCLE_RULES.get(base)
        seen_types = set()
        edge_types = []
        for step in w["steps"]:
            a, b = step.get("from"), step.get("to")
            claimed = set(str(step.get("type", "")).split("+")) - {""}
            if not (isinstance(a, int) and isinstance(b, int)
                    and 0 <= a < graph.n and 0 <= b < graph.n):
                problems.append(f"edge {a}->{b} indexes outside the "
                                f"{graph.n}-txn graph")
                continue
            from ..cycle import edge_name
            actual = set(edge_name(int(graph.adj[a, b])).split("+"))
            if int(graph.adj[a, b]) == 0 or not claimed <= actual:
                problems.append(
                    f"edge {a}->{b} claimed {'+'.join(sorted(claimed))}"
                    f" but re-inference found "
                    f"{'+'.join(sorted(actual)) if graph.adj[a, b] else 'no edge'}")
                continue
            seen_types |= claimed
            edge_types.append(claimed)
        if rule is not None and not problems:
            lo, hi = rule["rw"]
            usable = rule["allowed"] | {"rt", "process"}
            # the non-rw types this class's paths run over: an rw edge
            # that also has one may serve as it
            other = (rule["allowed"] - {"rw"}) \
                | ({"rt"} if cls.endswith("-realtime") else set()) \
                | ({"process"} if cls.endswith("-process") else set())
            rw_edges = sum("rw" in t and not t & other for t in edge_types)
            rw_most = sum("rw" in t for t in edge_types)
            if base in ("G0", "G1c") \
                    and any(not t & usable for t in edge_types):
                problems.append(
                    f"{cls}: cycle uses edge types "
                    f"{sorted(seen_types)} outside the class")
            if rule.get("require") and rule["require"] not in seen_types:
                problems.append(f"{cls}: no {rule['require']} edge in "
                                "the witness")
            if rw_most < lo or (hi is not None and rw_edges > hi):
                n_rw = rw_most if rw_most < lo else rw_edges
                problems.append(f"{cls}: witness has {n_rw} rw "
                                f"edge(s), class requires "
                                f"[{lo}, {hi if hi is not None else 'inf'}]")
            if cls.endswith("-realtime") and "rt" not in seen_types:
                problems.append(f"{cls}: no rt edge in the witness")
            if cls.endswith("-process") and "process" not in seen_types:
                problems.append(f"{cls}: no process edge in the witness")
        if problems:
            diags.append(diag(
                "VC013", ERROR,
                f"cycle witness for {cls} does not replay: "
                + "; ".join(problems),
                location=loc,
                fix_hint="the verdict's witness disagrees with "
                         "host-side re-inference over the same "
                         "history; treat the verdict as suspect"))
            checks.append({"name": "cycle-witness", "class": cls,
                           "status": "failed",
                           "detail": "; ".join(problems)})
        else:
            checks.append({"name": "cycle-witness", "class": cls,
                           "status": "confirmed",
                           "edges": len(w["steps"])})
    return diags


def certify_txn_verdict(test, hist, result, workload="append",
                        opts=None):
    """In-run hook for cycle-family verdicts (the FnChecker wrapper in
    tests/cycle calls it after analysis): replay every cycle witness
    host-side, land findings in ``test["analysis"]["certify"]`` and
    the proof in ``test["certificate"]`` (persisted as
    certificate.json). Contained exactly like certify_verdict: a
    certifier bug must NEVER flip a verdict or exit code. The
    certificate's ``opts`` leave out ``device`` (where the checker's
    closures ran), so it equals the JAX package's."""
    if not isinstance(test, dict) or not isinstance(result, dict) \
            or result.get("valid") not in (True, False):
        return
    try:
        if not enabled(test):
            return
        if test.get("certify-done?"):
            return
        test["certify-done?"] = True
        from .. import analysis
        checks = []

        def build():
            return certify_cycle_witness(result, hist, workload, opts,
                                         checks=checks)

        diags = analysis.run_analyzer("certify-txn", build)
        rep = to_json(diags)
        cert = {"schema": SCHEMA,
                "family": "txn",
                "model": f"txn-{workload}",
                "engine": f"txn-{workload}",
                "verdict": result.get("valid"),
                "anomaly_types": list(result.get("anomaly_types")
                                      or ()),
                "context": {"workload": workload,
                            "opts": {k: v for k, v in (opts or {}).items()
                                     if k != "device"}},
                "checks": checks,
                "diagnostics": rep["diagnostics"],
                "counts": rep["counts"]}
        report = to_json(diags)
        report["summary"] = {"verdict": cert["verdict"],
                             "engine": cert["engine"],
                             "checks": checks}
        test.setdefault("analysis", {})["certify"] = report
        test["certificate"] = cert
        errs = analysis.errors(diags)
        if errs:
            logger.warning(
                "%s", analysis.render_text(
                    errs, title="cycle-witness certification FAILED; "
                                "the verdict above does not replay "
                                "from its own witness:"))
    except Exception:  # noqa: BLE001 - contained, never verdict-bearing
        logger.warning("txn verdict certification crashed",
                       exc_info=True)


# ---------------------------------------------------------------------------
# monitor backstop: certify a violation's parked evidence

def certify_monitor(evidence, budget=DEFAULT_BUDGET):
    """Certify a monitor violation from the evidence the monitor
    parked at detection time (the encoded prefix + the engine result
    that decided False): replay its witness, then cross-check the
    same prefix through an independent CPU engine. This is the
    backstop the ``skip-offline?`` handoff never had -- the monitor's
    word becomes the verdict of record there, so its False must be
    independently confirmable. Returns ``(summary, diagnostics)``;
    the summary is JSON-able. Txn-family evidence (the streaming cycle
    monitor) replays the implicated cycle host-side instead (VC013)."""
    if evidence.get("family") == "txn":
        checks = []
        diags = certify_cycle_witness(
            evidence.get("result") or {}, evidence.get("history") or [],
            evidence.get("workload", "append"), evidence.get("opts"),
            checks=checks)
        rep = to_json(diags)
        confirmed = any(c.get("name") == "cycle-witness"
                        and c.get("status") == "confirmed"
                        for c in checks)
        return {"schema": SCHEMA, "verdict": False, "family": "txn",
                "engine": f"txn-{evidence.get('workload', 'append')}",
                "key": None,
                "rows": len(evidence.get("history") or []),
                "confirmed": confirmed, "checks": checks,
                "diagnostics": rep["diagnostics"],
                "counts": rep["counts"]}, diags
    spec = evidence["spec"]
    e = evidence["e"]
    init_state = evidence["init_state"]
    r = evidence.get("result") or {}
    checks = []
    diags = []
    w = r.get("witness")
    if isinstance(w, dict) and w.get("segment") is None:
        diags += _witness_diags(spec, e, init_state, w, False, checks)
    # independence: a monitor that decided on the CPU linear engine
    # cross-checks through the WGL oracle instead of itself
    if r.get("engine") == "linear":
        def engine_fn(spec, e, init_state, budget):
            from ..checker import wgl
            return wgl.check_encoded(spec, e, init_state,
                                     max_configs=budget)
        cross = "wgl"
    else:
        engine_fn, cross = _linear_check, "linear"
    diags += _cross_check_diags(spec, None, e, init_state,
                                {"valid": False}, 0, budget, checks,
                                engine_fn=engine_fn, cross_name=cross)
    rep = to_json(diags)
    confirmed = any(c.get("name") == "cross-check"
                    and c.get("status") == "confirmed" for c in checks)
    return {"schema": SCHEMA, "verdict": False,
            "engine": r.get("engine"),
            "key": repr(evidence.get("key"))
            if evidence.get("key") is not None else None,
            "rows": int(len(e)), "confirmed": confirmed,
            "checks": checks, "diagnostics": rep["diagnostics"],
            "counts": rep["counts"]}, diags


# ---------------------------------------------------------------------------
# disk path: certify an existing run directory from its artifacts

def _load_json(run_dir, name):
    try:
        with open(os.path.join(run_dir, name)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except Exception:  # noqa: BLE001 - unreadable, reported as VC012
        return "unreadable"


def _load_run_history(run_dir):
    """history.jsonl (journal fallback, torn last line dropped) --
    mirrors store.load_history without needing a test map."""
    for name in ("history.jsonl", "history.jsonl.journal"):
        p = os.path.join(run_dir, name)
        if not os.path.exists(p):
            continue
        hist = []
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    hist.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return hist
    return []


def _sub_keyed(hist, key):
    """``independent.subhistory`` over a RELOADED history: ``[k v]``
    tuples come back from history.jsonl as plain 2-lists, so match both
    the live Tuple and the JSON shape. Un-keyed ops (nemesis, logging)
    appear in every subhistory, like the reference."""
    from ..independent import is_tuple
    out = []
    for op in hist:
        v = op.get("value")
        if is_tuple(v):
            if v.key == key:
                out.append(dict(op, value=v.value))
        elif isinstance(v, list) and len(v) == 2:
            if v[0] == key:
                out.append(dict(op, value=v[1]))
        else:
            out.append(op)
    return out


def find_linearizable_result(results):
    """The Linearizable sub-result inside a (possibly composed) results
    map: the dict carrying ``valid?`` (the gate stamps it), preferring
    one with a witness."""
    found = []

    def walk(x):
        if isinstance(x, dict):
            if "valid?" in x:
                found.append(x)
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(results)
    for r in found:
        if isinstance(r.get("witness"), dict) \
                or isinstance(r.get("witnesses"), list):
            return r
    return found[0] if found else None


def _keyed_result(results, key):
    """The certified key's own sub-result inside a keyed (independent)
    results map, wherever the composed checker tree nested it -- JSON
    object keys are strings, so match both the live and the reloaded
    key."""
    hits = []

    def walk(x):
        if isinstance(x, dict):
            rs = x.get("results")
            if isinstance(rs, dict):
                for kk in (key, str(key)):
                    r = rs.get(kk)
                    if isinstance(r, dict):
                        hits.append(r)
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(results)
    for r in hits:
        if "valid?" not in r:
            # Compose-shaped inner: the Linearizable leg carries valid?
            r = find_linearizable_result(r) or r
        if isinstance(r, dict) and r.get("valid") in (True, False):
            return r
    return None


def find_txn_result(results):
    """The cycle checker's sub-result inside a (possibly composed)
    results map: the first decided dict carrying ``anomaly_types``,
    outside the monitor's summary."""
    def walk(x):
        if isinstance(x, dict):
            if "anomaly_types" in x and x.get("valid") in (True, False) \
                    and "family" not in x:
                return x
            for k, v in x.items():
                if k != "monitor":
                    r = walk(v)
                    if r is not None:
                        return r
        return None

    return walk(results)


def _certify_txn_run(run_dir, results, cert, summary):
    """``certify_run`` for a txn-family certificate (``certify_txn_verdict``
    wrote it): the certificate's verdict and anomaly classes must equal
    the run's results.json (VC012), and every cycle witness of the
    persisted result replays through host-side inference over the
    persisted history (VC013). The JAX package looks the certificate's
    ``txn-<workload>`` model up among the linearizability models and
    reports VC012 on every txn run (ROADMAP.md C.9)."""
    diags = []
    where = os.path.join(run_dir, "certificate.json")
    ctx = cert.get("context") or {}
    txn = find_txn_result(results)
    rv = txn.get("valid") if txn is not None else results.get("valid")
    if cert.get("verdict") != rv:
        diags.append(diag(
            "VC012", ERROR,
            f"certificate.json records verdict {cert.get('verdict')!r} "
            f"but results.json says {rv!r}: the persisted certificate "
            "disagrees with the run's results", where,
            "one of the two artifacts was modified after the run"))
    elif txn is not None and sorted(cert.get("anomaly_types") or []) \
            != sorted(txn.get("anomaly_types") or []):
        diags.append(diag(
            "VC012", ERROR,
            f"certificate.json records anomaly classes "
            f"{sorted(cert.get('anomaly_types') or [])} but results.json "
            f"says {sorted(txn.get('anomaly_types') or [])}", where,
            "one of the two artifacts was modified after the run"))
    checks = []
    hist = h.ensure_indexed(_load_run_history(run_dir))
    diags += certify_cycle_witness(txn or {}, hist,
                                   ctx.get("workload") or "append",
                                   ctx.get("opts"), checks=checks)
    summary.update(certified=True, verdict=rv, model=cert.get("model"),
                   engine=cert.get("engine"), checks=checks)
    return diags


def certify_run(run_dir, budget=None, samples=0, device=None):
    """Certify an existing run directory purely from its persisted
    artifacts: replay certificate.json's witness against the re-encoded
    history.jsonl and cross-check it against results.json (VC012 when
    they disagree or the certificate is unreadable). ``samples``
    defaults to 0 on disk -- the differential replays are an in-run
    concern; pass a positive count to rerun them (their device replay
    runs on ``device``, None meaning CUDA). Returns ``(summary,
    diagnostics)``; summary is None when the directory has no readable
    results.json."""
    diags = []
    results = _load_json(run_dir, "results.json")
    if results == "unreadable" or not isinstance(results, dict):
        if results == "unreadable":
            diags.append(diag(
                "VC012", ERROR, "results.json is unreadable; nothing "
                "to certify against", os.path.join(run_dir,
                                                   "results.json")))
        return None, diags
    cert = _load_json(run_dir, "certificate.json")
    summary = {"run": run_dir, "certified": False}
    if cert == "unreadable":
        diags.append(diag(
            "VC012", ERROR,
            "certificate.json is unreadable (corrupt JSON): the "
            "persisted proof cannot certify this run",
            os.path.join(run_dir, "certificate.json"),
            "regenerate by re-running the test, or delete the "
            "corrupt file"))
    elif cert is None:
        summary["checks"] = [{"name": "certificate",
                              "status": "absent"}]
    elif cert.get("family") == "txn":
        diags += _certify_txn_run(run_dir, results, cert, summary)
    else:
        ctx = cert.get("context") or {}
        lin_result = _keyed_result(results, ctx["key"]) \
            if ctx.get("key") is not None else None
        if lin_result is None:
            lin_result = find_linearizable_result(results)
        rv = lin_result.get("valid") if isinstance(lin_result, dict) \
            else results.get("valid")
        if cert.get("verdict") != rv:
            diags.append(diag(
                "VC012", ERROR,
                f"certificate.json records verdict "
                f"{cert.get('verdict')!r} but results.json says "
                f"{rv!r}: the persisted certificate disagrees with "
                "the run's results",
                os.path.join(run_dir, "certificate.json"),
                "one of the two artifacts was modified after the "
                "run"))
        model = ctx.get("model") or cert.get("model")
        try:
            from ..models import base as mbase
            spec = mbase.model_spec(model)
        except Exception:  # noqa: BLE001 - unknown/renamed model
            diags.append(diag(
                "VC012", ERROR,
                f"certificate names unknown model {model!r}; the "
                "history cannot be re-encoded for replay",
                os.path.join(run_dir, "certificate.json")))
            spec = None
        if spec is not None:
            from ..checker.checkers import Linearizable
            lin = Linearizable(spec, init_ops=ctx.get("init_ops"))
            hist = h.ensure_indexed(_load_run_history(run_dir))
            if ctx.get("key") is not None:
                # keyed run: the certificate proves ONE key's verdict
                hist = _sub_keyed(hist, ctx["key"])
            client = lin.prepare_history(h.client_ops(hist))
            # re-certify the PERSISTED proof (not the result's): a
            # tampered certificate must fail its own replay
            replay = {"valid": rv, "engine": cert.get("engine"),
                      "witness": cert.get("witness"),
                      "witnesses": cert.get("witnesses"),
                      "searchplan": cert.get("searchplan")}
            test = {"searchplan-min-segment": ctx.get("min_segment")} \
                if ctx.get("min_segment") else None
            fresh, fdiags = certify_with_diagnostics(
                spec, client, replay, test=test, samples=samples,
                budget=budget or ctx.get("budget") or DEFAULT_BUDGET,
                init_ops=ctx.get("init_ops"),
                differential=samples > 0, key=ctx.get("key"),
                device=device)
            diags += fdiags
            summary.update(certified=True, verdict=rv,
                           model=str(spec.name),
                           engine=cert.get("engine"),
                           checks=fresh["checks"])
    rep = to_json(diags)
    summary["diagnostics"] = rep["diagnostics"]
    summary["counts"] = rep["counts"]
    return summary, diags


# ---------------------------------------------------------------------------
# campaign fold: sampled certification over cells

def certify_campaign(records, sample=4, budget=None, device=None):
    """Certify a deterministic sample of a campaign's cell run dirs
    (largest-coverage-first would need loading every run, so the
    sample is evenly spaced over the sorted path list). Returns the
    ``report.json["certification"]`` block (reference
    ``jepsen_tpu/analysis/certify.py:978-1015``). ``device`` goes to
    ``certify_run``, which touches no device at its default of 0
    differential samples."""
    paths = sorted({r.get("path") for r in (records or [])
                    if isinstance(r, dict) and r.get("path")
                    and os.path.isdir(str(r.get("path")))})
    k = max(0, min(int(sample), len(paths)))
    if k and len(paths) > 1 and k > 1:
        chosen = sorted({paths[int(round(j * (len(paths) - 1)
                                         / (k - 1)))]
                         for j in range(k)})
    else:
        chosen = paths[:k]
    runs = []
    totals = severity_counts([])
    codes = {}
    for p in chosen:
        try:
            summary, diags = certify_run(p, budget=budget, device=device)
        except Exception:  # noqa: BLE001 - one bad run dir != no report
            logger.warning("certifying %s crashed", p, exc_info=True)
            continue
        c = severity_counts(diags)
        for s in c:
            totals[s] += c[s]
        for d in diags:
            codes[d.code] = codes.get(d.code, 0) + 1
        runs.append({"path": p,
                     "certified": bool(summary
                                       and summary.get("certified")),
                     "counts": c,
                     "codes": sorted({d.code for d in diags})})
    return {"sampled": len(runs), "of": len(paths), "counts": totals,
            "codes": dict(sorted(codes.items())), "runs": runs}
