"""certify -- proof-carrying verdicts: static certification of every
linearizability result from its own artifacts (VC001-VC011), a copy of
the in-memory half of ``jepsen_tpu/analysis/certify.py``.

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

VC012 (a persisted certificate against a run directory, ``certify_run``)
and VC013 (txn cycle witnesses) wait for the store and the txn
certifier of the host harness (ROADMAP.md queue A.11), as do the
monitor and campaign entry points.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import history as h
from ..history import INF_TIME
from ..xp import NP
from .diagnostics import ERROR, INFO, diag, to_json

logger = logging.getLogger(__name__)

#: certificate schema version
SCHEMA = 1

#: engines whose verdicts come off the device -- a missing witness on
#: a decided verdict here is the schema-drift tripwire (VC006); the
#: CPU engines and the polynomial fast paths legitimately emit none
DEVICE_ENGINES = ("jax-wgl",)

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

