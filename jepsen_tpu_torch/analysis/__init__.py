"""Static analyses over histories and verdicts (the part of
``jepsen_tpu.analysis`` the port runs):

* **histlint** -- history well-formedness (the linearizability
  checkers' preconditions), over event lists and EncodedHistory
  tensors. ``checker.core.check`` runs it once per test map before the
  checkers (opt out with ``test["analysis?"] = False``); the findings
  land in ``test["analysis"]["history"]``, which ``store`` persists as
  analysis.json.
* **searchplan** -- search planning: sealed quiescent cuts slice one
  history into sequential segments that are checked in isolation
  (``checker.checkers.Linearizable``, the ``independent`` checker), the
  segment results merge back into one verdict, and ``build_plan``
  reports the plan of record (partition predicates, cuts, elisions, SP
  codes and JX007 from ``shapelint``) into
  ``test["analysis"]["searchplan"]`` once per test map
  (``checker.core.plan_history``; opt out with ``test["searchplan?"] =
  False``).
* **certify** -- proof-carrying verdicts: every decided Linearizable
  verdict is certified from its own artifacts (VC001-VC012): valid
  verdicts replay their witness through the CPU model step, invalid ones
  are cross-checked by an independent CPU engine, and a sampled
  differential replays a segment through the port's device engine and
  the two CPU engines. ``checker.core.check`` runs it (opt out with
  ``test["certify?"] = False``); ``certify_run`` re-certifies a run
  directory written by ``store`` from its artifacts (VC012), and
  ``certify_campaign`` a deterministic sample of a campaign's runs.
* **planlint** -- pre-flight validation of a test map before any node
  contact (``core.run``'s preflight phase; fatal codes raise
  ``PlanLintError``), and the knob passes the campaign command runs on
  every invocation: PL012 (the sweep matrix), PL018 (fleetlint), PL020
  (coalescing) and PL024 (coordinator HA), with PL014 (the fleet's
  config) under fleet knobs and the service lint (PL016) under
  ``--serve`` or fleet knobs, and before ``serve`` binds its socket;
  the capacity pass (PL021) with the capacity planner.
* **sizemodel** / **capplan** -- whole-campaign static capacity
  planning: every plan shape, device-memory footprint and int32-wall
  crossing a campaign will produce, predicted from the matrix and the
  ModelSpecs before anything runs (CP001-CP008, ``capacity_plan.json``),
  and after the run the prediction oracle in ``report.json["capacity"]``.
* **codelint** -- an AST pass over the port's own source flagging
  unsynchronized mutation of shared state reachable from threaded paths
  (CL001-CL004); ``python -m jepsen_tpu_torch.lint`` drives it.
* **fleetmodel** / **fleetlint** -- the campaign control plane's
  recorded history (``campaign.json``, ``cells.jsonl``, per-run traces)
  replayed against its protocol's invariants (FL001-FL016) into
  ``fleet_analysis.json``; ``preflight`` is the subset ``--resume``
  runs before trusting a journal.

All report through one ``Diagnostic`` model and its renderers. jaxlint's
tracing checks do not apply to torch; its JX007 is ``shapelint``.
"""

from . import (capplan, certify, codelint, fleetlint,  # noqa: F401
               fleetmodel, histlint, planlint, searchplan, shapelint,
               sizemodel)
from .diagnostics import (Diagnostic, ERROR, INFO,  # noqa: F401
                          SEVERITIES, WARNING, diag, errors,
                          max_severity, render_text, run_analyzer,
                          severity_counts, to_json, warnings)
from .histlint import (lint_encoded, lint_history,  # noqa: F401
                       lint_test_history, model_op_set)
from .planlint import PlanLintError, lint_plan, preflight  # noqa: F401

__all__ = [
    "Diagnostic", "ERROR", "WARNING", "INFO", "SEVERITIES", "diag",
    "errors", "warnings", "max_severity", "severity_counts",
    "render_text", "to_json", "run_analyzer",
    "histlint", "planlint", "searchplan", "shapelint", "certify",
    "fleetlint", "fleetmodel", "capplan", "codelint", "sizemodel",
    "lint_history", "lint_encoded", "lint_test_history", "model_op_set",
    "lint_plan", "preflight", "PlanLintError",
]
