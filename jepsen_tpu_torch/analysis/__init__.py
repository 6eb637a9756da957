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
  config) under fleet knobs. The service lint (PL016) comes with the
  service (ROADMAP.md A.11(d4)), the capacity pass with the planner
  (A.11(d5)).
* **fleetmodel** / **fleetlint** -- the campaign control plane's
  recorded history (``campaign.json``, ``cells.jsonl``, per-run traces)
  replayed against its protocol's invariants (FL001-FL016) into
  ``fleet_analysis.json``; ``preflight`` is the subset ``--resume``
  runs before trusting a journal.

All report through one ``Diagnostic`` model and its renderers. The other
lint analyzers (jaxlint's tracing checks, which do not apply to torch;
codelint and capplan) wait for ROADMAP.md A.11(d5).
"""

from . import (certify, fleetlint, fleetmodel,  # noqa: F401
               histlint, planlint, searchplan, shapelint)
from .diagnostics import (Diagnostic, ERROR, INFO,  # noqa: F401
                          SEVERITIES, WARNING, diag, errors, render_text,
                          run_analyzer, severity_counts, to_json)
from .histlint import (lint_encoded, lint_history,  # noqa: F401
                       lint_test_history, model_op_set)
from .planlint import PlanLintError, lint_plan, preflight  # noqa: F401

__all__ = [
    "Diagnostic", "ERROR", "WARNING", "INFO", "SEVERITIES", "diag",
    "errors", "severity_counts", "render_text", "to_json", "run_analyzer",
    "histlint", "planlint", "searchplan", "shapelint", "certify",
    "fleetlint", "fleetmodel",
    "lint_history", "lint_encoded", "lint_test_history", "model_op_set",
    "lint_plan", "preflight", "PlanLintError",
]
