"""Static analyses over histories and verdicts (the part of
``jepsen_tpu.analysis`` the port runs):

* **searchplan** -- the execution half of search planning: sealed
  quiescent cuts slice one history into sequential segments that are
  checked in isolation (``checker.checkers.Linearizable``, the
  ``independent`` checker), and the segment results merge back into one
  verdict.
* **certify** -- proof-carrying verdicts: every decided Linearizable
  verdict is certified from its own artifacts (VC001-VC012): valid
  verdicts replay their witness through the CPU model step, invalid ones
  are cross-checked by an independent CPU engine, and a sampled
  differential replays a segment through the port's device engine and
  the two CPU engines. ``checker.core.check`` runs it (opt out with
  ``test["certify?"] = False``).

Both report through one ``Diagnostic`` model and its renderers. The
lint analyzers (histlint, planlint, jaxlint, codelint, fleetlint,
capplan) and the plan report of record (``build_plan``) wait for the
host harness (ROADMAP.md queue A.11).
"""

from . import certify, searchplan  # noqa: F401
from .diagnostics import (Diagnostic, ERROR, INFO,  # noqa: F401
                          SEVERITIES, WARNING, diag, errors, render_text,
                          run_analyzer, severity_counts, to_json)

__all__ = [
    "Diagnostic", "ERROR", "WARNING", "INFO", "SEVERITIES", "diag",
    "errors", "severity_counts", "render_text", "to_json", "run_analyzer",
    "searchplan",
    "certify",
]
