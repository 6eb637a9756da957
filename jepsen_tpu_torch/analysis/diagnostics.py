"""Structured diagnostics shared by the port's analyzers (the part of
``jepsen_tpu/analysis/diagnostics.py`` they use, with ``run_analyzer``,
the obs span around an analyzer).

One record type -- ``Diagnostic{code, severity, location, message,
fix_hint}`` -- flows from every analyzer through the same renderers:
``render_text`` for humans and ``to_json`` for machines. Code namespaces
here: ``SP***`` the search planner, ``VC***`` the verdict certifier.
Severities: ``error`` (the artifact is malformed and downstream verdicts
can't be trusted), ``warning`` (legal but suspicious or wasteful),
``info`` (context).
"""

from __future__ import annotations

import dataclasses

from .. import obs

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: severity rank, most severe first (mirrors checker.core.valid_prio's
#: "worst dominates" merging)
SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass
class Diagnostic:
    """One analyzer finding.

    Attributes:
      code: stable machine code, e.g. "VC001" (tests assert on these).
      severity: "error" | "warning" | "info".
      message: human-readable description of the defect.
      location: where -- "certificate.witness", "searchplan". Empty when
        the finding is global.
      fix_hint: one actionable sentence, empty when there is none.
    """

    code: str
    severity: str
    message: str
    location: str = ""
    fix_hint: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)

    def __str__(self):
        loc = f" {self.location}" if self.location else ""
        hint = f" (fix: {self.fix_hint})" if self.fix_hint else ""
        return f"{self.severity.upper()} {self.code}{loc}: " \
               f"{self.message}{hint}"


def diag(code, severity, message, location="", fix_hint=""):
    return Diagnostic(code, severity, message, location, fix_hint)


def errors(diags):
    return [d for d in diags if d.severity == ERROR]


def severity_counts(diags):
    """{"error": n, "warning": n, "info": n} (zero-filled)."""
    out = {s: 0 for s in SEVERITIES}
    for d in diags:
        out[d.severity] = out.get(d.severity, 0) + 1
    return out


def sort_by_severity(diags):
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    return sorted(diags, key=lambda d: (rank.get(d.severity, 99),
                                        d.code, d.location))


# ---------------------------------------------------------------------------
# renderers

def render_text(diags, title=None):
    """Multi-line human rendering, worst findings first."""
    lines = []
    if title:
        lines.append(title)
    for d in sort_by_severity(diags):
        lines.append("  " + str(d))
    c = severity_counts(diags)
    lines.append(f"  {c[ERROR]} error(s), {c[WARNING]} warning(s), "
                 f"{c[INFO]} info")
    return "\n".join(lines)


def to_json(diags):
    """JSON-able report: {"diagnostics": [...], "counts": {...}}."""
    return {"diagnostics": [d.to_dict() for d in sort_by_severity(diags)],
            "counts": severity_counts(diags)}


# ---------------------------------------------------------------------------
# instrumented runner: lint cost and findings land in trace.jsonl /
# metrics.json like any other subsystem

def run_analyzer(name, fn, *args, **kwargs):
    """Run one analyzer under an obs span, counting its findings.

    Emits span ``analysis.<name>`` (cat "analysis"), latency histogram
    ``analysis.run_s`` and counter ``analysis.diagnostics`` labeled by
    analyzer + severity -- all no-ops while obs is unbound."""
    t0 = obs.now_ns()
    with obs.span(f"analysis.{name}", cat="analysis"):
        diags = list(fn(*args, **kwargs))
    if obs.enabled():
        obs.observe("analysis.run_s", (obs.now_ns() - t0) / 1e9,
                    analyzer=name)
        for sev, n in severity_counts(diags).items():
            if n:
                obs.inc("analysis.diagnostics", n, analyzer=name,
                        severity=sev)
    return diags
