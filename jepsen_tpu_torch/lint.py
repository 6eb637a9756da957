"""The port's lint runner: codelint (the AST thread-safety pass) plus ruff
(style/correctness), one exit code (the port's counterpart of the JAX
package's ``tools/lint.py``, with the same options and exit codes).

Usage::

    python -m jepsen_tpu_torch.lint                 # lint jepsen_tpu_torch/
    python -m jepsen_tpu_torch.lint path [path...]  # specific files/dirs
    python -m jepsen_tpu_torch.lint --json          # diagnostics as JSON
    python -m jepsen_tpu_torch.lint --no-ruff       # codelint only
    python -m jepsen_tpu_torch.lint --campaign [ID] # fleetlint a campaign
    python -m jepsen_tpu_torch.lint --matrix FILE   # capplan a matrix
    python -m jepsen_tpu_torch.lint --certify [RUN] # re-certify a run

Exit codes: 0 clean (warnings allowed), 1 error-severity codelint
diagnostics or ruff violations, 2 internal error. ruff is optional at
runtime; when absent it is skipped with a notice.

``--campaign`` audits a stored campaign's artifacts
(``store/campaigns/<ID>/``; default: the most recent campaign) through
``analysis.fleetlint``, persists ``fleet_analysis.json``, and exits 1
on FL error diagnostics.

``--matrix FILE`` dry-runs the capacity planner (``analysis.capplan``)
over a campaign matrix JSON (``{"base": {...}, "axes": {...}}``):
prints the capacity table -- per-cell plan shapes, device-memory
footprints, int32-wall proximity -- plus the CP001-CP008 diagnostics,
and exits 1 on CP errors. ``--device-mem-budget BYTES`` enables the
memory half. Nothing runs, nothing is written, no card is needed.

``--certify [RUN]`` re-certifies a stored run directory (default:
``store/latest``) from its persisted artifacts (``analysis.certify``,
VC001-VC012). Exits 1 on VC errors, 2 when there is no such run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

from . import analysis
from .analysis import codelint

#: the repository root: the directory holding the package
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEFAULT_PATHS = ("jepsen_tpu_torch",)


def run_codelint(paths, package_root):
    return analysis.run_analyzer(
        "codelint", codelint.lint_paths, paths,
        package_root=package_root)


def ruff_argv():
    """A usable ruff invocation, or None when ruff is unavailable."""
    exe = shutil.which("ruff")
    if exe:
        return [exe]
    try:
        import ruff  # noqa: F401
    except ImportError:
        return None
    return [sys.executable, "-m", "ruff"]


def run_ruff(paths):
    """Run ruff check; returns (exit_code, output) or (None, reason)."""
    argv = ruff_argv()
    if argv is None:
        return None, "ruff not installed; skipping style pass"
    proc = subprocess.run(argv + ["check", *paths], cwd=REPO,
                          capture_output=True, text=True)
    return proc.returncode, (proc.stdout + proc.stderr).strip()


def run_campaign_audit(campaign_id, as_json=False):
    """fleetlint a stored campaign; returns the exit code (0 clean /
    warnings, 1 FL errors, 2 unknown campaign)."""
    from . import store
    from .analysis import fleetlint
    cid = campaign_id
    if cid in (None, "", "latest"):
        cid = store.latest_campaign()
        if cid is None:
            print("no campaign found in the store", file=sys.stderr)
            return 2
    try:
        report, diags = fleetlint.audit(cid)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(analysis.render_text(
            diags, title=f"fleetlint audit: {cid}"))
        print(f"report: {report.get('path')}")
    return 1 if analysis.errors(diags) else 0


def run_certify(run, budget=None, as_json=False):
    """Re-certify a stored run directory from its persisted artifacts;
    returns the exit code (0 clean / info, 1 VC errors, 2 no run)."""
    from . import store
    from .analysis import certify
    path = run
    if path in (None, "", "latest"):
        path = os.path.join(store.base_dir, "latest")
    path = os.path.realpath(path)
    if not os.path.isdir(path):
        print(f"no run directory at {path!r}", file=sys.stderr)
        return 2
    summary, diags = certify.certify_run(path, budget=budget)
    if summary is None and not diags:
        print(f"{path}: no results.json to certify against",
              file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(summary if summary is not None
                         else analysis.to_json(diags),
                         indent=1, sort_keys=True))
    else:
        print(analysis.render_text(diags, title=f"certify: {path}"))
        if summary is not None and summary.get("certified"):
            print(f"verdict {summary.get('verdict')!r} "
                  f"(engine {summary.get('engine')}), "
                  f"{len(summary.get('checks') or [])} check(s)")
        elif summary is not None:
            print("no certificate.json: nothing replayed")
    return 1 if analysis.errors(diags) else 0


def run_matrix_plan(path, device_mem_budget=None, as_json=False):
    """capplan a campaign matrix file; returns the exit code (0 clean
    / warnings, 1 CP errors, 2 unreadable matrix)."""
    from .analysis import capplan
    try:
        with open(path) as f:
            matrix = json.load(f)
    except (OSError, ValueError) as e:
        print(f"couldn't read matrix {path!r}: {e}", file=sys.stderr)
        return 2
    if not isinstance(matrix, dict):
        print(f"matrix {path!r} is not a JSON object", file=sys.stderr)
        return 2
    plan, diags = capplan.build_plan(
        matrix, device_mem_budget=device_mem_budget)
    if as_json:
        print(json.dumps(plan, indent=1, sort_keys=True))
    else:
        print(capplan.render_table(plan))
        print(analysis.render_text(diags,
                                   title=f"capacity plan: {path}"))
    return 1 if analysis.errors(diags) else 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.lint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--json", action="store_true",
                    help="emit diagnostics as JSON")
    ap.add_argument("--no-ruff", action="store_true",
                    help="skip the ruff style pass")
    ap.add_argument("--package-root", default=None,
                    help="package dir for thread-reachability ranking "
                         "(default: jepsen_tpu_torch when linted)")
    ap.add_argument("--campaign", nargs="?", const="latest",
                    default=None, metavar="ID",
                    help="audit a stored campaign's control-plane "
                         "artifacts with fleetlint instead of linting "
                         "source (default ID: the latest campaign); "
                         "exit 1 on FL errors")
    ap.add_argument("--certify", nargs="?", const="latest",
                    default=None, metavar="RUN",
                    help="re-certify a stored run directory's verdict "
                         "from its certificate.json + history.jsonl "
                         "(default RUN: store/latest); exit 1 on VC "
                         "errors")
    ap.add_argument("--budget", default=None, type=int,
                    help="cross-check config budget for --certify "
                         "(default: the certificate's recorded "
                         "budget)")
    ap.add_argument("--matrix", default=None, metavar="FILE",
                    help="dry-run the capacity planner (capplan) over "
                         "a campaign matrix JSON: print the capacity "
                         "table + CP diagnostics; exit 1 on CP errors")
    ap.add_argument("--device-mem-budget", default=None,
                    metavar="BYTES",
                    help="usable device memory in bytes for --matrix "
                         "(K/M/G/T suffixes accepted)")
    opts = ap.parse_args(argv)

    if opts.campaign is not None:
        return run_campaign_audit(opts.campaign, as_json=opts.json)
    if opts.certify is not None:
        return run_certify(opts.certify, budget=opts.budget,
                           as_json=opts.json)
    if opts.matrix is not None:
        budget = None
        if opts.device_mem_budget is not None:
            from .cli import parse_bytes
            budget = parse_bytes(opts.device_mem_budget)
        return run_matrix_plan(opts.matrix, device_mem_budget=budget,
                               as_json=opts.json)

    paths = list(opts.paths) or [os.path.join(REPO, p)
                                 for p in DEFAULT_PATHS
                                 if os.path.isdir(os.path.join(REPO, p))]
    package_root = opts.package_root
    if package_root is None:
        for p in paths:
            if os.path.basename(os.path.normpath(p)) \
                    == "jepsen_tpu_torch":
                package_root = p
                break

    diags = run_codelint(paths, package_root)
    failed = bool(analysis.errors(diags))

    ruff_code, ruff_out = (None, "skipped (--no-ruff)") if opts.no_ruff \
        else run_ruff(paths)
    if ruff_code not in (None, 0):
        failed = True

    if opts.json:
        report = analysis.to_json(diags)
        report["ruff"] = {"exit_code": ruff_code, "output": ruff_out}
        report["failed"] = failed
        print(json.dumps(report, indent=1))
    else:
        print(analysis.render_text(diags, title="codelint:"))
        print(f"ruff: {ruff_out or 'clean'}"
              if ruff_code in (None, 0)
              else f"ruff FAILED (exit {ruff_code}):\n{ruff_out}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
