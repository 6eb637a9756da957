"""Command line interface: a default main and utilities for suites to
build their own test runners (reference jepsen/src/jepsen/cli.clj; the
port's copy of ``jepsen_tpu/cli.py``).

The port adds one test option, ``--device {cuda,cpu}`` (default: CUDA):
where the run's checkers and monitor search. Without a card the default
raises, and the run exits 255; the CPU is used only when asked for.
``campaign`` runs a sweep through the campaign scheduler on one host,
or with ``--workers`` through the fleet (``fleet.run_fleet``: a fresh
worker process per cell, leases, stealing, chaos, coordinator HA with
``--standby``); ``test-all`` with any campaign flag runs through the
scheduler. The options that need later sub-slices of ROADMAP.md
A.11(d) are registered and raise ``NotImplementedError`` (exit 255)
before anything runs: the service's (``--serve`` and the ``serve``
subcommand: A.11(d4)) and the capacity planner's (``--capacity``,
``--device-mem-budget``, ``--device-slots auto``: A.11(d5)).

Exit codes (cli.clj:129-139):

  0     all tests passed
  1     some test failed
  2     some test had unknown validity
  254   invalid arguments
  255   internal error
"""

from __future__ import annotations

import argparse
import logging
import re
import sys
import traceback

from . import core, store

logger = logging.getLogger(__name__)

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]


class CliError(Exception):
    pass


def add_test_opts(parser):
    """The shared test option spec (cli.clj:64-111 test-opt-spec)."""
    parser.add_argument("-n", "--node", action="append", default=None,
                        metavar="HOSTNAME",
                        help="Node(s) to run test on; repeatable.")
    parser.add_argument("--nodes", default=None, metavar="NODE_LIST",
                        help="Comma-separated list of node hostnames.")
    parser.add_argument("--nodes-file", default=None, metavar="FILENAME",
                        help="File of node hostnames, one per line.")
    parser.add_argument("--username", default="root",
                        help="Username for logins")
    parser.add_argument("--password", default="root",
                        help="Password for sudo access")
    parser.add_argument("--strict-host-key-checking", action="store_true",
                        help="Whether to check host keys")
    parser.add_argument("--no-ssh", action="store_true",
                        help="Don't establish SSH connections (dummy "
                             "remote).")
    parser.add_argument("--ssh-private-key", default=None, metavar="FILE",
                        help="Path to an SSH identity file")
    parser.add_argument("--concurrency", default="1n", metavar="NUMBER",
                        help="Worker count: an integer, optionally followed"
                             " by n (e.g. 3n) to multiply by node count.")
    parser.add_argument("--leave-db-running", action="store_true",
                        help="Leave the database running for inspection.")
    parser.add_argument("--logging-json", action="store_true",
                        help="JSON structured jepsen.log output.")
    parser.add_argument("--test-count", type=int, default=1,
                        help="How many times to repeat the test.")
    parser.add_argument("--time-limit", type=int, default=60,
                        metavar="SECONDS",
                        help="How long the test runs, excluding setup and "
                             "teardown.")
    parser.add_argument("--op-timeout-ms", type=float, default=None,
                        metavar="MS",
                        help="Wedged-worker watchdog: ops blocking past "
                             "this deadline complete as :info "
                             "harness-timeout and their worker is "
                             "replaced (default: off).")
    parser.add_argument("--hard-time-limit", type=float, default=None,
                        metavar="SECONDS",
                        help="Hard harness deadline: abort gracefully, "
                             "salvage and check the partial history "
                             "(default: off).")
    parser.add_argument("--abort-grace", type=float, default=None,
                        metavar="SECONDS",
                        help="How long outstanding ops may drain after "
                             "an abort (SIGINT/SIGTERM/hard deadline) "
                             "before being written off as :info.")
    parser.add_argument("--monitor", action="store_true",
                        help="Run the streaming linearizability monitor "
                             "concurrently with the test: a proven "
                             "violation aborts the run the moment it is "
                             "detected instead of after the full offline "
                             "check (default: off).")
    parser.add_argument("--monitor-chunk", type=int, default=None,
                        metavar="N",
                        help="How many completed ops the monitor batches "
                             "per incremental check (default: 64; "
                             "requires --monitor).")
    parser.add_argument("--no-searchplan", action="store_true",
                        help="Disable the search planner "
                             "(analysis/searchplan.py): check every "
                             "history as one flat device search instead "
                             "of partitioning it at keys and sealed "
                             "quiescent cuts (default: planning on).")
    parser.add_argument("--searchplan-partitions", default=None,
                        metavar="NAMES",
                        help="Comma-separated partition predicates the "
                             "planner applies (default: "
                             "per-key,crash-segments; planlint PL015 "
                             "rejects unknown names).")
    parser.add_argument("--profile", action="store_true",
                        help="Capture a torch.profiler trace around the "
                             "run's device searches, persisted next to "
                             "trace.jsonl (bounded by --profile-max-s; "
                             "contained: a run whose profiler is "
                             "unavailable proceeds unprofiled).")
    parser.add_argument("--profile-dir", default=None, metavar="DIR",
                        help="Where the capture lands (default: "
                             "<run dir>/profile; PL019 rejects "
                             "unwritable locations).")
    parser.add_argument("--profile-max-s", type=float, default=None,
                        metavar="SECONDS",
                        help="Capture wall bound: the profiler stops "
                             "after this even if the search is still "
                             "running (default 120).")
    parser.add_argument("--progress-interval-s", type=float,
                        default=None, metavar="SECONDS",
                        help="Minimum interval between search-progress "
                             "trace emissions / journal flushes "
                             "(default: every host->device dispatch; "
                             "PL019 warns below the ~1 s heartbeat "
                             "cadence).")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="Where the checkers and the monitor search "
                             "(default: cuda; without a card the run "
                             "fails; cpu runs the plain PyTorch path).")
    parser.add_argument("--lint", action="store_true",
                        help="Dry run: statically validate the test plan "
                             "(planlint) and exit without contacting any "
                             "node.")
    return parser


def parse_concurrency(value, nodes):
    """\"3n\" -> 3 * node count; plain integers parse as-is
    (cli.clj:150-165)."""
    m = re.fullmatch(r"(\d+)(n?)", str(value))
    if not m:
        raise CliError(f"--concurrency {value} should be an integer "
                       "optionally followed by n")
    unit = len(nodes) if m.group(2) == "n" else 1
    return int(m.group(1)) * unit


def parse_nodes(opts):
    """Merge --node/--nodes/--nodes-file into one list
    (cli.clj:167-202)."""
    out = []
    if opts.get("nodes-file"):
        with open(opts["nodes-file"]) as f:
            out += [ln.strip() for ln in f if ln.strip()]
    if opts.get("nodes"):
        out += [n.strip() for n in str(opts["nodes"]).split(",")]
    if opts.get("node"):
        out += list(opts["node"])
    return out or list(DEFAULT_NODES)


def test_opt_fn(opts):
    """Standard option pipeline: merge node specs, build the :ssh map,
    parse concurrency (cli.clj:242-253 test-opt-fn)."""
    opts = dict(opts)
    nodes = parse_nodes(opts)
    opts["nodes"] = nodes
    opts["concurrency"] = parse_concurrency(
        opts.get("concurrency", "1n"), nodes)
    opts["ssh"] = {
        "dummy?": bool(opts.pop("no-ssh", False)),
        "username": opts.pop("username", "root"),
        "password": opts.pop("password", "root"),
        "strict-host-key-checking":
            opts.pop("strict-host-key-checking", False),
        "private-key-path": opts.pop("ssh-private-key", None),
    }
    opts["leave-db-running?"] = opts.pop("leave-db-running", False)
    opts["logging-json?"] = opts.pop("logging-json", False)
    opts["lint?"] = opts.pop("lint", False)
    # robustness knobs (jepsen_tpu_torch.robust): map CLI names onto the test
    # keys core.run/interpreter watch; absent flags leave the keys out
    # entirely so the features stay off
    for flag, key in (("op-timeout-ms", "op-timeout-ms"),
                      ("hard-time-limit", "time-limit-s"),
                      ("abort-grace", "abort-grace-s")):
        v = opts.pop(flag, None)
        if v is not None:
            opts[key] = v
    # streaming monitor (jepsen_tpu_torch.monitor): --monitor turns it on,
    # --monitor-chunk sets the batch size. A bare --monitor-chunk is
    # deliberately KEPT on the map so planlint PL013 can flag the
    # ignored knob instead of it vanishing silently.
    monitor = opts.pop("monitor", False)
    chunk = opts.pop("monitor-chunk", None)
    if monitor:
        opts["monitor"] = {"chunk": chunk} if chunk is not None else True
    elif chunk is not None:
        opts["monitor-chunk"] = chunk
    # device introspection (jepsen_tpu_torch.obs.profile / obs.search):
    # --profile maps onto the profile? key core.analyze watches;
    # the dir/bound/cadence knobs pass through under their test names
    if opts.pop("profile", False):
        opts["profile?"] = True
    for flag, key in (("profile-dir", "profile-dir"),
                      ("profile-max-s", "profile-max-s"),
                      ("progress-interval-s", "progress-interval-s")):
        v = opts.pop(flag, None)
        if v is not None:
            opts[key] = v
    # search planner (jepsen_tpu_torch.analysis.searchplan): planning is on
    # by default, so only an explicit opt-out / predicate list lands
    # on the map (PL015 warns on explicit-enable without a plannable
    # checker, so we avoid stamping every test map "explicitly on")
    if opts.pop("no-searchplan", False):
        opts["searchplan?"] = False
    preds = opts.pop("searchplan-partitions", None)
    if preds is not None:
        opts["searchplan-partitions"] = [p.strip()
                                        for p in str(preds).split(",")
                                        if p.strip()]
    opts.pop("node", None)
    opts.pop("nodes-file", None)
    return opts


def _ns_to_opts(ns):
    return {k.replace("_", "-"): v for k, v in vars(ns).items()}


def _exit_for_valid(valid):
    if valid is False:
        return 1
    if valid != True:  # noqa: E712 - "unknown" and None both count
        return 2
    return 0


def single_test_cmd(opts):
    """Subcommands ``test`` (run + analyze) and ``analyze`` (re-check the
    latest stored history with a freshly-built test map)
    (cli.clj:352-427). opts: {"test-fn": options -> test map,
    "opt-spec": fn(parser), "opt-fn": fn(options)}."""
    test_fn = opts["test-fn"]

    def lint_test(options):
        """--lint dry run: planlint the built test map, print the
        report, exit 0 (clean) / 1 (error diagnostics). No node is
        contacted, no store directory is written."""
        from . import analysis
        test = core.prepare_test(test_fn(options))
        diags = analysis.lint_plan(test)
        print(analysis.render_text(
            diags, title=f"plan lint: {test.get('name')}"))
        sys.exit(1 if analysis.errors(diags) else 0)

    def run_test(options):
        if options.get("lint?"):
            return lint_test(options)
        for _i in range(options.get("test-count", 1)):
            test = core.run(test_fn(options))
            code = _exit_for_valid(
                (test.get("results") or {}).get("valid"))
            if code:
                sys.exit(code)

    def run_analyze(options):
        if options.get("lint?"):
            # --lint means "never touch nodes or stored state" on
            # either subcommand; without this, analyze would silently
            # ignore the flag and kick off a full re-check
            return lint_test(options)
        cli_test = test_fn(options)
        stored = store.latest()
        if stored is None:
            raise CliError("Not sure what the last test was")
        if stored.get("name") != cli_test.get("name"):
            raise CliError(
                f"Stored test ({stored.get('name')}) and CLI test "
                f"({cli_test.get('name')}) have different names; aborting")
        test = {**cli_test,
                **{k: v for k, v in stored.items() if k != "results"}}
        test = core.analyze(test)
        sys.exit(_exit_for_valid(
            (test.get("results") or {}).get("valid")))

    return {
        "test": {"opt-spec": opts.get("opt-spec"),
                 "opt-fn": opts.get("opt-fn"),
                 "run": run_test,
                 "help": "Run a test and analyze it."},
        "analyze": {"opt-spec": opts.get("opt-spec"),
                    "opt-fn": opts.get("opt-fn"),
                    "run": run_analyze,
                    "help": "Re-analyze the latest stored history."},
    }


def test_all_run_tests(tests):
    """Run tests; map of outcome (True/False/'unknown'/'crashed') to
    entries (cli.clj:429-445). Entries are store paths, or
    {"cell": ..., "path": ...} dicts for campaign cells so sweep output
    stays attributable. prepare_test runs INSIDE the try: one malformed
    test plan records as "crashed" instead of taking the suite down."""
    results = {}
    for test in tests:
        cell = None
        try:
            test = core.prepare_test(test)
            cell = (test.get("campaign") or {}).get("cell") \
                if isinstance(test.get("campaign"), dict) else None
            done = core.run(test)
            outcome = (done.get("results") or {}).get("valid")
            if outcome is not True and outcome is not False:
                outcome = "unknown"
        except Exception:  # noqa: BLE001
            logger.warning("Test crashed\n%s", traceback.format_exc())
            outcome = "crashed"
        try:
            path = store.path(test)
        except (AssertionError, AttributeError, KeyError, TypeError):
            path = "<unnamed>"
        entry = {"cell": cell, "path": path} if cell else path
        results.setdefault(outcome, []).append(entry)
    return results


def _entry_str(entry):
    """Render one outcome-group entry: plain path, or cell-id-tagged
    path for campaign cells."""
    if isinstance(entry, dict):
        cell = entry.get("cell")
        path = entry.get("path") or "<unnamed>"
        return f"[{cell}] {path}" if cell else str(path)
    return str(entry)


def _result_group(results, key):
    """Entries for one outcome group. Accepts both key spellings:
    test_all_run_tests builds bool-keyed maps (reference shape), while
    campaign report.results_map uses str() keys so the map survives a
    report.json round trip."""
    return results.get(key) or results.get(str(key)) or []


def test_all_print_summary(results):
    """Print outcome groups + counts (cli.clj:447-476). Campaign cells
    print with their cell ids so sweep output is attributable."""
    for title, key in (("Successful tests", True),
                       ("Indeterminate tests", "unknown"),
                       ("Aborted tests", "aborted"),
                       ("Crashed tests", "crashed"),
                       ("Failed tests", False)):
        group = _result_group(results, key)
        if group:
            print(f"\n# {title}\n")
            for p in group:
                print(_entry_str(p))
    print()
    print(len(_result_group(results, True)), "successes")
    print(len(_result_group(results, "unknown"))
          + len(_result_group(results, "aborted")), "unknown")
    print(len(_result_group(results, "crashed")), "crashed")
    print(len(_result_group(results, False)), "failures")
    return results


def test_all_exit_code(results):
    """255 crashed > 2 unknown > 1 failed > 0 (cli.clj:478-485).
    Aborted campaign cells have no verdict, so they rank with
    unknown."""
    if _result_group(results, "crashed"):
        return 255
    if _result_group(results, "unknown") \
            or _result_group(results, "aborted"):
        return 2
    if _result_group(results, False):
        return 1
    return 0


def campaign_exit_code(report):
    """Exit code for a whole campaign. An aborted campaign ranks as
    indeterminate (2) even when every *recorded* cell passed -- a
    SIGINT landing between cells leaves the unrun cells with no
    journal record at all, so the results map alone under-reports.
    Crashed cells still dominate (255)."""
    code = test_all_exit_code(report.get("results") or {})
    if report.get("status") == "aborted" and code in (0, 1):
        code = 2
    return code


def _parse_device_slots(value):
    """--device-slots: a positive integer, or the literal "auto" (the
    campaign subcommand derives the count from the capacity plan's
    HBM footprints vs --device-mem-budget)."""
    v = str(value).strip()
    if v == "auto":
        return "auto"
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--device-slots {value!r} should be an integer or "
            "'auto'") from None


def parse_bytes(value):
    """A byte count with optional K/M/G/T suffix ("16G" -> 2**34)."""
    s = str(value).strip()
    mult = 1
    suffixes = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1].upper() in suffixes:
        mult = suffixes[s[-1].upper()]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"byte count {value!r} should be a number with an "
            "optional K/M/G/T suffix") from None


def _add_campaign_opts(parser, axes=False):
    parser.add_argument("--parallel", type=int, default=1, metavar="N",
                        help="Worker-pool width: how many test cells "
                             "run concurrently (campaign scheduler).")
    parser.add_argument("--device-slots", type=_parse_device_slots,
                        default=1, metavar="N",
                        help="How many device checker searches may run "
                             "at once (one per accelerator), or "
                             "'auto' to derive the count from the "
                             "capacity plan (requires "
                             "--device-mem-budget; campaign "
                             "subcommand only).")
    parser.add_argument("--campaign-id", default=None, metavar="ID",
                        help="Campaign id (store/campaigns/<id>/); "
                             "default: derived from the start time.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume a campaign: skip cells whose "
                             "outcome is already journaled; without "
                             "--campaign-id, the most recent campaign "
                             "is resumed.")
    parser.add_argument("--no-ledger", action="store_true",
                        help="Accepted for the JAX package's command "
                             "lines; no effect: the port compiles "
                             "nothing per shape and keeps no compile "
                             "ledger.")
    parser.add_argument("--backends", default=None,
                        metavar="TIER1,TIER2",
                        help="Backend failover ladder consulted per "
                             "cell (tiers: tpu, gpu, cpu; e.g. "
                             "tpu,gpu,cpu). A down accelerator "
                             "degrades cells to the next tier instead "
                             "of crashing them.")
    if axes:
        parser.add_argument("--workers", default=None,
                            metavar="HOST1,HOST2",
                            help="Fleet mode: lease cells to these "
                                 "worker hosts over the SSH control "
                                 "plane ('local' = loopback worker "
                                 "processes; name=host gives explicit "
                                 "worker ids).")
        parser.add_argument("--lease", type=float, default=None,
                            metavar="SECONDS",
                            help="Fleet lease TTL: a cell exec running "
                                 "past this is presumed dead and its "
                                 "cell is stolen by another worker "
                                 "(default 600).")
        parser.add_argument("--max-leases", type=int, default=None,
                            metavar="N",
                            help="How many leases a cell may burn "
                                 "before it journals as crashed "
                                 "(default 3; raise it for chaos "
                                 "soaks, where injected faults and "
                                 "real recoveries share the budget).")
        parser.add_argument("--serve", action="store_true",
                            help="Serve the web UI + submission API "
                                 "(POST /api/check, /api/campaigns) "
                                 "alongside the campaign, so its "
                                 "status is pollable while it runs.")
        parser.add_argument("--serve-port", type=int, default=8080,
                            metavar="PORT",
                            help="Port for --serve (default 8080).")
        parser.add_argument("--serve-ip", default="0.0.0.0",
                            metavar="IP",
                            help="Bind address for --serve (default "
                                 "0.0.0.0; a non-loopback bind "
                                 "requires --auth-token, PL016).")
        parser.add_argument("--auth-token", default=None,
                            metavar="TOKEN",
                            help="Bearer token /api requests must "
                                 "present (401 otherwise) when "
                                 "--serve is on.")
        parser.add_argument("--no-coalesce", action="store_true",
                            help="Disable cross-tenant batch "
                                 "coalescing for --serve: every "
                                 "accepted /api/check runs its own "
                                 "device search instead of merging "
                                 "with queued strangers (default: "
                                 "coalescing on).")
        parser.add_argument("--coalesce-window-ms", type=float,
                            default=None, metavar="MS",
                            help="How long a submitted check may wait "
                                 "for batchmates before its device "
                                 "batch closes anyway (default 25; "
                                 "PL020 rejects non-positive "
                                 "values).")
        parser.add_argument("--coalesce-max-segments", type=int,
                            default=None, metavar="N",
                            help="Segments per coalesced device batch "
                                 "past which the batch closes early "
                                 "(default 32; PL020 rejects "
                                 "non-positive values).")
        parser.add_argument("--worker-store", default=None,
                            metavar="DIR",
                            help="Store directory the fleet WORKERS "
                                 "write runs into (default: the "
                                 "coordinator's own store). Pointing "
                                 "it elsewhere gives workers isolated "
                                 "stores and turns artifact sync on "
                                 "for loopback workers too.")
        parser.add_argument("--sync-timeout", type=float, default=None,
                            metavar="SECONDS",
                            help="Wall bound for mirroring one remote "
                                 "cell's run directory into the "
                                 "coordinator store (default 120).")
        parser.add_argument("--telemetry-flush-ms", type=float,
                            default=None, metavar="MS",
                            help="Crash-safe telemetry journal flush "
                                 "interval for every cell run "
                                 "(default 500; PL017 rejects "
                                 "non-positive values).")
        parser.add_argument("--no-trace-merge", action="store_true",
                            help="Skip folding the per-run traces "
                                 "into campaign_trace.jsonl at fleet "
                                 "finalize (the merged Perfetto "
                                 "timeline with one lane per worker, "
                                 "clocks skew-normalized).")
        parser.add_argument("--fleetlint", default="on",
                            metavar="MODE",
                            help="Control-plane audit mode: 'on' "
                                 "(default) replays the finished "
                                 "campaign's artifacts against the "
                                 "fleet protocol (analysis.fleetlint "
                                 "-> fleet_analysis.json) and "
                                 "preflights --resume; 'off' skips "
                                 "both. Unknown values are a PL018 "
                                 "error.")
        parser.add_argument("--chaos-profile", default=None,
                            metavar="NAME[:SEED]",
                            help="Fleet chaos soak: inject a seeded, "
                                 "deterministic fault schedule "
                                 "(exit-255s, hangs, partial "
                                 "downloads, worker kill -9s) into "
                                 "the dispatch control plane; "
                                 "profiles: none, flaky-exec, "
                                 "lossy-sync, soak, coordinator-kill, "
                                 "txn-skew (per-worker clock skew for "
                                 "the transactional family) "
                                 "(e.g. soak:42).")
        parser.add_argument("--coordinator-lease-s", type=float,
                            default=None, metavar="SECONDS",
                            help="Coordinator HA (fleet.ha): renew a "
                                 "journaled coordinator-role lease "
                                 "with this TTL so a standby can "
                                 "detect coordinator death and take "
                                 "the campaign over (default: HA "
                                 "off; PL024 rejects non-positive "
                                 "values).")
        parser.add_argument("--takeover-grace-s", type=float,
                            default=None, metavar="SECONDS",
                            help="Extra quiet time a standby waits "
                                 "past the coordinator lease TTL "
                                 "before fencing (default 5; PL024 "
                                 "rejects non-positive values).")
        parser.add_argument("--standby", action="store_true",
                            help="Run as a standby coordinator: tail "
                                 "the campaign journal read-only; on "
                                 "coordinator-lease expiry, fence the "
                                 "dead coordinator (journaled "
                                 "takeover record) and resume the "
                                 "campaign. Without --campaign-id "
                                 "the most recent campaign is "
                                 "tailed.")
        parser.add_argument("--axis", action="append", default=[],
                            metavar="NAME=V1,V2,...",
                            help="A sweep axis: option NAME takes each "
                                 "listed value (repeatable; numeric "
                                 "values are coerced).")
        parser.add_argument("--seeds", type=int, default=None,
                            metavar="N",
                            help="Shorthand for --axis "
                                 "seed=0,1,...,N-1.")
        parser.add_argument("--capacity", default=None, metavar="MODE",
                            help="Static capacity preflight "
                                 "(analysis.capplan): 'plan' persists "
                                 "capacity_plan.json (predicted "
                                 "compile shapes, HBM footprints, "
                                 "int32-wall proximity) and runs the "
                                 "prediction oracle at finalize; "
                                 "'warn' also prints the table + "
                                 "CP diagnostics; 'enforce' refuses "
                                 "the campaign on CP/PL021 errors. "
                                 "plan/warn can never change an "
                                 "outcome or exit code.")
        parser.add_argument("--device-mem-budget", type=parse_bytes,
                            default=None, metavar="BYTES",
                            help="Usable device HBM in bytes "
                                 "(suffixes K/M/G/T accepted, e.g. "
                                 "16G): capplan checks per-cell "
                                 "footprints against it (CP004/"
                                 "CP005) and --device-slots auto "
                                 "derives from it.")


def test_all_cmd(opts):
    """Subcommand ``test-all``: run a suite of tests
    (cli.clj:487-515). opts: {"tests-fn": options -> [test maps], ...}.

    ``--parallel N`` / ``--resume`` route the suite through the
    campaign scheduler (jepsen_tpu_torch.campaign): each test becomes a
    cell, outcomes journal to store/campaigns/<id>/, and a rerun with
    --resume skips completed cells (reference
    ``jepsen_tpu/cli.py:615-669``), with the compile ledger
    (``--no-ledger`` turns it off) and ``--backends`` failover."""
    tests_fn = opts["tests-fn"]

    def add_opts(parser):
        _add_campaign_opts(parser)
        if opts.get("opt-spec"):
            opts["opt-spec"](parser)

    def run_all(options):
        if options.get("device-slots") == "auto":
            raise CliError("--device-slots auto derives from a "
                           "capacity plan over a sweep matrix; use "
                           "the campaign subcommand")
        refuse_later_slices(options)
        # ANY campaign flag routes through the scheduler -- a
        # --campaign-id or --device-slots on the legacy sequential path
        # would be silently ignored (no journal, nothing to resume)
        if options.get("parallel", 1) > 1 or options.get("resume") \
                or options.get("campaign-id") \
                or (options.get("device-slots") or 1) > 1:
            from . import campaign
            cells, seen = [], {}
            for i, t in enumerate(tests_fn(options)):
                cid = str(t.get("name") or f"test-{i}")
                seen[cid] = seen.get(cid, 0) + 1
                if seen[cid] > 1:
                    cid = f"{cid}#{seen[cid]}"
                cells.append({"id": cid, "test": t})
            try:
                report = campaign.run_cells(
                    cells, parallel=options.get("parallel", 1),
                    device_slots=options.get("device-slots", 1),
                    campaign_id=options.get("campaign-id"),
                    resume=bool(options.get("resume")),
                    ledger=not options.get("no-ledger"),
                    backends=options.get("backends") or None)
            except campaign.CampaignError as e:
                raise CliError(str(e)) from e
            print(campaign.report.render_text(report))
            test_all_print_summary(report["results"])
            sys.exit(campaign_exit_code(report))
        results = test_all_run_tests(tests_fn(options))
        test_all_print_summary(results)
        sys.exit(test_all_exit_code(results))

    return {"test-all": {"opt-spec": add_opts,
                         "opt-fn": opts.get("opt-fn"),
                         "run": run_all,
                         "help": "Run a whole suite of tests."}}


def _coerce_axis_value(v):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def parse_axes(specs, seeds=None):
    """--axis NAME=V1,V2 specs -> {name: [values]}; ``seeds`` adds the
    seed axis."""
    axes = {}
    for spec in specs or []:
        name, eq, values = str(spec).partition("=")
        if not eq or not name:
            raise CliError(f"--axis {spec!r} should be NAME=V1,V2,...")
        axes[name] = [_coerce_axis_value(v)
                      for v in values.split(",") if v != ""]
    if seeds:
        axes.setdefault("seed", list(range(int(seeds))))
    return axes


#: option keys that are coordinator-local wiring, never shipped to a
#: fleet worker's cell spec
_FLEET_LOCAL_OPTS = {
    "argv", "workers", "lease", "max-leases", "serve", "serve-port",
    "serve-ip",
    "auth-token", "worker-store", "sync-timeout", "chaos-profile",
    "fleetlint", "no-ledger", "backends", "axis", "seeds", "parallel",
    "device-slots", "campaign-id", "resume", "lint?",
    "no-coalesce", "coalesce-window-ms", "coalesce-max-segments",
    "capacity", "device-mem-budget",
    "standby", "coordinator-lease-s", "takeover-grace-s",
}


def _jsonable_options(options):
    """The JSON-serializable subset of the parsed options: what a
    fleet worker's cell spec carries so the remote build sees the same
    base options the coordinator would have used locally. The port's
    ``device`` option is one of them: it tells each worker process
    where to search (None: CUDA)."""
    import json as _json
    out = {}
    for k, v in options.items():
        if k in _FLEET_LOCAL_OPTS:
            continue
        try:
            _json.dumps(v)
        except (TypeError, ValueError):
            continue
        out[k] = v
    return out


#: campaign options whose modules are later sub-slices of ROADMAP.md
#: A.11(d): (option key, what needs it, the sub-slice)
LATER_SLICE_OPTS = (
    ("serve", "the service (fleet.service, web)", "A.11(d4)"),
    ("capacity", "the capacity planner (analysis.capplan)", "A.11(d5)"),
    ("device-mem-budget", "the capacity planner (analysis.capplan)",
     "A.11(d5)"),
)


def refuse_later_slices(options):
    """Raise ``NotImplementedError`` naming the sub-slice for the first
    option set whose module the port has not got yet (``--device-slots
    auto`` counts as the capacity planner's): nothing of the campaign
    has run or been written when it raises."""
    for key, what, item in LATER_SLICE_OPTS:
        if options.get(key) not in (None, False, ""):
            raise NotImplementedError(
                f"--{key} needs {what}, which is not ported yet: "
                f"ROADMAP.md {item}")
    if options.get("device-slots") == "auto":
        raise NotImplementedError(
            "--device-slots auto needs the capacity planner "
            "(analysis.capplan), which is not ported yet: ROADMAP.md "
            "A.11(d5)")


def campaign_cmd(opts):
    """Subcommand ``campaign``: expand a sweep matrix over the suite's
    test-fn and run it as a parallel, resumable campaign (reference
    ``jepsen_tpu/cli.py:728-1070``). opts: {"test-fn": options -> test
    map, "opt-spec": fn(parser), "opt-fn": fn(options), "builder":
    the importable "pkg.module:fn" fleet workers rebuild cells with}.

        python -m jepsen_tpu_torch campaign --no-ssh \\
            --axis workload=register,bank --seeds 3 --parallel 4
        python -m jepsen_tpu_torch campaign --no-ssh \\
            --workers local,local --axis workload=register --seeds 2

    Axis names are option keys: each cell rebuilds the test map from
    the base options with that cell's axis values overlaid (a ``seed``
    axis also seeds the global RNG before the build). ``--lint`` dry
    runs the PL012 matrix validation (with the PL014, PL015,
    PL017-PL020, PL023 and PL024 knob passes) and prints the cell ids;
    with an existing ``--campaign-id`` it audits that campaign from
    disk instead (fleetlint). ``--workers`` runs the cells through the
    fleet (``fleet.run_fleet``), and ``--standby`` tails a fleet
    campaign and takes it over once its coordinator's lease expires.
    The service and capacity options raise ``NotImplementedError``
    naming their sub-slice before anything runs
    (``refuse_later_slices``)."""
    test_fn = opts["test-fn"]

    def add_opts(parser):
        _add_campaign_opts(parser, axes=True)
        if opts.get("opt-spec"):
            opts["opt-spec"](parser)

    def run_campaign(options):
        import os
        import random
        import threading

        from . import analysis, campaign

        refuse_later_slices(options)
        # --lint with an EXISTING --campaign-id audits that campaign
        # from disk (fleetlint over its journal/traces) instead of dry
        # running a matrix: `campaign --lint --campaign-id soak` is
        # the post-hoc "did the control plane behave?" question
        cid = options.get("campaign-id")
        if options.get("lint?") and cid \
                and os.path.exists(store.campaign_path(cid,
                                                       "campaign.json")):
            from .analysis import fleetlint
            _report, diags = fleetlint.audit(cid)
            print(analysis.render_text(
                diags, title=f"fleetlint audit: {cid}"))
            sys.exit(1 if analysis.errors(diags) else 0)

        axes = parse_axes(options.get("axis"), options.get("seeds"))
        matrix = {"axes": axes}
        cells_plan = campaign.plan.expand(matrix)
        diags = campaign.plan.lint(matrix)
        # fleet-config preflight (PL014) rides along whenever any
        # fleet-facing knob is set; run_fleet re-checks, but --lint
        # must surface the findings without contacting a host
        workers = None
        if options.get("workers"):
            from . import fleet
            workers = fleet.parse_workers(options["workers"],
                                          ssh=options.get("ssh"))
        fleet_cfg = {
            "lease-s": options.get("lease"),
            "serve?": bool(options.get("serve")),
            "device-slots": options.get("device-slots"),
            "backends": [t.strip() for t in
                         str(options["backends"]).split(",")
                         if t.strip()]
            if options.get("backends") else None,
            "time-limit": options.get("time-limit"),
        }
        if workers is not None:
            fleet_cfg["workers"] = [w.id for w in workers]
        if workers is not None or options.get("backends"):
            diags += analysis.planlint.lint_fleet(fleet_cfg)
        # the service's preflight (PL016) comes with the service:
        # ROADMAP.md A.11(d4)
        # telemetry-plane preflight (PL017): flush-knob sanity always,
        # the merge-without-sync rule whenever fleet-dispatching
        diags += analysis.planlint.lint_telemetry({
            "telemetry-flush-ms": options.get("telemetry-flush-ms"),
            "metrics?": False,
            "serve-ip": options.get("serve-ip"),
            "auth-token?": bool(options.get("auth-token")),
            "trace-merge?": workers is not None
            and not options.get("no-trace-merge"),
        })
        chaos_prof = None
        if options.get("chaos-profile"):
            from .fleet import chaos as fchaos
            try:
                chaos_prof = fchaos.parse(options["chaos-profile"])
            except ValueError as e:
                raise CliError(str(e)) from None
        diags += analysis.planlint.searchplan_diags(options)
        diags += analysis.planlint.lint_introspection(options)
        diags += analysis.planlint.lint_certify(options)
        diags += analysis.planlint.lint_fleetlint(
            {"fleetlint": options.get("fleetlint")})
        diags += analysis.planlint.lint_coalesce({
            "coalesce?": False,
            "coalesce-window-ms": options.get("coalesce-window-ms"),
            "coalesce-max-segments":
                options.get("coalesce-max-segments"),
            "device-slots": options.get("device-slots"),
            "engine": options.get("engine"),
        })
        # coordinator-HA preflight (PL024): broken failover math (a
        # coordinator-kill with HA off, a standby with no journal to
        # tail) surfaces at --lint, before any role lease is claimed
        # or standby started
        standby = bool(options.get("standby"))
        standby_cid = (options.get("campaign-id")
                       or store.latest_campaign()) if standby else None
        diags += analysis.planlint.lint_ha({
            "ha?": options.get("coordinator-lease-s") is not None
            or standby,
            "coordinator-lease-s": options.get("coordinator-lease-s"),
            "takeover-grace-s": options.get("takeover-grace-s"),
            "standby?": standby,
            "store-reachable?": bool(
                standby_cid and os.path.exists(store.campaign_path(
                    standby_cid, "campaign.json"))) if standby
            else None,
            "chaos-coordinator-kill?": bool(
                getattr(chaos_prof, "coordinator_kill", 0)),
            "lease-s": options.get("lease"),
        })
        if options.get("lint?"):
            print(analysis.render_text(diags, title="campaign lint:"))
            for c in cells_plan:
                print(c["id"])
            sys.exit(1 if analysis.errors(diags) else 0)
        if analysis.errors(diags):
            raise CliError(analysis.render_text(
                analysis.errors(diags),
                title="campaign matrix invalid:"))
        # coordinator HA (fleet.ha): the standby tails the journal
        # read-only until the active coordinator's lease expires,
        # fences it with a journaled takeover record, and falls
        # through to the normal fleet --resume path as the new
        # coordinator (epoch = the won fencing token)
        ha_epoch = None
        if standby:
            if workers is None:
                raise CliError(
                    "--standby is fleet-mode only: pass --workers so "
                    "a takeover can dispatch the remaining cells")
            if not standby_cid:
                raise CliError(
                    "--standby: no campaign to stand by for (pass "
                    "--campaign-id, or start the active coordinator "
                    "first)")
            from .fleet import ha as fha
            sb = fha.Standby(
                standby_cid,
                lease_s=options.get("coordinator-lease-s"),
                grace_s=options.get("takeover-grace-s"))
            print(f"standby: tailing campaign {standby_cid}",
                  flush=True)
            status, epoch = sb.wait()
            if status == "complete":
                print(f"standby: campaign {standby_cid} completed "
                      "under its own coordinator; standing down")
                sys.exit(0)
            print(f"standby: coordinator lease expired; took over "
                  f"campaign {standby_cid} at epoch {epoch}",
                  flush=True)
            ha_epoch = epoch
            options["campaign-id"] = standby_cid
            options["resume"] = True
        elif options.get("coordinator-lease-s") is not None \
                and workers is None:
            raise CliError(
                "--coordinator-lease-s is fleet-mode only: the "
                "coordinator role lease lives in the fleet journal "
                "(pass --workers, e.g. --workers local,local)")
        if workers is not None:
            from . import fleet
            try:
                report = fleet.run_fleet(
                    cells_plan, workers,
                    campaign_id=options.get("campaign-id"),
                    resume=bool(options.get("resume")),
                    lease_s=options.get("lease")
                    or fleet.dispatch.DEFAULT_LEASE_S,
                    max_leases=options.get("max-leases")
                    or fleet.dispatch.MAX_LEASES,
                    builder=opts.get("builder"),
                    base_options=_jsonable_options(options),
                    ledger=not options.get("no-ledger"),
                    backends=options.get("backends") or None,
                    device_slots=options.get("device-slots", 1),
                    worker_store_dir=options.get("worker-store"),
                    sync_timeout_s=options.get("sync-timeout"),
                    chaos=options.get("chaos-profile"),
                    trace_merge=not options.get("no-trace-merge"),
                    fleetlint=options.get("fleetlint") or "on",
                    coordinator_lease_s=options.get(
                        "coordinator-lease-s"),
                    takeover_grace_s=options.get("takeover-grace-s"),
                    ha_epoch=ha_epoch)
            except fleet.FleetError as e:
                raise CliError(str(e)) from e
            print(campaign.report.render_text(report))
            sys.exit(campaign_exit_code(report))

        # seed + build are one atomic step: scheduler pool threads
        # build cells concurrently, and the global RNG must not be
        # re-seeded by a sibling cell mid-build. (Draws during the RUN
        # still interleave between parallel cells; seeds reproduce
        # fully only at --parallel 1.)
        build_lock = threading.Lock()

        def build(params):
            o = dict(options)
            o.update(params)
            # axis values land AFTER test_opt_fn already ran, so
            # option syntaxes that need parsing get it here: a
            # concurrency axis may use the documented "3n" form
            if isinstance(o.get("concurrency"), str):
                o["concurrency"] = parse_concurrency(
                    o["concurrency"], o.get("nodes") or [])
            with build_lock:
                if "seed" in params:
                    random.seed(params["seed"])
                return test_fn(o)

        cells = [{"id": c["id"], "group": c["group"],
                  "params": c["params"], "build": build}
                 for c in cells_plan]
        try:
            report = campaign.run_cells(
                cells, parallel=options.get("parallel", 1),
                device_slots=options.get("device-slots", 1),
                campaign_id=options.get("campaign-id"),
                resume=bool(options.get("resume")),
                ledger=not options.get("no-ledger"),
                backends=options.get("backends") or None,
                fleetlint=options.get("fleetlint") != "off")
        except campaign.CampaignError as e:
            raise CliError(str(e)) from e
        print(campaign.report.render_text(report))
        sys.exit(campaign_exit_code(report))

    return {"campaign": {"opt-spec": add_opts,
                         "opt-fn": opts.get("opt-fn"),
                         "run": run_campaign,
                         "help": "Run a sweep matrix as a parallel, "
                                 "resumable campaign."}}


def serve_cmd():
    """Subcommand ``serve``: the web interface (cli.clj:333-350). It is
    registered with the JAX package's options; running it raises
    ``NotImplementedError`` (``web.py`` is ROADMAP.md A.11(d4))."""

    def add_opts(parser):
        parser.add_argument("-b", "--host", default="0.0.0.0",
                            help="Hostname to bind to")
        parser.add_argument("-p", "--port", type=int, default=8080,
                            help="Port number to bind to")
        parser.add_argument("--token", default=None, metavar="TOKEN",
                            help="Bearer token /api requests must "
                                 "present (401 otherwise); PL016 "
                                 "demands one for non-loopback binds.")
        parser.add_argument("--no-coalesce", action="store_true",
                            help="Disable cross-tenant batch "
                                 "coalescing: every accepted "
                                 "/api/check runs its own device "
                                 "search instead of merging with "
                                 "queued strangers (default: "
                                 "coalescing on).")
        parser.add_argument("--coalesce-window-ms", type=float,
                            default=None, metavar="MS",
                            help="How long a submitted check may wait "
                                 "for batchmates before its device "
                                 "batch closes anyway (default 25; "
                                 "PL020 rejects non-positive "
                                 "values).")
        parser.add_argument("--coalesce-max-segments", type=int,
                            default=None, metavar="N",
                            help="Segments per coalesced device batch "
                                 "past which the batch closes early "
                                 "(default 32; PL020 rejects "
                                 "non-positive values).")
        parser.add_argument("--capacity-plan", default=None,
                            metavar="FILE",
                            help="A capacity_plan.json (from "
                                 "`campaign --capacity plan` or "
                                 "`tools/lint.py --matrix`) whose "
                                 "predicted (model, bucket) shapes "
                                 "pre-register on the coalescer, so "
                                 "first-window strangers land in "
                                 "planned compile shapes (PL021 "
                                 "rejects unreadable files).")

    def run_serve(options):
        raise NotImplementedError(
            "the serve subcommand (web UI and submission API) is not "
            "ported yet: ROADMAP.md A.11(d4)")

    return {"serve": {"opt-spec": add_opts, "opt-fn": lambda o: o,
                      "standalone": True, "run": run_serve,
                      "help": "Serve the web interface."}}


def run(subcommands, argv=None):
    """Parse arguments and dispatch to a subcommand (cli.clj:255-331).
    Exits 254 on bad usage, 255 on internal errors; subcommand run fns
    control success exit codes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s\t%(levelname)s\t%(name)s: %(message)s")
    command = argv[0] if argv else None
    if command not in subcommands:
        print("Usage: python -m jepsen_tpu_torch COMMAND [OPTIONS ...]")
        print("Commands:", ", ".join(sorted(subcommands)))
        sys.exit(254)
    spec = subcommands[command]
    parser = argparse.ArgumentParser(prog=f"jepsen_tpu_torch {command}")
    if not spec.get("standalone"):
        add_test_opts(parser)
    if spec.get("opt-spec"):
        spec["opt-spec"](parser)
    try:
        ns = parser.parse_args(argv[1:])
    except SystemExit as e:
        sys.exit(0 if e.code in (0, None) else 254)
    try:
        options = _ns_to_opts(ns)
        options["argv"] = argv
        opt_fn = spec.get("opt-fn") or test_opt_fn
        options = opt_fn(options)
        spec["run"](options)
        sys.exit(0)
    except SystemExit:
        raise
    except CliError as e:
        print(str(e), file=sys.stderr)
        sys.exit(254)
    except Exception:  # noqa: BLE001
        logger.critical("Oh jeez, I'm sorry, Jepsen broke. Here's why:\n%s",
                        traceback.format_exc())
        sys.exit(255)


def hard_main(main_fn):
    """Run a CLI ``main`` at the REAL process boundary (``__main__``
    blocks only) and exit via os._exit after flushing.

    A plain sys.exit runs interpreter teardown, and the competition's
    racer threads can still be running when a verdict is reached (the
    losers stop at their next chunk; ``checkers.join_racers``): a
    device racer torn down mid-launch at teardown can abort the runtime
    there, stomping the exit code the reference's CLI contract promises
    (0/1/2/254/255, cli.clj:129-139). All test artifacts are already on
    disk by then, so skipping teardown loses nothing. Tests call
    ``main`` directly and keep normal SystemExit semantics."""
    import os
    try:
        main_fn()
        code = 0
    except SystemExit as e:
        if e.code is None:           # bare sys.exit() = success
            code = 0
        elif isinstance(e.code, int):
            code = e.code
        else:                        # sys.exit("message")
            print(e.code, file=sys.stderr)
            code = 254
    except KeyboardInterrupt:
        code = 130
    except BaseException:  # noqa: BLE001 - teardown must not run
        traceback.print_exc()
        code = 255
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
