"""planlint: pre-flight validation of a test map, before any node
contact (the port's copy of the preflight path of
``jepsen_tpu/analysis/planlint.py``, host-only).

``core.run`` wires a whole protocol zoo together from one plain dict;
a malformed plan typically fails minutes in -- after SSH sessions, OS
and DB setup -- with a stack trace far from the mistake. This analyzer
checks the wiring statically: protocol conformance of
client/nemesis/checker, generator plausibility (including literal op
:f values against the model's supported op set), and concurrency /
process-count sanity.

Codes the test-map pass emits (the JAX package's docstring has the
full list):

  PL001 error    client missing or lacks a callable ``invoke``
  PL002 warning  client/nemesis partially implements its protocol
  PL003 error    nemesis lacks a callable ``invoke``
  PL004 error    checker lacks a callable ``check`` and is not callable
  PL005 error    generator has an unusable type
  PL006 error    concurrency is not a positive integer
  PL007 warning  node/concurrency mismatch (idle nodes, non-multiple)
  PL008 error    a literal generator op's :f is outside the model's op
                 set
  PL009 warning  a literal nemesis op's :f is not in ``nemesis.fs()``
  PL010 warning  non-positive time-limit / test-count
  PL011 warning  robustness knobs inconsistent
  PL013 mixed    streaming-monitor knobs
  PL015 mixed    searchplan preflight
  PL017 mixed    telemetry plane
  PL019 mixed    device introspection (--profile, progress cadence)
  PL022 mixed    phase attribution / perf trend gate
  PL023 mixed    verdict certification
  PL025 mixed    transactional monitor
  PL026 mixed    stream engine

The knob passes the campaign command runs on every invocation (the
JAX package's ``cli.py:842-873``):

  PL012 mixed    campaign sweep matrix (``lint_campaign``)
  PL014 mixed    fleet config (``lint_fleet``): workers, lease, backend
                 tiers (the port's: gpu, cpu), lease vs time-limit
  PL016 mixed    service robustness (``lint_service``): a non-loopback
                 --serve bind with no auth token, non-positive
                 admission budgets, queue-wait or artifact-sync timeout
                 (errors); a sync timeout at or past the lease (warning)
  PL018 mixed    fleetlint knob and the --resume journal gate
                 (``lint_fleetlint``)
  PL020 mixed    cross-tenant coalescing knobs (``lint_coalesce``)
  PL021 mixed    capacity-planning knobs (``lint_capacity``)
  PL024 mixed    coordinator-HA knobs (``lint_ha``)

``preflight(test)`` is the core.run hook: FATAL codes raise
``PlanLintError`` (opt out per test with ``test["preflight?"] =
False``); everything else is logged and recorded. The fleet lint
(PL014, ``lint_fleet``) runs with fleet knobs (``--workers``,
``--backends``) and inside ``fleet.run_fleet``; PL017's fleet half
(a trace merge with artifact sync off) rides ``lint_telemetry``. The
service lint (PL016, ``lint_service``) runs in the campaign preflight
with ``--serve`` or ``--workers``, inside ``fleet.run_fleet`` and before
``serve`` binds its socket. The capacity pass (PL021,
``lint_capacity``) runs in ``capplan.preflight`` (the campaign command
with ``--capacity``, ``--device-mem-budget`` or ``--device-slots auto``,
and ``fleet.run_fleet``) and before ``serve`` pre-registers a
``--capacity-plan``.
"""

from __future__ import annotations

import logging

from .diagnostics import ERROR, INFO, WARNING, diag, errors, render_text
from .histlint import model_op_set

logger = logging.getLogger(__name__)

__all__ = ["lint_plan", "lint_telemetry", "lint_introspection",
           "lint_trend", "lint_certify", "lint_campaign", "lint_fleet",
           "lint_service", "lint_coalesce", "lint_capacity",
           "lint_fleetlint", "lint_ha", "FLEETLINT_MODES", "preflight",
           "PlanLintError", "FATAL_CODES", "monitor_diags",
           "searchplan_diags", "robustness_knob_diags"]


#: error codes certain enough to abort the run before node contact
FATAL_CODES = {"PL001", "PL003", "PL004", "PL005", "PL006"}

_CLIENT_PROTOCOL = ("open", "setup", "invoke", "teardown", "close",
                    "reusable")
_NEMESIS_PROTOCOL = ("setup", "invoke", "teardown")


#: bind addresses that never leave the machine: PL016 demands a token
#: for any other --serve bind, PL017 for GET /api/metrics on one
_LOOPBACK_BINDS = ("127.0.0.1", "::1", "localhost")


class PlanLintError(ValueError):
    """A test plan failed preflight with fatal diagnostics."""

    def __init__(self, diags):
        self.diagnostics = diags
        super().__init__(render_text(diags, title="test plan preflight "
                                                  "failed:"))


def _callable_attr(obj, name):
    return callable(getattr(obj, name, None))


def lint_plan(test):
    """Lint a test map. Returns a list of Diagnostics (never raises)."""
    diags = []
    if not isinstance(test, dict):
        return [diag("PL005", ERROR, f"test plan is not a mapping: "
                                     f"{type(test).__name__}", "plan")]

    # -- client --------------------------------------------------------
    client = test.get("client")
    if client is None or not _callable_attr(client, "invoke"):
        diags.append(diag(
            "PL001", ERROR,
            "client is missing or has no callable invoke(test, op)",
            "plan.client",
            "provide a jepsen_tpu_torch.client.Client (client.noop for none)"))
    else:
        missing = [m for m in _CLIENT_PROTOCOL
                   if not _callable_attr(client, m)]
        if missing:
            diags.append(diag(
                "PL002", WARNING,
                f"client lacks protocol method(s) {missing}",
                "plan.client",
                "subclass jepsen_tpu_torch.client.Client to inherit the "
                "defaults"))

    # -- nemesis -------------------------------------------------------
    nemesis = test.get("nemesis")
    nemesis_fs = None
    if nemesis is not None:
        if not _callable_attr(nemesis, "invoke"):
            diags.append(diag(
                "PL003", ERROR,
                "nemesis has no callable invoke(test, op)",
                "plan.nemesis",
                "subclass jepsen_tpu_torch.nemesis.Nemesis (nemesis.noop for "
                "none)"))
        else:
            missing = [m for m in _NEMESIS_PROTOCOL
                       if not _callable_attr(nemesis, m)]
            if missing:
                diags.append(diag(
                    "PL002", WARNING,
                    f"nemesis lacks protocol method(s) {missing}",
                    "plan.nemesis"))
            try:
                fs = nemesis.fs() if _callable_attr(nemesis, "fs") \
                    else None
                nemesis_fs = set(fs) if fs else None
            except Exception:  # noqa: BLE001 - reflection is optional
                nemesis_fs = None

    # -- checker -------------------------------------------------------
    checker = test.get("checker")
    if checker is not None and not _callable_attr(checker, "check") \
            and not callable(checker):
        diags.append(diag(
            "PL004", ERROR,
            "checker has no callable check(test, history, opts) and is "
            "not itself callable",
            "plan.checker",
            "provide a jepsen_tpu_torch.checker.Checker (checker.noop() for "
            "none)"))

    # -- generator -----------------------------------------------------
    gen_ = test.get("generator")
    if not _generator_like(gen_):
        diags.append(diag(
            "PL005", ERROR,
            f"generator has unusable type {type(gen_).__name__}",
            "plan.generator",
            "use op dicts, callables, Generator combinators, or "
            "sequences thereof"))

    # -- concurrency / process counts ---------------------------------
    nodes = test.get("nodes") or []
    conc = test.get("concurrency", len(nodes))
    if not isinstance(conc, int) or isinstance(conc, bool) or conc <= 0:
        diags.append(diag(
            "PL006", ERROR,
            f"concurrency must be a positive integer, got {conc!r}",
            "plan.concurrency"))
    elif nodes:
        if conc < len(nodes):
            diags.append(diag(
                "PL007", WARNING,
                f"concurrency {conc} < {len(nodes)} nodes: "
                f"{len(nodes) - conc} node(s) never receive a client",
                "plan.concurrency",
                "use a multiple of the node count (e.g. \"1n\")"))
        elif conc % len(nodes):
            diags.append(diag(
                "PL007", WARNING,
                f"concurrency {conc} is not a multiple of the "
                f"{len(nodes)}-node count: client load is uneven",
                "plan.concurrency"))

    # -- literal generator ops vs model / nemesis op sets -------------
    model_fs = model_op_set(test)
    if model_fs is not None or nemesis_fs is not None:
        for op in _literal_ops(gen_):
            f = op.get("f")
            # nemesis literal ops carry {"type": "info"} (or an explicit
            # nemesis process); client ops are invokes or bare op maps
            is_nemesis = op.get("process") == "nemesis" \
                or op.get("type") == "info"
            if is_nemesis:
                if nemesis_fs is not None and f not in nemesis_fs:
                    diags.append(diag(
                        "PL009", WARNING,
                        f"nemesis op :f {f!r} is not in nemesis.fs() "
                        f"{sorted(map(str, nemesis_fs))}",
                        "plan.generator"))
            elif model_fs is not None and f is not None \
                    and op.get("type") in (None, "invoke") \
                    and f not in model_fs:
                diags.append(diag(
                    "PL008", ERROR,
                    f"generator emits op :f {f!r} outside the model's "
                    f"op set {sorted(map(str, model_fs))}",
                    "plan.generator",
                    "the linearizable checker cannot step this op"))

    # -- misc scalars --------------------------------------------------
    for key in ("time-limit", "test-count"):
        v = test.get(key)
        if v is not None and (not isinstance(v, (int, float))
                              or isinstance(v, bool) or v <= 0):
            diags.append(diag(
                "PL010", WARNING,
                f"{key} should be a positive number, got {v!r}",
                f"plan.{key}"))

    # -- robustness knobs (robust) --------------------------
    diags += robustness_knob_diags(test, "PL011", "plan")

    # -- streaming-monitor knobs (monitor) ------------------
    diags += monitor_diags(test)

    # -- search-plan knobs (analysis.searchplan) ------------
    diags += searchplan_diags(test)

    # -- telemetry-plane knobs (obs) ------------------------
    diags += lint_telemetry(
        {"telemetry-flush-ms": test.get("telemetry-flush-ms")})

    # -- device-introspection knobs (obs.search / obs.profile) ---------
    diags += lint_introspection(test)

    # -- phase-attribution / trend-gate knobs (obs.phases / obs.trend) -
    diags += lint_trend(test)

    # -- verdict-certification knobs (analysis/certify.py) -------------
    diags += lint_certify(test)
    return diags


def lint_introspection(cfg):
    """The PL019 rules over a test map's (or option map's) device
    introspection wiring: the ``--profile`` capture knobs and the
    progress-telemetry cadence. Works on plain option dicts too — the
    fleet dispatcher runs it over base options."""
    diags = []
    if not isinstance(cfg, dict):
        return diags
    if cfg.get("profile?"):
        if cfg.get("obs?") is False:
            diags.append(diag(
                "PL019", ERROR,
                "--profile with telemetry disabled (obs? False): the "
                "capture's crash-tolerant marker and web link anchor "
                "to the run's telemetry artifacts, which this run "
                "will not write",
                "plan.profile",
                "drop obs? False, or drop --profile"))
        pdir = cfg.get("profile-dir")
        if pdir is not None:
            import os
            pdir = str(pdir)
            parent = os.path.dirname(os.path.abspath(pdir))
            writable = (os.path.isdir(pdir)
                        and os.access(pdir, os.W_OK)) \
                or (not os.path.exists(pdir)
                    and os.path.isdir(parent)
                    and os.access(parent, os.W_OK))
            if not writable:
                diags.append(diag(
                    "PL019", ERROR,
                    f"profile-dir {pdir!r} is not a writable "
                    "directory (and cannot be created): the XLA "
                    "capture has nowhere to land",
                    "plan.profile-dir",
                    "point profile-dir at a writable location, or "
                    "drop it to use the run directory"))
        elif not cfg.get("name") and ("checker" in cfg
                                      or "client" in cfg):
            # only a REAL test map can be "unnamed": plain option
            # maps (campaign --lint, run_fleet base options) name
            # their cells at build time, so the check skips there
            diags.append(diag(
                "PL019", ERROR,
                "--profile on an unnamed test with no profile-dir: "
                "there is no run directory to persist the capture "
                "next to trace.jsonl",
                "plan.profile",
                "name the test or pass profile-dir"))
        pm = cfg.get("profile-max-s")
        if pm is not None and (not isinstance(pm, (int, float))
                               or isinstance(pm, bool) or pm <= 0):
            diags.append(diag(
                "PL019", WARNING,
                f"profile-max-s should be a positive number, got "
                f"{pm!r}: the default capture bound applies instead",
                "plan.profile-max-s"))
    pi = cfg.get("progress-interval-s")
    if pi is not None:
        if not isinstance(pi, (int, float)) or isinstance(pi, bool) \
                or pi <= 0:
            diags.append(diag(
                "PL019", WARNING,
                f"progress-interval-s should be a positive number, "
                f"got {pi!r}: progress telemetry keeps its "
                "per-dispatch default cadence",
                "plan.progress-interval-s"))
        else:
            from ..obs.search import HEARTBEAT_MIN_INTERVAL_S
            if pi < HEARTBEAT_MIN_INTERVAL_S:
                diags.append(diag(
                    "PL019", WARNING,
                    f"progress-interval-s {pi:g} is below the "
                    "heartbeat cadence "
                    f"({HEARTBEAT_MIN_INTERVAL_S:g} s): progress is "
                    "copied off-device at most once per host->device "
                    "dispatch, so a tighter interval cannot make the "
                    "telemetry any fresher",
                    "plan.progress-interval-s",
                    "drop the knob for per-dispatch cadence, or "
                    "raise it to thin the trace"))
    return diags


def lint_trend(cfg):
    """The PL022 rules over a test map's (or option map's) phase
    attribution and perf-trend-gate wiring. Works on plain option
    dicts too — the fleet dispatcher runs it over base options."""
    diags = []
    if not isinstance(cfg, dict):
        return diags
    if cfg.get("phases?") is False:
        if cfg.get("profile?"):
            diags.append(diag(
                "PL022", ERROR,
                "--profile with phase spans disabled (phases? False): "
                "the capture's device lanes cannot be attributed back "
                "to encode/plan/h2d/compile/device/d2h/host/wait "
                "without the per-dispatch phase spans",
                "plan.phases",
                "drop phases? False, or drop --profile"))
        if cfg.get("bubbles?"):
            diags.append(diag(
                "PL022", ERROR,
                "a bubble-ledger fold requested (bubbles?) with phase "
                "spans disabled (phases? False): the ledger is built "
                "from wgl.phase.* spans and would attribute nothing",
                "plan.phases",
                "drop phases? False, or drop bubbles?"))
    baseline = cfg.get("trend-baseline")
    if baseline is not None:
        import os
        bp = str(baseline)
        if not (os.path.isfile(bp) and os.access(bp, os.R_OK)):
            diags.append(diag(
                "PL022", ERROR,
                f"trend-baseline {bp!r} is not a readable file: the "
                "perf gate has nothing to compare against",
                "plan.trend-baseline",
                "point trend-baseline at a trend.jsonl written by "
                "'python -m jepsen_tpu_torch.obs.trend record'"))
        else:
            from ..obs import trend as obs_trend
            records = obs_trend.load(bp)
            here = obs_trend.fingerprint()
            mismatched = [r for r in records
                          if r.get("fingerprint")
                          and r["fingerprint"] != here]
            if records and len(mismatched) == len(records):
                diags.append(diag(
                    "PL022", WARNING,
                    "every trend-baseline record carries a "
                    "different environment fingerprint than this "
                    "host: the gate will refuse to compare "
                    "(regressions measured on different hardware "
                    "or torch builds are not regressions)",
                    "plan.trend-baseline",
                    "re-record the baseline on this host"))
    thresh = cfg.get("trend-gate-threshold")
    if thresh is not None and (not isinstance(thresh, (int, float))
                               or isinstance(thresh, bool)
                               or thresh <= 0):
        diags.append(diag(
            "PL022", ERROR,
            f"trend-gate-threshold should be a positive fraction, "
            f"got {thresh!r}: a non-positive allowance would flag "
            "every quiet-floor wiggle as a regression",
            "plan.trend-gate-threshold",
            "use a fraction like 0.2, or drop the knob for the "
            "default"))
    return diags


def searchplan_diags(test):
    """The PL015 rules over a test map's (or option map's) searchplan
    wiring. Works on plain option dicts too — the fleet dispatcher
    runs it over base options, where checker-based checks just
    skip."""
    diags = []
    if not isinstance(test, dict):
        return diags
    from .searchplan import PREDICATES
    names = test.get("searchplan-partitions")
    if names is not None:
        unknown = [str(n) for n in names if str(n) not in PREDICATES]
        if unknown:
            diags.append(diag(
                "PL015", ERROR,
                f"unknown partition predicate name(s) {unknown}: known "
                f"predicates are {list(PREDICATES)}",
                "plan.searchplan-partitions",
                "the planner skips unknown names at run time, silently "
                "losing the reduction"))
    ms = test.get("searchplan-min-segment")
    if ms is not None and (not isinstance(ms, int)
                           or isinstance(ms, bool) or ms <= 0):
        diags.append(diag(
            "PL015", WARNING,
            f"searchplan-min-segment should be a positive integer, "
            f"got {ms!r}: the default applies instead",
            "plan.searchplan-min-segment"))
    explicit_on = test.get("searchplan?") is True \
        or bool(test.get("searchplan-partitions"))
    if explicit_on and test.get("checker") is not None:
        plannable = True
        try:
            from ..monitor.core import find_linearizable
            lin, _keyed = find_linearizable(test.get("checker"))
            plannable = lin is not None and bool(
                getattr(getattr(lin, "spec", None), "f_codes", None))
        except Exception:  # noqa: BLE001 - reflection is best-effort
            plannable = True
        if not plannable:
            diags.append(diag(
                "PL015", WARNING,
                "searchplan explicitly enabled but the checker tree "
                "has no linearizable gate with a model f_codes map: "
                "there is nothing to plan, the knob is a no-op",
                "plan.searchplan",
                "searchplan plans histories checked by "
                "checkers.linearizable (directly, composed, or under "
                "independent)"))
    if test.get("monitor"):
        from ..monitor import config as monitor_config
        from .searchplan import segments_enabled
        cfg = monitor_config(test) or {}
        carry_off = cfg.get("quiescent-carry?") is False \
            or not segments_enabled(test)
        if carry_off:
            diags.append(diag(
                "PL015", WARNING,
                "the monitor is armed without quiescent-cut carry: "
                "crash-free monitored runs re-check the ever-growing "
                "prefix (O(prefix) per chunk) instead of the open "
                "window",
                "plan.monitor",
                "drop {'quiescent-carry?': False} / re-enable "
                "searchplan unless you are debugging the carry "
                "itself"))
        if cfg.get("skip-offline?") and not carry_off:
            diags.append(diag(
                "PL015", WARNING,
                "skip-offline? records the monitor verdict as final "
                "while quiescent-cut carry truncates what the monitor "
                "re-checks: the offline re-check that normally "
                "backstops the carry is gone, so the verdict rests on "
                "the stream-cut rule alone",
                "plan.monitor",
                "drop 'skip-offline?' (keep the offline re-check) or "
                "set {'quiescent-carry?': False} alongside it"))
    return diags


def lint_certify(test):
    """The PL023 rules over a test map's (or option map's) verdict
    certification knobs (analysis/certify.py)."""
    diags = []
    raw = test.get("certify")
    opted_out = test.get("certify?") is False
    if isinstance(raw, dict):
        if opted_out:
            diags.append(diag(
                "PL023", WARNING,
                "certify knobs are set but certification is opted "
                "out (certify? False): the knobs are ignored",
                "plan.certify",
                "drop test['certify?'] = False or the knob block"))
        samples = raw.get("samples")
        if samples is not None and (not isinstance(samples, int)
                                    or isinstance(samples, bool)
                                    or samples <= 0):
            diags.append(diag(
                "PL023", ERROR,
                "certify differential sample count must be a "
                f"positive integer, got {samples!r}",
                "plan.certify.samples",
                "how many encoded segments the differential harness "
                f"replays per run (default "
                f"{_certify_default('DEFAULT_SAMPLES')}); omit the "
                "key for the default, or set certify? False to skip "
                "certification entirely"))
        budget = raw.get("budget")
        if budget is not None and (not isinstance(budget, int)
                                   or isinstance(budget, bool)
                                   or budget <= 0):
            diags.append(diag(
                "PL023", ERROR,
                "certify cross-check budget must be a positive "
                f"integer (configs), got {budget!r}",
                "plan.certify.budget",
                "the bounded CPU re-decision of a failing segment "
                "explores at most this many configurations (default "
                f"{_certify_default('DEFAULT_BUDGET')})"))
    elif raw is not None:
        diags.append(diag(
            "PL023", ERROR,
            f"certify knobs must be a mapping, got {raw!r}",
            "plan.certify"))
    if not opted_out:
        mon = test.get("monitor")
        cfg = mon if isinstance(mon, dict) else {}
        if cfg.get("skip-offline?"):
            diags.append(diag(
                "PL023", INFO,
                "skip-offline? hands the monitor's verdict over as "
                "final: verdict certification is the ONLY independent "
                "check of that verdict on this path (the violation "
                "evidence is cross-checked through a second engine at "
                "analyze time)", "plan.monitor",
                "keep certification on (the default) when combining "
                "skip-offline? with the monitor"))
    return diags


def _certify_default(name):
    from . import certify as _c
    return getattr(_c, name)


def monitor_diags(test):
    """The PL013 rules over a test map's monitor wiring."""
    diags = []
    mon = test.get("monitor")
    if not mon:
        if test.get("monitor-chunk") is not None:
            diags.append(diag(
                "PL013", WARNING,
                f"monitor-chunk {test['monitor-chunk']!r} is set but "
                "the monitor is off: the knob is ignored",
                "plan.monitor-chunk",
                "enable the monitor (--monitor / test['monitor']) or "
                "drop the knob"))
        return diags
    from .. import monitor as jmonitor
    from ..monitor import engine as mengine
    cfg = jmonitor.config(test) or {}
    chunk = cfg.get("chunk")
    if chunk is not None and (not isinstance(chunk, int)
                              or isinstance(chunk, bool) or chunk <= 0):
        diags.append(diag(
            "PL013", ERROR,
            f"monitor chunk must be a positive integer, got {chunk!r}",
            "plan.monitor.chunk",
            "the monitor batches this many completed ops per "
            "incremental check (default 64)"))
    if cfg.get("family") == "txn":
        diags += _txn_monitor_diags(test, cfg)
        return diags
    engine = cfg.get("engine")
    if engine is not None and engine not in mengine.ENGINES:
        diags.append(diag(
            "PL013", WARNING,
            f"monitor engine {engine!r} is not one of "
            f"{list(mengine.ENGINES)}: the monitor will fall back to "
            "its default",
            "plan.monitor.engine"))
    if engine == "streamlin":
        diags += _stream_engine_diags(test, cfg)
    checker = test.get("checker")
    if checker is not None:
        try:
            lin, _keyed = jmonitor.find_linearizable(checker)
        except Exception:  # noqa: BLE001 - reflection is best-effort
            lin = True
        if lin is None:
            diags.append(diag(
                "PL013", WARNING,
                "monitor requested but the checker tree has no "
                "linearizable gate: this checker family (e.g. the "
                "cycle checker) has no incremental engine, so the "
                "monitor will disable itself at runtime",
                "plan.monitor",
                "for transactional workloads set monitor family "
                '"txn" (the streaming cycle engine); otherwise '
                "monitor workloads checked by checkers.linearizable "
                "(directly, composed, or under independent)"))
    ot = test.get("op-timeout-ms")
    if isinstance(ot, (int, float)) and not isinstance(ot, bool) \
            and ot > 0:
        diags.append(diag(
            "PL013", WARNING,
            f"op-timeout-ms {ot:g} is armed alongside the monitor: "
            "every harness-timeout op becomes :info and stays "
            "permanently open in the monitor's incremental encoding, "
            "growing each chunk check (same class of interaction "
            "PL011 flags against the run deadline)",
            "plan.monitor",
            "prefer fixing wedged clients over monitoring around "
            "them, or raise the op timeout"))
    return diags


def _stream_engine_diags(test, cfg):
    """The PL026 rules over an ``engine: "streamlin"`` monitor config
    (the device-resident configuration frontier, monitor/wgl_stream.py).

    The stream engine's knobs bound DEVICE tensors, so garbage values
    don't just waste work -- an absurd frontier-cap either can't
    allocate or silently pins the engine in its flat fall-back, and a
    carry-less stream pays the exact O(prefix) re-search the engine
    exists to delete on every contained fall-back."""
    diags = []
    from .. import monitor as jmonitor
    from ..checker import streamlin

    opts = cfg.get("engine-opts") or {}
    cap = opts.get("frontier-cap")
    if cap is not None:
        if not isinstance(cap, int) or isinstance(cap, bool) \
                or cap <= 0:
            diags.append(diag(
                "PL026", ERROR,
                f"streamlin frontier-cap must be a positive integer, "
                f"got {cap!r}",
                "plan.monitor.engine-opts.frontier-cap",
                "the cap bounds the device-resident config-set tensor "
                f"(default {streamlin.DEFAULT_FRONTIER_CAP}); the "
                "engine pow-2-grows toward it and falls back to the "
                "flat re-search past it"))
        elif cap > streamlin.FRONTIER_CAP_MAX:
            diags.append(diag(
                "PL026", ERROR,
                f"streamlin frontier-cap {cap} exceeds the engine "
                f"maximum {streamlin.FRONTIER_CAP_MAX}: the frontier "
                "tensor is (cap, window/32) uint32 PER STREAM and "
                "keyed tests hold one stream per key",
                "plan.monitor.engine-opts.frontier-cap",
                "histories needing frontiers this wide belong on the "
                "offline engine's budgets, not in a monitor chunk"))
    wcap = opts.get("window-cap")
    if wcap is not None and (not isinstance(wcap, int)
                             or isinstance(wcap, bool) or wcap <= 0
                             or wcap & (wcap - 1)):
        diags.append(diag(
            "PL026", WARNING,
            f"streamlin window-cap should be a positive power of two, "
            f"got {wcap!r}: the engine rounds it up (window words are "
            "32 slots and growth doubles)",
            "plan.monitor.engine-opts.window-cap"))
    checker = test.get("checker")
    if checker is not None:
        try:
            lin, _keyed = jmonitor.find_linearizable(checker)
        except Exception:  # noqa: BLE001 - reflection is best-effort
            lin = True
        if lin is None:
            diags.append(diag(
                "PL026", ERROR,
                "engine streamlin on a checker tree with no "
                "linearizable gate: there is no configuration "
                "frontier to keep device-resident and the monitor "
                "will disable itself at runtime",
                "plan.monitor.engine",
                "monitor a linearizable workload, or for "
                'transactional families use monitor family "txn" '
                "(its own incremental frontier)"))
    if cfg.get("quiescent-carry?") is False:
        diags.append(diag(
            "PL026", WARNING,
            "engine streamlin with quiescent-carry explicitly off: "
            "the device frontier stays O(window), but every contained "
            "fall-back and violation confirm re-searches the "
            "UNBOUNDED materialized prefix -- the exact O(prefix) "
            "cost the stream engine exists to delete",
            "plan.monitor.quiescent-carry?",
            "leave the carry on (the default) so flat fall-backs stay "
            "bounded by the open window"))
    return diags


def _txn_monitor_diags(test, cfg):
    """The PL025 rules over a ``family: "txn"`` monitor config.

    The transactional family has its own streaming engine
    (monitor/txn.py), so none of the WGL-specific PL013 rules apply
    -- but the txn knobs have their own failure modes: anomaly names
    the cycle engine has never heard of are silently never detected,
    *-realtime / *-process classes need their edge-inference flag on,
    and pointing the txn monitor at a register-model test compares
    verdicts across incompatible encodings."""
    diags = []
    from .. import monitor as jmonitor
    from ..cycle import DEFAULT_ANOMALIES, PROCESS_ANOMALIES
    from ..monitor import engine as mengine

    workload = cfg.get("workload", "append")
    if workload not in mengine.TXN_WORKLOADS:
        diags.append(diag(
            "PL025", ERROR,
            f"unknown txn workload {workload!r}: known "
            f"{list(mengine.TXN_WORKLOADS)}",
            "plan.monitor.workload"))

    known = set(DEFAULT_ANOMALIES) | set(PROCESS_ANOMALIES)
    anomalies = cfg.get("anomalies")
    requested = ()
    if anomalies is not None:
        if not isinstance(anomalies, (list, tuple)) \
                or not all(isinstance(a, str) for a in anomalies):
            diags.append(diag(
                "PL025", ERROR,
                f"txn anomalies must be a list of names, got "
                f"{anomalies!r}",
                "plan.monitor.anomalies"))
        else:
            requested = tuple(anomalies)
            unknown = sorted(set(requested) - known)
            if unknown:
                diags.append(diag(
                    "PL025", ERROR,
                    f"unknown txn anomaly name(s) {unknown}: the "
                    "cycle engine would silently never detect them "
                    f"(known: {sorted(known)})",
                    "plan.monitor.anomalies"))
    rt_req = [a for a in requested if a.endswith("-realtime")]
    if rt_req and cfg.get("realtime") is False:
        diags.append(diag(
            "PL025", ERROR,
            f"realtime edge inference is off but {rt_req} are "
            "requested: without RT edges these classes can never "
            "cycle",
            "plan.monitor.realtime",
            "drop realtime: False or the *-realtime anomaly classes"))
    proc_req = [a for a in requested if a.endswith("-process")]
    if proc_req and not cfg.get("process"):
        diags.append(diag(
            "PL025", ERROR,
            f"per-process edge inference is off (the default) but "
            f"{proc_req} are requested: without process edges these "
            "classes can never cycle",
            "plan.monitor.process",
            "set monitor process: True alongside *-process classes"))

    checker = test.get("checker")
    if checker is not None:
        try:
            lin, _keyed = jmonitor.find_linearizable(checker)
        except Exception:  # noqa: BLE001 - reflection is best-effort
            lin = None
        if lin is not None:
            diags.append(diag(
                "PL025", ERROR,
                'monitor family "txn" on a test whose checker tree '
                "carries a Linearizable gate: the register model "
                "encodes [f k v] reads/writes, the txn engine "
                "encodes micro-op transactions -- the streaming "
                "verdict would not be comparable to the offline one",
                "plan.monitor.family",
                "drop the family override (the WGL monitor handles "
                "register models) or switch the workload to the "
                "transactional suite"))

    skew = cfg.get("skew-bound", cfg.get("skew_bound"))
    if skew is not None and (not isinstance(skew, (int, float))
                             or isinstance(skew, bool) or skew < 0):
        diags.append(diag(
            "PL025", WARNING,
            f"txn skew-bound should be a non-negative number of "
            f"nanoseconds, got {skew!r}: the default (0: trust "
            "realtime stamps exactly) applies instead",
            "plan.monitor.skew-bound"))
    return diags


def robustness_knob_diags(params, code, where):
    """The PL011 numeric rules over one params mapping, emitted under
    ``code`` at location prefix ``where`` -- shared by the per-test
    preflight (PL011) and the campaign matrix pass (PL012, which runs
    them per expanded cell)."""
    diags = []

    def _num(key):
        v = params.get(key)
        if v is None:
            return None
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or v <= 0:
            diags.append(diag(
                code, WARNING,
                f"{key} should be a positive number, got {v!r} "
                "(non-positive values disable the feature, probably "
                "unintentionally)",
                f"{where}.{key}"))
            return None
        return v

    op_timeout_ms = _num("op-timeout-ms")
    time_limit_s = _num("time-limit-s")
    _num("abort-grace-s")
    if op_timeout_ms is not None and time_limit_s is not None \
            and op_timeout_ms >= time_limit_s * 1000:
        diags.append(diag(
            code, WARNING,
            f"op-timeout-ms {op_timeout_ms} >= time-limit-s "
            f"{time_limit_s} ({time_limit_s * 1000:g} ms): the "
            "wedged-worker watchdog can never fire before the whole-run "
            "deadline aborts the test",
            f"{where}.op-timeout-ms"))
    return diags


def lint_campaign(matrix, cells):
    """PL012: validate an expanded campaign sweep (campaign/plan.py
    hands in the normalized matrix plus its expansion). Errors:
    empty matrix / empty axis, duplicate cell ids. Warnings: seed
    collisions in the seed axis, and per-cell robustness knobs that
    trip the PL011 rules (reported per offending cell, capped)."""
    diags = []
    axes = (matrix or {}).get("axes") or {}
    if not axes:
        return [diag("PL012", ERROR,
                     "campaign matrix has no axes: nothing to run",
                     "campaign.axes",
                     "give at least one axis (or a seeds count)")]
    for name, values in axes.items():
        if not values:
            diags.append(diag(
                "PL012", ERROR,
                f"campaign axis {name!r} has no values",
                f"campaign.axes.{name}"))
    seeds = axes.get("seed")
    if seeds is not None and len(set(map(repr, seeds))) < len(seeds):
        diags.append(diag(
            "PL012", WARNING,
            f"seed axis has colliding values {seeds!r}: duplicate "
            "seeds rerun identical cells and break flake attribution",
            "campaign.axes.seed"))
    seen, dups = set(), []
    for cell in cells:
        cid = cell.get("id")
        if cid in seen:
            dups.append(cid)
        seen.add(cid)
    if dups:
        diags.append(diag(
            "PL012", ERROR,
            f"duplicate cell id(s) {sorted(set(dups))}: axis values "
            "collapse to the same id, so the journal cannot tell the "
            "cells apart",
            "campaign.axes",
            "make axis values distinct after id sanitization"))
    knob_hits = 0
    for cell in cells:
        cell_diags = robustness_knob_diags(
            cell.get("params") or {}, "PL012",
            f"campaign.cell[{cell.get('id')}]")
        if cell_diags and knob_hits < 8:
            diags += cell_diags
        knob_hits += bool(cell_diags)
    if knob_hits > 8:
        diags.append(diag(
            "PL012", WARNING,
            f"{knob_hits - 8} further cell(s) with inconsistent "
            "robustness knobs suppressed",
            "campaign.cells"))
    return diags


def lint_fleet(cfg):
    """PL014: preflight one fleet config mapping before any host is
    contacted. Recognized keys: ``workers`` (list of worker ids),
    ``lease-s``, ``serve?``, ``device-slots``, ``backends`` (tier
    names, optional), ``time-limit`` (the per-cell run budget the
    lease must outlive)."""
    diags = []
    cfg = cfg or {}
    workers = cfg.get("workers")
    if workers is not None:
        workers = list(workers)
        if not workers:
            diags.append(diag(
                "PL014", ERROR,
                "fleet has no workers: nothing can lease a cell",
                "fleet.workers",
                "pass --workers host1,host2 (or 'local' for loopback "
                "worker processes)"))
        if any(not str(w).strip() for w in workers):
            diags.append(diag(
                "PL014", ERROR,
                "fleet has empty worker id(s)",
                "fleet.workers"))
        dups = sorted({str(w) for w in workers
                       if workers.count(w) > 1})
        if dups:
            diags.append(diag(
                "PL014", ERROR,
                f"duplicate worker id(s) {dups}: lease records could "
                "not name which worker holds a cell",
                "fleet.workers",
                "give repeated hosts distinct ids (name=host)"))
    lease = cfg.get("lease-s")
    if lease is not None and (not isinstance(lease, (int, float))
                              or isinstance(lease, bool) or lease <= 0):
        diags.append(diag(
            "PL014", ERROR,
            f"lease-s must be a positive number, got {lease!r}",
            "fleet.lease-s",
            "the lease is the worker-death detection bound; "
            "non-positive means instant theft of every cell"))
        lease = None
    if cfg.get("serve?"):
        slots = cfg.get("device-slots")
        if slots is not None and (not isinstance(slots, int)
                                  or isinstance(slots, bool)
                                  or slots <= 0):
            diags.append(diag(
                "PL014", ERROR,
                f"--serve with {slots!r} device slots: submitted "
                "checks could never acquire a device",
                "fleet.device-slots",
                "a serving fleet needs at least one device slot"))
    tiers = cfg.get("backends")
    if tiers is not None:
        from ..fleet import backends as fbackends
        unknown = [t for t in tiers if str(t) not in fbackends.TIERS]
        if unknown:
            diags.append(diag(
                "PL014", ERROR,
                f"unknown backend tier name(s) {unknown}: known tiers "
                f"are {list(fbackends.TIERS)}",
                "fleet.backends"))
    tl = cfg.get("time-limit")
    if lease is not None and isinstance(tl, (int, float)) \
            and not isinstance(tl, bool) and 0 < tl and lease < tl:
        diags.append(diag(
            "PL014", WARNING,
            f"lease-s {lease:g} < cell time-limit {tl:g}: every "
            "healthy cell outlives its own lease, so the dispatcher "
            "steals and re-runs work that was never stuck",
            "fleet.lease-s",
            "set the lease comfortably above the cell budget "
            "(time-limit plus setup/check headroom)"))
    return diags


def lint_service(cfg):
    """PL016: fleet/service robustness preflight, before any socket is
    bound or artifact synced. Recognized keys: ``serve?``,
    ``serve-ip`` (the bind address), ``auth-token?`` (whether any
    token is configured), ``budgets`` (the service.Admission budget
    mapping), ``queue-wait-s``, ``sync-timeout-s``, and ``lease-s``
    (for the sync-vs-lease warning)."""
    diags = []
    cfg = cfg or {}
    if cfg.get("serve?"):
        ip = cfg.get("serve-ip")
        # an unset bind means the historical default 0.0.0.0: the
        # most exposed case, not an excuse to skip the check
        if str(ip or "0.0.0.0") not in _LOOPBACK_BINDS \
                and not cfg.get("auth-token?"):
            diags.append(diag(
                "PL016", ERROR,
                f"--serve binds {ip or '0.0.0.0'!r} (non-loopback) "
                "with no auth token: anyone who can reach the port "
                "can submit NP-hard checks and campaigns",
                "service.auth-token",
                "pass --auth-token (or bind 127.0.0.1)"))
    budgets = cfg.get("budgets")
    if isinstance(budgets, dict):
        for k in ("concurrent-checks", "queue-depth", "campaigns",
                  "ops-per-day"):
            v = budgets.get(k)
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                diags.append(diag(
                    "PL016", ERROR,
                    f"service budget {k!r} must be a positive "
                    f"integer, got {v!r}",
                    f"service.budgets.{k}",
                    "a zero/negative budget rejects every request; "
                    "omit the key for the default"))
    qw = cfg.get("queue-wait-s")
    if qw is not None and (not isinstance(qw, (int, float))
                           or isinstance(qw, bool) or qw <= 0):
        diags.append(diag(
            "PL016", ERROR,
            f"queue-wait-s must be a positive number, got {qw!r}",
            "service.queue-wait-s"))
    st = cfg.get("sync-timeout-s")
    if st is not None and (not isinstance(st, (int, float))
                           or isinstance(st, bool) or st <= 0):
        diags.append(diag(
            "PL016", ERROR,
            f"sync-timeout-s must be a positive number, got {st!r}",
            "fleet.sync-timeout-s",
            "the artifact-sync wall bound is what keeps a wedged "
            "download from wedging the coordinator"))
        st = None
    lease = cfg.get("lease-s")
    if st is not None and isinstance(lease, (int, float)) \
            and not isinstance(lease, bool) and 0 < lease <= st:
        diags.append(diag(
            "PL016", WARNING,
            f"sync-timeout-s {st:g} >= lease-s {lease:g}: syncing a "
            "finished cell holds its lease open longer than the "
            "worker-death detection bound itself",
            "fleet.sync-timeout-s",
            "keep the artifact-sync budget well under the lease TTL"))
    return diags


def lint_coalesce(cfg):
    """PL020: cross-tenant coalescing preflight, before any batcher
    thread starts. Recognized keys: ``coalesce?`` (whether queued
    /api/check submissions merge into padded device batches),
    ``coalesce-window-ms``, ``coalesce-max-segments``,
    ``device-slots``, and ``engine`` (a configured default check
    engine, when the option map carries one)."""
    diags = []
    cfg = cfg or {}
    w = cfg.get("coalesce-window-ms")
    if w is not None and (not isinstance(w, (int, float))
                          or isinstance(w, bool) or w <= 0):
        diags.append(diag(
            "PL020", ERROR,
            f"coalesce-window-ms must be a positive number, got "
            f"{w!r}",
            "service.coalesce-window-ms",
            "the window is how long a submission waits for strangers "
            "to batch with; omit the knob for the 25 ms default"))
    m = cfg.get("coalesce-max-segments")
    if m is not None and (not isinstance(m, int)
                          or isinstance(m, bool) or m <= 0):
        diags.append(diag(
            "PL020", ERROR,
            f"coalesce-max-segments must be a positive integer, got "
            f"{m!r}",
            "service.coalesce-max-segments",
            "the cap bounds the batch's key axis (and the blast "
            "radius of one batch failure); omit it for the default"))
    if cfg.get("coalesce?"):
        slots = cfg.get("device-slots")
        if isinstance(slots, int) and not isinstance(slots, bool) \
                and slots == 0:
            diags.append(diag(
                "PL020", WARNING,
                "coalescing enabled with zero device slots: submitted "
                "checks never reach a device, so there is nothing to "
                "batch",
                "service.coalesce",
                "give the serving fleet at least one device slot, or "
                "drop --coalesce"))
        eng = cfg.get("engine")
        if eng is not None and str(eng) != "jax-wgl":
            diags.append(diag(
                "PL020", WARNING,
                f"coalescing enabled but the configured engine is "
                f"{eng!r}: only jax-wgl submissions batch (the CPU "
                "engines have no key axis), so every check takes the "
                "solo path and the knob is a no-op",
                "service.coalesce"))
    return diags


#: the --fleetlint knob's legal values: "on" audits the campaign at
#: finalize AND preflights --resume; "off" skips both
FLEETLINT_MODES = ("on", "off")


def lint_fleetlint(cfg):
    """PL018: the fleetlint gate. Recognized keys: ``fleetlint`` (the
    knob value), ``resume?``, and ``journal-diags`` (the Diagnostic
    list fleetlint.preflight produced over the journal about to be
    resumed). An error-severity journal finding under --resume is a
    refusal: the resume fold (skip-terminal, re-run-aborted) is only
    sound over a journal with one writer and one terminal record per
    cell, so resuming a journal that fails that subset would build new
    state on corrupt truth. Each refusal names the offending cell in
    its location so the operator knows what to quarantine."""
    diags = []
    cfg = cfg or {}
    mode = cfg.get("fleetlint")
    if mode is not None and str(mode) not in FLEETLINT_MODES:
        diags.append(diag(
            "PL018", ERROR,
            f"unknown --fleetlint value {mode!r}: known modes are "
            f"{list(FLEETLINT_MODES)}",
            "fleet.fleetlint",
            "'on' (default) audits the campaign at finalize and "
            "preflights --resume; 'off' skips both"))
    if cfg.get("resume?"):
        for d in cfg.get("journal-diags") or []:
            if d.severity != ERROR:
                continue
            diags.append(diag(
                "PL018", ERROR,
                f"--resume over a journal that fails the fleetlint "
                f"preflight ({d.code}): {d.message}",
                d.location,
                d.fix_hint or "repair or quarantine the offending "
                              "cell's records before resuming"))
    return diags


def lint_ha(cfg):
    """PL024: coordinator-HA preflight (fleet/ha.py), before any lease
    is claimed or standby started. Recognized keys: ``ha?`` (whether a
    coordinator lease will be claimed), ``coordinator-lease-s``,
    ``takeover-grace-s``, ``renew-interval-s`` (the renewal heartbeat
    period, when explicitly configured), ``standby?`` +
    ``store-reachable?`` (a standby needs a journal it can tail), and
    ``chaos-coordinator-kill?`` (whether coordinator-kill chaos is
    scheduled). The failover math is checked statically: a renewal
    interval at or beyond the lease TTL guarantees self-fencing, and a
    coordinator-kill with HA off guarantees a hung campaign -- both
    are cheaper to refuse here than to soak-test into."""
    diags = []
    cfg = cfg or {}
    lease = cfg.get("coordinator-lease-s")
    if lease is not None and (not isinstance(lease, (int, float))
                              or isinstance(lease, bool) or lease <= 0):
        diags.append(diag(
            "PL024", ERROR,
            f"--coordinator-lease-s must be a positive number, got "
            f"{lease!r}",
            "ha.coordinator-lease-s",
            "the coordinator lease TTL is the coordinator-death "
            "detection bound; non-positive means every standby fences "
            "a live coordinator instantly"))
        lease = None
    grace = cfg.get("takeover-grace-s")
    if grace is not None and (not isinstance(grace, (int, float))
                              or isinstance(grace, bool) or grace <= 0):
        diags.append(diag(
            "PL024", ERROR,
            f"--takeover-grace-s must be a positive number, got "
            f"{grace!r}",
            "ha.takeover-grace-s",
            "the grace pad absorbs renewal jitter and clock skew "
            "before a standby fences; omit the flag for the default"))
    renew = cfg.get("renew-interval-s")
    if renew is not None and (not isinstance(renew, (int, float))
                              or isinstance(renew, bool) or renew <= 0):
        diags.append(diag(
            "PL024", ERROR,
            f"coordinator renew interval must be a positive number, "
            f"got {renew!r}",
            "ha.renew-interval-s"))
        renew = None
    if renew is not None and lease is not None and renew >= lease:
        diags.append(diag(
            "PL024", ERROR,
            f"coordinator renew interval {renew:g}s >= lease TTL "
            f"{lease:g}s: the coordinator cannot renew its own lease "
            "before it expires, so a healthy coordinator is fenced by "
            "the first standby to look",
            "ha.renew-interval-s",
            "keep the renewal period well under the lease TTL "
            "(fleet.ha renews every TTL/3 by default)"))
    if cfg.get("standby?") and cfg.get("store-reachable?") is False:
        diags.append(diag(
            "PL024", ERROR,
            "--standby with no reachable campaign store: a standby is "
            "a journal tail, and there is no journal to tail",
            "ha.standby",
            "point --store-dir at the shared store the active "
            "coordinator writes (NFS mount, shared volume), or start "
            "the standby on the coordinator's host"))
    if cfg.get("chaos-coordinator-kill?") and not cfg.get("ha?"):
        diags.append(diag(
            "PL024", ERROR,
            "coordinator-kill chaos with HA off: the kill would "
            "SIGKILL the only coordinator and nothing could ever "
            "fence the corpse or finish the campaign",
            "ha.chaos",
            "pass --coordinator-lease-s (and run a --standby) so a "
            "takeover can survive the kill, or drop the "
            "coordinator-kill fault"))
    cell_lease = cfg.get("lease-s")
    if lease is not None and isinstance(cell_lease, (int, float)) \
            and not isinstance(cell_lease, bool) \
            and 0 < cell_lease <= lease:
        diags.append(diag(
            "PL024", WARNING,
            f"coordinator-lease-s {lease:g} >= cell lease-s "
            f"{cell_lease:g}: detecting a dead coordinator takes "
            "longer than detecting a dead worker, so every in-flight "
            "cell lease expires before the standby takes over",
            "ha.coordinator-lease-s",
            "keep the coordinator lease TTL under the cell lease so "
            "takeover wins the race against mass cell expiry"))
    return diags


def lint_capacity(cfg):
    """PL021: capacity-planning preflight (analysis/capplan.py),
    before any plan is built or cell run. Recognized keys:
    ``capacity`` (the --capacity mode), ``device-mem-budget``
    (bytes), ``device-slots`` (an int or the literal "auto"),
    ``unknown-cells`` (how many cells the built plan could not model,
    for the enforce warning), and ``capacity-plan-file`` (a persisted
    capacity_plan.json path the serve subcommand pre-registers
    coalescer buckets from)."""
    diags = []
    cfg = cfg or {}
    mode = cfg.get("capacity")
    if mode is not None:
        from .capplan import CAPACITY_MODES
        if str(mode) not in CAPACITY_MODES:
            diags.append(diag(
                "PL021", ERROR,
                f"unknown --capacity mode {mode!r}: known modes are "
                f"{list(CAPACITY_MODES)}",
                "capacity.mode",
                "'plan' persists capacity_plan.json, 'warn' also "
                "prints the table, 'enforce' refuses on CP/PL021 "
                "errors"))
            mode = None
    budget = cfg.get("device-mem-budget")
    if budget is not None and (not isinstance(budget, (int, float))
                               or isinstance(budget, bool)
                               or budget <= 0):
        diags.append(diag(
            "PL021", ERROR,
            f"--device-mem-budget must be a positive byte count, got "
            f"{budget!r}",
            "capacity.device-mem-budget",
            "pass the device's usable HBM in bytes (suffixes K/M/G "
            "accepted on the CLI)"))
        budget = None
    slots = cfg.get("device-slots")
    slots_auto = isinstance(slots, str) and slots.strip() == "auto"
    if str(mode) == "enforce" and budget is None:
        diags.append(diag(
            "PL021", ERROR,
            "--capacity enforce with no --device-mem-budget: the HBM "
            "half of enforcement has nothing to enforce against",
            "capacity.device-mem-budget",
            "pass --device-mem-budget, or use --capacity warn"))
    if slots_auto and budget is None:
        diags.append(diag(
            "PL021", ERROR,
            "--device-slots auto with no --device-mem-budget: the "
            "slot count derives from budget // peak cell footprint",
            "capacity.device-slots",
            "pass --device-mem-budget alongside --device-slots auto"))
    if budget is not None and mode is None and not slots_auto:
        diags.append(diag(
            "PL021", WARNING,
            "--device-mem-budget is set but no --capacity mode (or "
            "--device-slots auto) consumes it: the knob is ignored",
            "capacity.device-mem-budget",
            "pass --capacity plan|warn|enforce, or drop the budget"))
    unknown = cfg.get("unknown-cells")
    if str(mode) == "enforce" and isinstance(unknown, int) \
            and not isinstance(unknown, bool) and unknown > 0:
        diags.append(diag(
            "PL021", WARNING,
            f"--capacity enforce over a matrix with {unknown} "
            "unknown-shape cell(s): enforcement only covers the cells "
            "the planner can see",
            "capacity.enforce",
            "register shape models (capplan.register_shapes) for the "
            "unknown workloads, or use --capacity warn"))
    pf = cfg.get("capacity-plan-file")
    if pf is not None:
        from .capplan import load_plan
        if load_plan(str(pf)) is None:
            diags.append(diag(
                "PL021", ERROR,
                f"--capacity-plan {pf!r} is not a readable "
                "capacity_plan.json: there are no planned buckets to "
                "pre-register",
                "capacity.plan-file",
                "point it at a capacity_plan.json produced by "
                "`campaign --capacity plan` or `python -m "
                "jepsen_tpu_torch.lint --matrix`"))
    return diags


def lint_telemetry(cfg):
    """PL017: telemetry-plane preflight, before any journal is opened
    or metrics endpoint bound. Recognized keys: ``telemetry-flush-ms``
    (the crash-safe journal flush interval), ``metrics?`` (whether
    GET /api/metrics will be served), ``serve-ip`` / ``auth-token?``
    (the bind it would be served on), ``trace-merge?`` (whether the
    campaign trace merge is requested), and ``sync?`` (tri-state:
    False = artifact sync explicitly off, None = auto/unknown)."""
    diags = []
    cfg = cfg or {}
    fl = cfg.get("telemetry-flush-ms")
    if fl is not None and (not isinstance(fl, (int, float))
                           or isinstance(fl, bool) or fl <= 0):
        diags.append(diag(
            "PL017", ERROR,
            f"telemetry-flush-ms must be a positive number, got "
            f"{fl!r}",
            "telemetry.flush-ms",
            "the incremental trace/metrics journals flush on this "
            "interval; a non-positive value means a kill -9 loses "
            "everything since the last event — omit the key for the "
            "500 ms default"))
    if cfg.get("metrics?"):
        ip = cfg.get("serve-ip")
        if str(ip or "0.0.0.0") not in _LOOPBACK_BINDS \
                and not cfg.get("auth-token?"):
            diags.append(diag(
                "PL017", ERROR,
                f"GET /api/metrics would bind {ip or '0.0.0.0'!r} "
                "(non-loopback) with no auth token: the exposition "
                "body names worker hosts, campaign ids, and live "
                "queue depths",
                "telemetry.metrics",
                "pass --auth-token (or bind 127.0.0.1)"))
    if cfg.get("trace-merge?") and cfg.get("sync?") is False:
        diags.append(diag(
            "PL017", WARNING,
            "campaign trace merge requested with artifact sync "
            "disabled: remote cells' trace.jsonl files are never "
            "mirrored home, so the merged timeline will hold only "
            "the coordinator lane",
            "telemetry.trace-merge",
            "re-enable artifact sync, or pass --no-trace-merge"))
    return diags


def _generator_like(g, depth=0):
    """Anything generator.validate can drive: None (empty), op dicts,
    callables, Generator objects (duck-typed on op/update), sequences
    and iterators of the same."""
    if g is None or isinstance(g, dict) or callable(g):
        return True
    if hasattr(g, "op") or hasattr(g, "update"):
        return True
    if depth < 2 and isinstance(g, (list, tuple)):
        return all(_generator_like(x, depth + 1) for x in g)
    return hasattr(g, "__iter__") or hasattr(g, "__next__")


def _literal_ops(g, depth=0, budget=None):
    """Walk a generator structure collecting literal op dicts -- the
    statically-knowable subset (function generators are opaque).
    Combinator objects are traversed through their attributes."""
    if budget is None:
        budget = [512]
    if budget[0] <= 0 or depth > 8 or g is None or callable(g):
        return
    budget[0] -= 1
    if isinstance(g, dict):
        if "f" in g:
            yield g
        return
    if isinstance(g, (list, tuple)):
        for x in g[:64]:
            yield from _literal_ops(x, depth + 1, budget)
        return
    if hasattr(g, "__dict__"):
        for v in vars(g).values():
            yield from _literal_ops(v, depth + 1, budget)


def preflight(test, strict=True):
    """core.run's preflight phase. Lints the plan, logs findings, and
    raises PlanLintError on FATAL_CODES when ``strict``. Returns the
    diagnostics list."""
    diags = lint_plan(test)
    if diags:
        logger.warning("%s", render_text(diags, title="test plan "
                                                      "preflight:"))
    fatal = [d for d in errors(diags) if d.code in FATAL_CODES]
    if strict and fatal:
        raise PlanLintError(fatal)
    return diags
