"""The fleet dispatcher: lease campaign cells to worker hosts over the
L0 control plane, steal work from the dead (the port's copy of
``jepsen_tpu/fleet/dispatch.py``).

Execution model (the reference Jepsen's own shape -- one control node
driving workers over SSH -- turned on ourselves):

* **Workers.** Each worker is a host reached through
  ``control/remotes.py`` -- ``SSHRemote`` for real hosts, or
  ``LocalRemote`` for the loopback topology (N worker *processes* on
  one machine; how the tests and the CI smoke run). Connection
  liveness is probed through the RetryPolicy-backed ``RetryRemote``
  (the L0 plane's own flake armor); the cell exec itself uses the raw
  transport -- a cell run is not idempotent at the transport layer,
  and re-running is the LEASE machinery's decision, not the retry
  loop's.
* **Leases.** The dispatcher pops a pending cell, journals a
  ``lease`` event, and execs ``python -m jepsen_tpu_torch.fleet.worker``
  with the cell spec on stdin and a transport timeout of the lease
  TTL. A worker that returns a result line completes the lease; one
  that dies (kill -9 -> nonzero exit, no result) or times out forfeits
  it, and the cell goes back on the queue for ANY worker to re-lease
  (work stealing), up to ``max_leases`` attempts. A
  ``robust.LeaseWatchdog`` backstops wedged transports.
* **Journal = truth.** Lease grants, expiries, and failures append to
  the campaign journal as event records; outcomes append exactly once
  per cell (a terminal-guard drops a stolen cell's late duplicate), so
  ``cells.jsonl`` alone reconstructs who ran what, who died, and what
  the verdict was -- and ``--resume`` works unchanged.
* **Abort.** One ``robust.AbortLatch`` (SIGINT/SIGTERM) stops new
  leases; in-flight execs drain to their transport timeout and the
  journal is left resumable.

On the card each worker process makes its own CUDA context and builds
or loads the rollout kernel's library (``_build``); the in-process
device slot does not reach across processes, so two workers' searches
share the card, as two TPU workers share a host in the reference.

Where the port differs (ROADMAP.md, deliberate divergences): a backend
tier reaches the worker as the spec's ``backend`` (the worker overlays
the tier's ``device`` option, ``backends.tier_options``), not as an
environment variable; the live ``/api/metrics`` source and the
service's preflight (PL016) come with the service (ROADMAP.md
A.11(d4)); and the capacity plan (``capacity``, ``device_mem_budget``,
``capacity_plan``) raises ``NotImplementedError`` naming A.11(d5)
before anything is written.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import threading
import time
import traceback

from .. import obs, robust, store
from ..control import remotes
from ..obs import Registry, Tracer
from ..campaign import compile_cache
from ..campaign import report as creport
from ..campaign.journal import CampaignJournal
from ..campaign.scheduler import CampaignError, new_campaign_id

logger = logging.getLogger(__name__)

__all__ = ["FleetError", "Worker", "parse_workers", "run_fleet",
           "DEFAULT_LEASE_S", "MAX_LEASES"]

#: default lease TTL: how long one cell exec may run before its worker
#: is presumed dead and the cell is stolen
DEFAULT_LEASE_S = 600.0

#: how many leases a cell may burn before it journals as crashed
MAX_LEASES = 3

#: consecutive transport-layer failures before a worker is retired
WORKER_STRIKES = 3


class FleetError(CampaignError):
    """Fleet-level wiring failure (no workers, PL014 errors)."""


class Worker:
    """One worker host: id + the conn spec its remotes connect with."""

    def __init__(self, wid, host, kind="ssh", conn_spec=None):
        self.id = str(wid)
        self.host = str(host)
        self.kind = kind
        self.conn_spec = dict(conn_spec or {}, host=self.host)

    def __repr__(self):
        return f"Worker({self.id!r}, {self.host!r}, {self.kind})"

    def _base_remote(self):
        from .sync import resolve_remote
        base = resolve_remote(self.kind)
        return (base or remotes.SSHRemote)()

    def connect(self):
        """The raw (non-retrying) transport for cell execs."""
        return self._base_remote().connect(self.conn_spec)

    def probe(self, timeout_s=30):
        """Liveness probe through the RetryPolicy-backed transport
        (dogfooding control's flake armor where retries ARE safe).
        Returns None when healthy, an error string otherwise."""
        try:
            conn = remotes.RetryRemote(
                self._base_remote()).connect(self.conn_spec)
            res = conn.execute({"timeout": timeout_s}, {"cmd": "true"})
            if res.get("exit") != 0:
                return (f"probe exit {res.get('exit')}: "
                        f"{(res.get('err') or '')[:200]}")
            return None
        except Exception as exc:  # noqa: BLE001 - probe must not raise
            return repr(exc)


LOCAL_HOSTS = ("local", "localhost", "127.0.0.1")


def parse_workers(spec, ssh=None):
    """``"host1,host2"`` (or a list) -> [Worker]. ``name=host`` gives
    an explicit worker id; repeated bare hosts auto-suffix (``local``,
    ``local#2``) so N loopback worker processes coexist. ``local`` /
    ``localhost`` use the LocalRemote transport; anything else is an
    SSH host resolved with the suite's ssh options. A ``host:port``
    suffix overrides the ssh port per worker (the docker fleet's
    sshd containers all live on 127.0.0.1 behind different ports)."""
    if isinstance(spec, str):
        entries = [e.strip() for e in spec.split(",") if e.strip()]
    else:
        entries = [str(e).strip() for e in (spec or []) if str(e).strip()]
    ssh = ssh or {}
    conn = {k: ssh.get(k) for k in ("port", "username",
                                    "private-key-path",
                                    "strict-host-key-checking")
            if ssh.get(k) is not None}
    out, seen = [], {}
    for entry in entries:
        wid, eq, host = entry.partition("=")
        if not eq:
            wid, host = entry, entry
        seen[wid] = seen.get(wid, 0) + 1
        if seen[wid] > 1 and not eq:
            wid = f"{wid}#{seen[wid]}"
        wconn = conn
        h, sep, port = host.rpartition(":")
        if sep and port.isdigit():
            host, wconn = h, dict(conn, port=int(port))
        kind = "local" if host in LOCAL_HOSTS else "ssh"
        out.append(Worker(wid, host, kind=kind, conn_spec=wconn))
    return out


def _repo_root():
    """The directory ``python -m jepsen_tpu_torch...`` must run from."""
    import jepsen_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(jepsen_tpu_torch.__file__)))


def run_fleet(cells, workers, *, campaign_id=None, resume=False,
              lease_s=DEFAULT_LEASE_S, max_leases=MAX_LEASES,
              builder=None, base_options=None, latch=None, ledger=True,
              backends=None, python=None, cwd=None, serve=False,
              device_slots=1, probe=True, env=None, sync="auto",
              worker_store_dir=None, sync_timeout_s=None, chaos=None,
              serve_ip=None, auth_token=None, trace_merge=True,
              fleetlint="on", coalesce=False, coalesce_window_ms=None,
              coalesce_max_segments=None, capacity=None,
              device_mem_budget=None, capacity_plan=None,
              coordinator_lease_s=None, takeover_grace_s=None,
              ha_epoch=None):
    """Run a campaign across worker hosts; returns the report dict
    (persisted as report.json, same shape as scheduler.run_cells).

    ``cells`` are plan-style ``{"id", "group", "params"}`` maps;
    ``builder`` is the importable ``"pkg.module:fn"`` every worker
    rebuilds test maps with, fed ``base_options`` overlaid with each
    cell's params. ``serve``/``device_slots``/``serve_ip``/
    ``auth_token`` and the ``coalesce*`` knobs participate only in
    the PL014/PL017/PL020 preflight (in the JAX package the CLI
    co-launches the service; the port's is ROADMAP.md A.11(d4)).

    **Artifact sync** (``sync``): ``"auto"`` mirrors each remote
    cell's run directory into the coordinator store over the scp
    plane whenever the worker's store isn't this process's store (ssh
    workers, or any worker when ``worker_store_dir`` points workers
    at their own directory); ``True``/``False`` force it. Sync
    happens under the cell's lease (extended by ``sync_timeout_s``,
    default ``fleet.sync.DEFAULT_SYNC_TIMEOUT_S``), is journaled as
    ``artifact-sync`` events, and a failed sync forfeits the lease --
    the cell re-runs on another worker -- until the lease budget is
    exhausted, at which point the verdict is kept (``synced: False``)
    and ``--resume`` re-syncs instead of re-running.

    **Chaos** (``chaos``): a ``fleet.chaos`` profile (or its
    ``"name:seed"`` spec) wraps every worker transport in
    `remotes.FaultyRemote` and schedules worker kill -9s, so the
    lease/steal/sync machinery is exercised under seeded faults.

    **Telemetry** (``trace_merge``): the coordinator mints the
    campaign trace context, ships it to every worker in the cell spec
    (workers stamp their spans/metrics with {campaign, cell, worker}
    and journal them crash-safely), records the lease clock handshake
    on both sides, and — when ``trace_merge`` is on — folds every
    mirrored run trace into ``campaign_trace.jsonl`` at finalize with
    worker clocks normalized onto its own (obs.merge). The dispatch
    tracer/registry are also bound process-globally for the
    campaign's duration, so chaos injections, sync pulls, and probes
    emit first-class events.

    **Audit** (``fleetlint``): ``"on"`` (default) replays the
    finished campaign's artifacts against the control-plane protocol
    (analysis.fleetlint -- terminal-guard, single journal writer,
    lease lifecycle, sync manifests, trace causality, chaos
    accounting) into ``fleet_analysis.json``, and preflights
    ``--resume`` with the well-formedness subset, refusing (PL018) to
    resume a journal with duplicate terminal records or interleaved
    writers. ``"off"`` skips both. The finalize audit is CONTAINED:
    findings (and auditor crashes) are reported, never allowed to
    flip a cell outcome or the campaign's exit code -- the same rule
    searchplan follows for verdicts.

    **Capacity** (``capacity`` / ``device_mem_budget`` /
    ``capacity_plan``): the JAX package's static capacity pass and
    its prediction oracle. In the port they raise
    ``NotImplementedError`` naming ROADMAP.md A.11(d5) before any
    state is written.

    **Coordinator HA** (``coordinator_lease_s`` / ``takeover_grace_s``
    / ``ha_epoch``): with a coordinator lease TTL set, THIS
    coordinator's role becomes a journaled lease (fleet.ha): it
    claims a coordinator epoch, stamps every journal append with it,
    renews a ``coordinator-lease`` event on a heartbeat, and rechecks
    the journal at the terminal-guard so a fenced (superseded)
    coordinator refuses its own late appends and stands down instead
    of finalizing. A standby that won a takeover resumes with
    ``resume=True, ha_epoch=<won epoch>``; a manual ``--resume`` of
    an HA campaign fences the prior epoch with a ``forced`` takeover
    record. The ``coordinator-kill`` chaos profile SIGKILLs this
    process right after a seeded cell's lease-grant append (die-once
    marker), which is what the HA soak recovers from."""
    from ..analysis import planlint, render_text, errors as diag_errors
    from . import sync as fsync

    if capacity is not None or device_mem_budget is not None \
            or capacity_plan is not None:
        raise NotImplementedError(
            "the capacity plan and its prediction oracle "
            "(analysis.capplan) are not ported yet: ROADMAP.md A.11(d5)")

    workers = [w if isinstance(w, Worker) else Worker(w, w)
               for w in (workers or [])]
    cells = list(cells)
    base_options = dict(base_options or {})
    if sync_timeout_s is None:
        sync_timeout_s = fsync.DEFAULT_SYNC_TIMEOUT_S
    if chaos is not None:
        from . import chaos as fchaos
        chaos = fchaos.parse(chaos)
    from . import backends as fbackends
    diags = planlint.lint_fleet({
        "workers": [w.id for w in workers],
        "lease-s": lease_s,
        "serve?": serve,
        "device-slots": device_slots,
        # the tier NAMES, whatever shape the argument came in: PL014
        # must not read a comma string per character (ROADMAP.md C.10)
        "backends": fbackends.ladder_of(backends)
        if backends is not None else None,
        "time-limit": base_options.get("time-limit"),
    })
    # PL016 (the service's preflight, lint_service) comes with the
    # service: ROADMAP.md A.11(d4)
    # PL017: telemetry-plane preflight — flush knob sanity, exposed
    # /api/metrics, and a trace merge that artifact sync can't feed
    diags += planlint.lint_telemetry({
        "telemetry-flush-ms": base_options.get("telemetry-flush-ms"),
        "metrics?": serve,
        "serve-ip": serve_ip,
        "auth-token?": bool(auth_token),
        "trace-merge?": trace_merge,
        "sync?": sync if isinstance(sync, bool) else None,
    })
    # PL015 rides along like PL013/PL014: the workers rebuild test
    # maps from these base options, so searchplan knob mistakes
    # (unknown predicate names, carry disabled under the monitor)
    # surface before any host is contacted
    diags += planlint.searchplan_diags(base_options)
    # PL019 rides along over the base options like PL015: profile /
    # progress-cadence knob mistakes surface before any host is
    # contacted (workers rebuild test maps from these options)
    diags += planlint.lint_introspection(base_options)
    # PL018 (knob half): an unknown --fleetlint value is an error
    # here, not a silently-skipped audit
    diags += planlint.lint_fleetlint({"fleetlint": fleetlint})
    # PL022: phase-attribution / trend-gate knobs ride along like
    # PL019 (phases off while profile or a bubble fold needs their
    # spans, unreadable trend baselines, bad gate thresholds)
    diags += planlint.lint_trend(base_options)
    # PL023: verdict-certification knobs ride along the same way (bad
    # sample counts / budgets; the skip-offline? backstop note)
    diags += planlint.lint_certify(base_options)
    # PL020: cross-tenant coalescing knobs ride along like the other
    # serve knobs (the CLI co-launches the service; bad windows and
    # no-op configurations surface before any host is contacted)
    diags += planlint.lint_coalesce({
        "coalesce?": coalesce,
        "coalesce-window-ms": coalesce_window_ms,
        "coalesce-max-segments": coalesce_max_segments,
        "device-slots": device_slots,
        "engine": base_options.get("engine"),
    })
    # PL024: coordinator-HA knobs ride along (non-positive lease /
    # grace TTLs, a renewal interval that can't beat its own lease,
    # coordinator-kill chaos with no HA lease for a standby to fence)
    diags += planlint.lint_ha({
        "ha?": coordinator_lease_s is not None or ha_epoch is not None,
        "coordinator-lease-s": coordinator_lease_s,
        "takeover-grace-s": takeover_grace_s,
        "chaos-coordinator-kill?": bool(
            getattr(chaos, "coordinator_kill", 0))
        if chaos is not None else False,
    })
    if diags:
        logger.warning("%s", render_text(diags, title="fleet preflight:"))
    if diag_errors(diags):
        raise FleetError(render_text(diag_errors(diags),
                                     title="fleet config invalid:"))
    ids = [c["id"] for c in cells]
    if len(set(ids)) != len(ids):
        raise FleetError(f"duplicate cell ids: "
                         f"{sorted({i for i in ids if ids.count(i) > 1})}")

    if resume and campaign_id is None:
        campaign_id = store.latest_campaign()
        if campaign_id is None:
            raise FleetError("--resume: no campaign found in the store")
    campaign_id = campaign_id or new_campaign_id()
    jr = CampaignJournal(campaign_id)
    prior = jr.load_meta()
    if resume and prior is None:
        raise FleetError(f"--resume: campaign {campaign_id!r} was "
                         "never started")
    if prior is not None and not resume:
        raise FleetError(
            f"campaign {campaign_id!r} already exists: pass --resume "
            "to continue it, or pick a new --campaign-id")
    if resume and fleetlint != "off":
        # preflight before TRUSTING the journal: the resume fold
        # (skip-terminal, re-run-aborted) is only sound over a
        # well-formed journal -- duplicate terminal records or
        # interleaved writers mean the folds lie, and resuming would
        # append new truth onto corrupt truth (PL018)
        from ..analysis import fleetlint as flint
        pf = planlint.lint_fleetlint({
            "resume?": True,
            "journal-diags": flint.preflight(campaign_id,
                                             records=jr.records())})
        if diag_errors(pf):
            raise FleetError(render_text(
                diag_errors(pf),
                title="--resume refused: journal fails the fleetlint "
                      "preflight:"))
    # coordinator HA (fleet.ha): claim an epoch BEFORE any other
    # append so every record this process writes is epoch-stamped.
    # HA is on when a lease TTL was asked for, when a standby hands
    # us its won epoch, or when the journal already carries HA events
    # (resuming an HA campaign without the flag must not silently
    # strip the fencing)
    from . import ha as fha
    ha_on = (coordinator_lease_s is not None or ha_epoch is not None
             or (resume and fha.current_epoch(jr.records()) > 0))
    ha_ctl = None
    if ha_on:
        if coordinator_lease_s is None:
            coordinator_lease_s = fha.DEFAULT_COORDINATOR_LEASE_S
        if takeover_grace_s is None:
            takeover_grace_s = fha.DEFAULT_TAKEOVER_GRACE_S
        if ha_epoch is None:
            cur = fha.current_epoch(jr.records())
            if cur and resume:
                # a MANUAL --resume of an HA campaign: the operator is
                # the takeover evidence, so fence the prior epoch with
                # a forced takeover record (FL016 skips the stamp
                # expiry requirement for forced fences)
                ha_epoch = fha.fence(jr, reason="manual-resume",
                                     forced=True)
                if ha_epoch is None:
                    raise FleetError(
                        f"--resume: lost the coordinator takeover "
                        f"race for campaign {campaign_id!r} -- another "
                        "coordinator fenced it first")
            else:
                ha_epoch = cur + 1
        jr.epoch = int(ha_epoch)

    done = jr.completed() if resume else {}
    jr.write_meta({
        "status": "running", "mode": "fleet",
        "created": (prior or {}).get("created") or store.local_time(),
        "updated": store.local_time(),
        "cells": ids,
        "workers": [w.id for w in workers],
        "lease-s": lease_s,
        "max-leases": max_leases,
        "sync-timeout-s": sync_timeout_s,
        **({"worker-store": str(worker_store_dir)}
           if worker_store_dir else {}),
        **({"coordinator-lease-s": coordinator_lease_s,
            "takeover-grace-s": takeover_grace_s,
            "ha-epoch": int(ha_epoch)} if ha_on else {}),
        **({"chaos": chaos.describe()} if chaos is not None else {}),
        "resumes": ((prior or {}).get("resumes") or 0)
        + (1 if resume else 0),
    })

    latch = latch or robust.AbortLatch()
    tr = Tracer(context={"campaign": campaign_id,
                         "role": "coordinator"})
    reg = Registry()
    # crash-safe coordinator telemetry: journal dispatch spans +
    # fleet counters next to cells.jsonl (kill -9 leaves them)
    try:
        tr.attach_journal(
            store.campaign_path(campaign_id, store.TRACE_JOURNAL_FILE))
        reg.attach_journal(
            store.campaign_path(campaign_id,
                                store.METRICS_JOURNAL_FILE))
    except Exception:  # noqa: BLE001 - journals are insurance
        logger.warning("couldn't attach fleet telemetry journals",
                       exc_info=True)
    if ha_on:
        def _on_fenced(state):
            # a standby fenced us: stop leasing immediately (the
            # latch drains in-flight cells); the terminal-guard below
            # refuses whatever results still arrive
            if not latch.is_set():
                latch.set(f"fenced: coordinator epoch {jr.epoch} "
                          f"superseded by epoch {state[0]} "
                          f"({state[1]})")
            tr.instant("fleet.ha.fenced", cat="fleet",
                       args={"epoch": jr.epoch,
                             "by-epoch": state[0],
                             "by-writer": str(state[1])})
        ha_ctl = fha.CoordinatorLease(
            jr, lease_s=coordinator_lease_s, epoch=jr.epoch,
            registry=reg, on_fenced=_on_fenced)
    led = None
    if ledger:
        try:
            from . import ledger as fledger
            led = fledger.attach()
        except Exception:  # noqa: BLE001 - persistence is optional
            logger.warning("couldn't attach the persistent compile "
                           "ledger", exc_info=True)
    if backends is not None:
        backends = fbackends.as_failover(backends)
    # loopback workers must run the coordinator's interpreter; REMOTE
    # hosts usually want an explicit python= path instead
    import sys
    python = python or (sys.executable
                        if all(w.kind == "local" for w in workers)
                        else "python3")
    cwd = cwd or _repo_root()
    store_dir = os.path.abspath(store.base_dir)
    # where the WORKERS write runs: the coordinator's store by default
    # (loopback workers share the filesystem), or worker_store_dir for
    # isolated worker stores -- the topology real remote hosts have,
    # reproducible on one machine, and the one artifact sync exists for
    worker_store = os.path.abspath(worker_store_dir) \
        if worker_store_dir else store_dir

    def needs_sync(worker):
        if sync is True:
            return True
        if sync is False:
            return False
        return worker.kind != "local" or worker_store != store_dir

    kill_cells = chaos.plan_kills(ids) if chaos is not None else set()
    # chaos coordinator-kill: one seeded cell whose lease-grant append
    # is this coordinator's last act (SIGKILL right after it hits the
    # journal). The marker file makes it die-once -- the takeover
    # coordinator resuming the same campaign+profile runs clean
    coord_kill_cell, coord_kill_marker = None, None
    if chaos is not None and getattr(chaos, "coordinator_kill", 0):
        coord_kill_marker = fha.takeover_marker(campaign_id)
        if not os.path.exists(coord_kill_marker):
            coord_kill_cell = chaos.plan_coordinator_kill(ids)
    if chaos is not None and chaos.torn_ledger_tail and led is not None:
        from . import chaos as fchaos
        fchaos.tear_ledger_tail(led)

    cond = threading.Condition()
    pending = collections.deque(c for c in cells if c["id"] not in done)
    by_id = {c["id"]: c for c in cells}
    terminal = set(done)
    alive = {w.id for w in workers}
    table = robust.LeaseTable()
    reg.set_gauge("fleet.cells_total", len(cells))
    reg.set_gauge("fleet.cells_resumed", len(done))
    reg.set_gauge("fleet.workers", len(workers))

    def finish(cid, rec):
        """Terminal-guard append: at most ONE outcome per cell, ever.
        Caller holds ``cond``."""
        if cid in terminal:
            reg.inc("fleet.stale_results")
            logger.info("dropping stale result for already-terminal "
                        "cell %s", cid)
            return False
        if ha_ctl is not None and ha_ctl.fenced(refresh=True):
            # zombie fencing: re-read the journal at the last moment
            # before the outcome append -- a takeover record means a
            # standby owns this campaign (and this cell) now, and OUR
            # append would be the exact split-brain FL016 exists to
            # catch. Refuse it and drain
            reg.inc("fleet.fenced_appends")
            logger.warning("refusing outcome append for %s: "
                           "coordinator epoch %s is fenced", cid,
                           jr.epoch)
            cond.notify_all()
            return False
        terminal.add(cid)
        jr.append_cell(rec)
        reg.inc("fleet.cells", outcome=str(rec.get("outcome")))
        if rec.get("wall_s") is not None:
            reg.observe("fleet.cell_s", rec["wall_s"])
        cond.notify_all()
        return True

    folded_cells = set()

    #: per-cell wgl counter families folded into the live fleet
    #: registry as cells finish, so the fleet's metrics journal carries the
    #: campaign's search-progress and padding accounting MID-RUN
    #: (bucket/engine labels survive: the flat key's label suffix is
    #: kept verbatim on the cell-labelled re-emission)
    _WGL_LIVE_COUNTERS = ("wgl.states_explored_total",
                          "wgl.cells_real", "wgl.cells_padded",
                          "wgl.device_busy_s", "wgl.chunks")

    def _fold_worker_metrics(rec):
        """Fold the headline series out of a finished cell's own
        metrics artifact (monitor detection latency + violations, and
        the device-search introspection counters: explored configs,
        real/padded batch rows per n-bucket, device-busy wall) into
        the live fleet registry, so a live reader of the registry sees them
        while the campaign is still running. Best effort: the file is
        local only for shared-store/synced cells. Folded at most ONCE
        per cell — a forfeited-sync re-run would otherwise re-inc the
        counters per attempt (detection latency is safe via
        max_gauge, the counters are not)."""
        try:
            if rec.get("cell") in folded_cells:
                return
            folded_cells.add(rec.get("cell"))
            p = rec.get("path")
            if not p or not os.path.isdir(str(p)):
                return
            m = store.load_run_metrics(str(p))
            if not m:
                return
            cid = str(rec.get("cell"))
            for k, v in (m.get("gauges") or {}).items():
                if k.startswith("monitor.detection_latency_s"):
                    reg.max_gauge("monitor.detection_latency_s",
                                  float(v), cell=cid)
            from ..obs.metrics import parse_flat_key
            for k, v in (m.get("counters") or {}).items():
                if k.startswith("monitor.violations"):
                    reg.inc("monitor.violations", int(v), cell=cid)
                    continue
                name, raw = parse_flat_key(k)
                if name in _WGL_LIVE_COUNTERS:
                    labels = {"cell": cid,
                              **{lk: lv for lk, lv in raw.items()
                                 if lk in ("engine", "bucket")}}
                    reg.inc(name, v, **labels)
        except Exception:  # noqa: BLE001 - telemetry fold only
            logger.warning("couldn't fold worker metrics",
                           exc_info=True)

    def requeue_or_fail(cid, worker_id, error):
        """A lease was forfeited: steal (requeue) or, past the attempt
        budget, journal the cell crashed. Caller holds ``cond``."""
        if cid in terminal:
            return
        if ha_ctl is not None and ha_ctl.fenced():
            return      # fenced: the standby owns the cell now
        jr.append_event({"event": "lease-failed", "cell": cid,
                         "worker": worker_id, "error": str(error)[:500],
                         "t": store.local_time()})
        tr.instant("fleet.lease.steal", cat="fleet",
                   args={"cell": cid, "worker": str(worker_id),
                         "error": str(error)[:200]})
        if table.attempts(cid) >= max_leases:
            finish(cid, {"cell": cid,
                         "group": by_id[cid].get("group") or cid,
                         "params": by_id[cid].get("params") or {},
                         "outcome": "crashed",
                         "error": f"lease budget exhausted "
                                  f"({max_leases} leases); last: "
                                  f"{str(error)[:300]}"})
        elif cid not in [c["id"] for c in pending]:
            pending.append(by_id[cid])
            reg.inc("fleet.cells_stolen", worker=str(worker_id))
            cond.notify_all()

    def on_lease_expired(lease):
        """LeaseWatchdog backstop: the transport wedged past its own
        timeout; put the cell back up for stealing."""
        reg.inc("fleet.lease_expired")
        tr.instant("fleet.lease.expired", cat="fleet",
                   args={"cell": lease.unit, "worker": lease.holder,
                         "attempt": lease.attempt,
                         "ttl_s": lease.ttl_s})
        with cond:
            jr.append_event({"event": "lease-expired",
                             "cell": lease.unit,
                             "worker": lease.holder,
                             "attempt": lease.attempt,
                             "t": store.local_time()})
            requeue_or_fail(lease.unit, lease.holder,
                            f"lease expired after {lease.ttl_s:.0f}s")

    def next_cell():
        """Block until a cell is available, all work is terminal, or
        the latch aborts; returns a cell or None."""
        with cond:
            while True:
                if latch.is_set():
                    return None
                if pending:
                    return pending.popleft()
                if len(terminal) >= len(cells) or not alive:
                    return None
                cond.wait(timeout=0.5)

    def cell_spec(cell, worker, attempt=1):
        spec = {"campaign": campaign_id, "cell": cell["id"],
                "group": cell.get("group") or cell["id"],
                "params": cell.get("params") or {},
                "options": base_options,
                "builder": builder or "jepsen_tpu_torch.demo:demo_test",
                "store-dir": worker_store,
                "worker": worker.id,
                "ledger": bool(ledger),
                # trace-context propagation: the worker binds these
                # into obs so every span/metric it emits carries
                # {campaign, cell, worker}; the coord-sent stamp is
                # the first leg of the clock handshake obs.merge
                # normalizes worker clocks with
                "trace": {"campaign": campaign_id, "cell": cell["id"],
                          "worker": worker.id, "attempt": attempt,
                          "coord-sent-epoch": time.time()}}
        if cell["id"] in kill_cells:
            # chaos-scheduled kill -9: the die-once marker makes the
            # FIRST lease die mid-run and every later lease run clean
            safe = str(cell["id"]).replace(os.sep, "_")
            spec["die-once-marker"] = os.path.abspath(
                store.campaign_path(campaign_id, f"chaos-kill-{safe}"))
        if ha_ctl is not None:
            # the fencing token: workers echo it back on their result
            # record, so even a record relayed through a zombie
            # coordinator names the epoch that leased it
            spec["coordinator-epoch"] = jr.epoch
        if backends is not None:
            # the worker overlays the tier's device option before it
            # builds the cell (backends.tier_options)
            spec["backend"] = backends.choose()
        if chaos is not None:
            skew = chaos.skew_for(worker.id)
            if skew:
                # chaos clock skew: the worker shifts its handshake
                # stamps by this much (a worker whose wall clock is
                # simply wrong); obs.merge recovers it, and the bound
                # rides into the cell options so skew-aware txn
                # checkers gate their realtime edges on it
                spec["clock-skew-s"] = skew
                spec["options"] = dict(base_options,
                                       **{"skew-bound-s":
                                          chaos.skew_bound_s()})
        return spec

    def journal_sync(cell, wid, status, info=None, **extra):
        """One ``artifact-sync`` event record + metric (the sync_rec
        and resume-resync paths must journal identically). The
        verified manifest rides on success records so fleetlint can
        re-verify the mirrored copy against the journaled sizes
        (FL008); attempt counts ride on both outcomes so injected
        sync faults stay accountable (FL013)."""
        reg.inc("fleet.artifact_syncs", status=status,
                worker=str(wid))
        jr.append_event({"event": "artifact-sync", "cell": cell,
                         "worker": wid, "status": status,
                         **{k: info[k] for k in
                            ("files", "bytes", "attempts", "wall_s",
                             "manifest")
                            if info and k in info},
                         **extra, "t": store.local_time()})

    def sync_rec(worker, conn, lease, rec):
        """Mirror the finished cell's run directory into the
        coordinator store (fleet.sync): rewrites ``rec["path"]`` to
        the coordinator-local copy and journals the outcome as an
        ``artifact-sync`` event. Returns None on success (or nothing
        to do), else the error string -- the caller decides whether
        that forfeits the lease."""

        def failed(err):
            journal_sync(lease.unit, worker.id, "failed",
                         error=str(err)[:300],
                         **({"attempts": err.attempts}
                            if getattr(err, "attempts", 0) else {}))
            rec["synced"] = False
            # journal how to reach this worker's store: a later
            # --resume may run with a DIFFERENT worker list, and the
            # worker id alone is not a resolvable address
            rec["worker-kind"] = worker.kind
            rec["worker-conn"] = dict(worker.conn_spec)
            return str(err)

        src = rec.get("path")
        if not src:
            return None          # crashed before the store existed
        src = str(src)
        rel = os.path.relpath(src, worker_store)
        if rel.startswith(".."):
            rec["worker-path"] = src
            return failed(f"run path {src!r} escapes the worker store")
        dest = os.path.join(store_dir, rel)
        rec["path"] = dest
        if worker.kind == "local" and os.path.abspath(src) == dest:
            return None          # shared filesystem: already in place
        rec["worker-path"] = src
        try:
            info = fsync.pull_run(conn, src, dest,
                                  timeout_s=sync_timeout_s)
        except Exception as exc:  # noqa: BLE001 - journaled, bounded
            return failed(exc)
        reg.observe("fleet.artifact_sync_s", info.get("wall_s") or 0.0)
        journal_sync(lease.unit, worker.id, "ok", info=info, path=dest)
        rec["synced"] = True
        return None

    def run_lease(worker, conn, cell):
        cid = cell["id"]
        if ha_ctl is not None and ha_ctl.fenced():
            return False, {}    # superseded: grant nothing more
        lease = table.grant(cid, worker.id, lease_s)
        jr.append_event({"event": "lease", "cell": cid,
                         "worker": worker.id, "lease-s": lease_s,
                         "attempt": lease.attempt,
                         "t": store.local_time()})
        tr.instant("fleet.lease.grant", cat="fleet",
                   args={"cell": cid, "worker": worker.id,
                         "attempt": lease.attempt})
        if coord_kill_cell is not None and cid == coord_kill_cell:
            # chaos coordinator-kill: that grant was this process's
            # last act. Drop the die-once marker (flushed to disk so
            # the takeover coordinator never re-fires the kill), then
            # die the way a real coordinator dies -- no cleanup, no
            # journal goodbye, a live lease left dangling
            try:
                with open(coord_kill_marker, "w") as f:
                    f.write(f"{os.getpid()} {cid}\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:  # pragma: no cover - marker is best effort
                pass
            logger.warning("chaos: coordinator-kill on cell %s "
                           "(SIGKILL self)", cid)
            os.kill(os.getpid(), signal.SIGKILL)
        reg.set_gauge("fleet.lease_active", len(table.active()))
        spec = cell_spec(cell, worker, attempt=lease.attempt)
        ctx = {"dir": cwd, "timeout": lease_s}
        if env:
            ctx["env"] = dict(env)
        ok = False
        with tr.span("fleet.cell", cat="fleet",
                     args={"cell": cid, "worker": worker.id,
                           "attempt": lease.attempt}):
            try:
                res = conn.execute(
                    ctx, {"cmd": f"{python} -m jepsen_tpu_torch.fleet.worker",
                          "in": json.dumps(spec, cls=store._Encoder)})
            except Exception:  # noqa: BLE001 - transport crash
                res = {"exit": -1, "err": traceback.format_exc(limit=4),
                       "out": ""}
        coord_received = time.time()
        from .worker import parse_result
        rec = parse_result(res.get("out")) if res.get("exit") == 0 \
            else None
        if rec is not None:
            # close the clock handshake: the worker stamped its
            # receive/result wall times into rec["clock"]; the
            # coordinator's send/receive stamps complete the four
            # obs.merge's skew estimate needs
            clock = rec.setdefault("clock", {})
            if isinstance(clock, dict):
                clock.setdefault("coord-sent-epoch",
                                 spec["trace"]["coord-sent-epoch"])
                clock["coord-received-epoch"] = coord_received
            _fold_worker_metrics(rec)
        sync_err = None
        if rec is not None and needs_sync(worker):
            # hold the watchdog off during the download (best effort:
            # if the lease already expired, the steal re-runs the cell
            # into a FRESH run dir, so a late sync can't collide).
            # Small pad past the pull's own deadline: the verify +
            # rename + journal tail must not lose a lease race. The
            # extension is journaled -- fleetlint checks that extends
            # happen only to cover an artifact sync (FL00x lease
            # lifecycle), the one legitimate reason a finished cell
            # may outlive its TTL
            table.extend(lease, sync_timeout_s + 5.0)
            jr.append_event({"event": "lease-extend", "cell": cid,
                             "worker": worker.id,
                             "ttl-s": sync_timeout_s + 5.0,
                             "reason": "artifact-sync",
                             "t": store.local_time()})
            with tr.span("fleet.artifact_sync", cat="fleet",
                         args={"cell": cid, "worker": worker.id}):
                sync_err = sync_rec(worker, conn, lease, rec)
        current = table.release(lease)
        reg.set_gauge("fleet.lease_active", len(table.active()))
        with cond:
            if rec is not None:
                if sync_err is not None and current \
                        and table.attempts(cid) < max_leases:
                    # the run finished but its artifacts are stuck on
                    # the worker: forfeit the lease so another worker
                    # re-runs the cell (fresh artifacts, fresh sync)
                    requeue_or_fail(cid, worker.id,
                                    f"artifact sync failed: "
                                    f"{sync_err}")
                    ok = False
                else:
                    # lease budget exhausted with a sync failure: the
                    # VERDICT is known (the worker reported it), so
                    # keep it, mark the record unsynced, and let
                    # --resume / web-on-demand fetch the artifacts
                    # later instead of burning the run
                    rec.setdefault("worker", worker.id)
                    rec["attempt"] = lease.attempt
                    ok = finish(cid, rec)
                    if ok and rec.get("synced") is False \
                            and rec.get("worker-path"):
                        rel = os.path.relpath(str(rec["path"]),
                                              store_dir)
                        if not rel.startswith(".."):
                            fsync.register_pending(
                                rel, kind=worker.kind,
                                conn_spec=worker.conn_spec,
                                remote_dir=rec["worker-path"],
                                timeout_s=sync_timeout_s)
            else:
                err = (res.get("err") or "")[-300:] \
                    or f"exit {res.get('exit')}, no result line"
                if current:   # the watchdog hasn't already requeued it
                    requeue_or_fail(cid, worker.id, err)
        return ok, res

    def worker_loop(worker):
        # bind the fleet pair for THIS thread's whole tenure: chaos
        # fault injections (remotes.FaultyRemote) and artifact-sync
        # pulls deep in the transport stack emit through the obs
        # facade, and without a binding they would be invisible —
        # the exact gap this plane closes. The bind stack makes N
        # worker threads pushing the same pair safe.
        with obs.bind(tr, reg):
            _worker_loop(worker)

    def _worker_loop(worker):
        try:
            conn = worker.connect()
            if chaos is not None:
                # the chaos schedule wraps the DISPATCH transport (cell
                # execs + artifact sync); the liveness probe below runs
                # on its own clean connection, so injection exercises
                # recovery paths, not the admission gate
                conn = remotes.FaultyRemote(
                    conn, chaos.faults_for(worker.id))
        except Exception as exc:  # noqa: BLE001
            conn, exc_ = None, exc
        if probe and conn is not None:
            with tr.span("fleet.probe", cat="fleet",
                         args={"worker": worker.id,
                               "kind": worker.kind}):
                perr = worker.probe()
        else:
            perr = None if conn is not None else repr(exc_)
        if perr is not None:
            logger.warning("fleet worker %s failed its liveness probe: "
                           "%s", worker.id, perr)
            jr.append_event({"event": "worker-dead", "worker": worker.id,
                             "error": str(perr)[:300],
                             "t": store.local_time()})
            reg.inc("fleet.worker_failures", worker=worker.id)
            with cond:
                alive.discard(worker.id)
                cond.notify_all()
            return
        strikes = 0
        try:
            while True:
                cell = next_cell()
                if cell is None:
                    break
                try:
                    ok, res = run_lease(worker, conn, cell)
                except Exception:  # noqa: BLE001 - thread must live
                    # an unexpected dispatch bug is a forfeited lease,
                    # never a silently-dead worker thread (the cell
                    # would otherwise hang until the lease watchdog)
                    logger.warning("fleet worker %s: lease handling "
                                   "crashed for %s", worker.id,
                                   cell["id"], exc_info=True)
                    with cond:
                        requeue_or_fail(cell["id"], worker.id,
                                        traceback.format_exc(limit=4))
                    ok, res = False, {}
                if ok or not remotes.transport_failed(res):
                    strikes = 0
                    continue
                strikes += 1
                reg.inc("fleet.worker_failures", worker=worker.id)
                if strikes >= WORKER_STRIKES:
                    logger.warning("retiring fleet worker %s after %d "
                                   "consecutive transport failures",
                                   worker.id, strikes)
                    jr.append_event({"event": "worker-dead",
                                     "worker": worker.id,
                                     "error": f"{strikes} consecutive "
                                              "transport failures",
                                     "t": store.local_time()})
                    break
        finally:
            with cond:
                alive.discard(worker.id)
                cond.notify_all()

    def resync_done_cells():
        """--resume re-SYNCS instead of re-running: a terminal cell
        whose record says ``synced: False`` kept its verdict but left
        its artifacts on the worker; pull them now (clean transport,
        no chaos) and journal the outcome. Already-mirrored runs (a
        prior resume, or web's on-demand fetch) are left alone."""
        by_worker = {w.id: w for w in workers}

        def resync_one(cid, rec):
            dest = str(rec.get("path") or "")
            rel = os.path.relpath(dest, store_dir) if dest else ".."
            if not dest or rel.startswith("..") or os.path.isdir(dest):
                return
            w = by_worker.get(str(rec.get("worker")))
            if w is not None:
                kind, conn_spec = w.kind, w.conn_spec
            elif rec.get("worker-conn"):
                # the worker isn't in THIS fleet's list, but its
                # terminal record journaled how to reach it
                kind = rec.get("worker-kind") or "ssh"
                conn_spec = rec["worker-conn"]
            else:
                logger.warning("can't re-sync %s: worker %r isn't in "
                               "this fleet and its record carries no "
                               "conn spec", cid, rec.get("worker"))
                return
            wid = str(rec.get("worker"))
            try:
                base = fsync.resolve_remote(kind)
                if base is None:
                    raise FleetError(f"unknown worker kind {kind!r}")
                info = fsync.pull_run(base().connect(conn_spec),
                                      rec["worker-path"], dest,
                                      timeout_s=sync_timeout_s)
            except Exception as exc:  # noqa: BLE001 - per-cell
                journal_sync(cid, wid, "failed",
                             error=str(exc)[:300],
                             **({"attempts": exc.attempts}
                                if getattr(exc, "attempts", 0)
                                else {}))
                fsync.register_pending(rel, kind=kind,
                                       conn_spec=conn_spec,
                                       remote_dir=rec["worker-path"],
                                       timeout_s=sync_timeout_s)
                return
            journal_sync(cid, wid, "ok", info=info, path=dest)

        todo = [(cid, rec) for cid, rec in done.items()
                if rec.get("synced") is False
                and rec.get("worker-path")]
        if not todo:
            return
        # re-syncs are independent of each other AND of dispatch;
        # serial pulls would stall startup by up to sync_timeout_s
        # per unreachable worker (journal appends are thread-safe --
        # the worker threads share it the same way)
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(
                max_workers=min(8, len(todo)),
                thread_name_prefix="jepsen fleet resync") as pool:
            for _ in pool.map(lambda a: resync_one(*a), todo):
                pass

    if not workers:
        raise FleetError("fleet dispatch needs at least one worker")

    try:
        if resume and done:
            with obs.bind(tr, reg):
                resync_done_cells()
        watchdog = robust.LeaseWatchdog(table, on_lease_expired,
                                        poll_s=min(1.0, lease_s / 4))
        hard_abort = None
        cc_before = compile_cache.stats()
        try:
            with robust.signal_scope(latch):
                with tr.span("fleet.dispatch", cat="fleet",
                             args={"id": campaign_id,
                                   "cells": len(pending),
                                   "workers": len(workers)}):
                    if ha_ctl is not None:
                        # the claiming renewal lands before any cell
                        # lease: the journal carries the epoch first
                        ha_ctl.start()
                    watchdog.start()
                    threads = [threading.Thread(
                        target=worker_loop, args=(w,),
                        name=f"jepsen fleet {w.id}") for w in workers]
                    for t in threads:
                        t.start()
                    for t in threads:
                        while t.is_alive():
                            t.join(timeout=0.5)
        except BaseException as e:  # noqa: BLE001 - finalize, rethrow
            hard_abort = e
            if not latch.is_set():
                latch.set(repr(e))
            logger.warning("fleet campaign %s hard-aborted (%r); "
                           "journal is resumable with --resume",
                           campaign_id, e)
        finally:
            watchdog.stop()
            if ha_ctl is not None:
                ha_ctl.stop()

        if ha_ctl is not None and ha_ctl.fenced(refresh=True):
            # stand down WITHOUT touching campaign.json / report.json:
            # the winning coordinator owns them now. Our journal
            # appends are all epoch-stamped, so FL016 can audit
            # anything that slipped through the fencing race window
            raise FleetError(
                f"coordinator fenced: epoch {jr.epoch} superseded by "
                f"{ha_ctl.fenced_by}; standing down (the campaign "
                "continues under the new coordinator)")

        unfinished = set(ids) - terminal
        if unfinished and not latch.is_set():
            # every worker died with cells left: surface it as an
            # abort so the exit code and status say "incomplete", not
            # "passed"
            latch.set("workers-exhausted")
            logger.warning("fleet campaign %s: workers exhausted with "
                           "%d cell(s) unfinished", campaign_id,
                           len(unfinished))

        # compile reuse: the coordinator itself compiles nothing --
        # sum THIS run's workers' deltas from their records (cells
        # resumed from a prior process already reported theirs in that
        # process's stats event; re-folding them would double-count on
        # every --resume), then fold in the persisted ledger aggregate
        recs = jr.latest()
        fresh = [r for r in recs if str(r.get("cell")) not in done]
        cc = {"hits": 0, "misses": 0}
        for r in fresh:
            w = r.get("compile-cache") or {}
            cc["hits"] += int(w.get("hits") or 0)
            cc["misses"] += int(w.get("misses") or 0)
        local = compile_cache.delta(cc_before)
        cc["hits"] += local["hits"]
        cc["misses"] += local["misses"]
        reg.set_gauge("campaign.compile_cache.hits", cc["hits"])
        reg.set_gauge("campaign.compile_cache.misses", cc["misses"])
        if led is not None:
            # cold/warm wall: cells whose own delta had misses (first
            # sightings of a plan shape) against all-hit cells. The
            # port compiles nothing per shape, so this split is
            # bookkeeping in the reference's format, not compile time
            from .ledger import fold_walls
            cold, warm = fold_walls(fresh)
            led.note_stats(cc["hits"], cc["misses"], cold_wall_s=cold,
                           warm_wall_s=warm)
            try:
                cc = dict(cc, ledger=led.stats())
            except Exception:  # noqa: BLE001 - bookkeeping only
                logger.warning("couldn't aggregate compile-ledger "
                               "stats", exc_info=True)
        aborted = latch.is_set()
        report = creport.summarize(
            recs, meta={"id": campaign_id}, compile_cache=cc,
            aborted=aborted, abort_reason=latch.reason,
            skipped=len(done))
        report["mode"] = "fleet"
        report["workers"] = [w.id for w in workers]
        jr.write_report(report)
        try:
            tr.dump(store.campaign_path(campaign_id, "trace.jsonl"))
            tr.close_journal(remove=True)
            store._dump_json(reg.snapshot(),
                             store.campaign_path(campaign_id,
                                                 "metrics.json"))
            reg.close_journal(remove=True)
        except Exception:  # noqa: BLE001 - telemetry is a byproduct
            logger.warning("couldn't write fleet obs artifacts",
                           exc_info=True)
        if trace_merge:
            # fold every mirrored run trace + the coordinator's own
            # into ONE Perfetto timeline, worker clocks normalized
            # from the lease handshakes recorded above. Contained: a
            # merge failure costs the merged view, never the campaign
            try:
                from ..obs import merge as obs_merge
                minfo = obs_merge.merge_campaign(campaign_id)
                report["trace"] = {k: minfo[k] for k in
                                   ("path", "events", "cells",
                                    "skipped")}
                report["trace"]["workers"] = minfo["workers"]
                jr.write_report(report)
                logger.info("merged campaign trace: %d events, %d "
                            "cells (%d skipped) -> %s",
                            minfo["events"], minfo["cells"],
                            minfo["skipped"], minfo["path"])
            except Exception:  # noqa: BLE001
                logger.warning("couldn't merge the campaign trace",
                               exc_info=True)
        # fold the per-cell metrics (journal fallback included) into
        # metrics_fold.json and surface the introspection headline —
        # per-bucket padding waste + device-busy wall — on the report.
        # Contained: a fold failure costs the table, never the campaign
        try:
            from ..obs import merge as obs_merge
            fold = obs_merge.fold_campaign_metrics(campaign_id)
            report["introspection"] = obs_merge.introspection_summary(
                fold)
            report["introspection"]["metrics_fold"] = fold.get("path")
            jr.write_report(report)
        except Exception:  # noqa: BLE001
            logger.warning("couldn't fold campaign metrics",
                           exc_info=True)
        # fold the merged trace's phase spans into the idle-bubble
        # ledger (byte-deterministic bubble_ledger.json) and put the
        # attribution headline on the report next to the padding /
        # duty-cycle numbers. Needs the merged trace; contained the
        # same way
        try:
            from ..obs import bubbles as obs_bubbles
            ledger = obs_bubbles.fold_campaign(campaign_id)
            if ledger.get("episodes"):
                report.setdefault("introspection", {})
                report["introspection"]["bubbles"] = {
                    k: ledger.get(k)
                    for k in ("device_s", "idle_s", "attributed_s",
                              "attribution_frac", "residual_s",
                              "path")}
                jr.write_report(report)
        except Exception:  # noqa: BLE001
            logger.warning("couldn't fold the bubble ledger",
                           exc_info=True)
        jr.write_meta({**(jr.load_meta() or {}),
                       "status": "aborted" if aborted else "complete",
                       "updated": store.local_time()})
        if fleetlint != "off":
            # the control-plane audit: replay everything this campaign
            # just journaled/traced against the protocol's invariants.
            # CONTAINED like searchplan: findings (and auditor
            # crashes) are reported in report.json and the FL
            # artifact, never allowed to flip a cell outcome or the
            # campaign exit code
            try:
                from ..analysis import fleetlint as flint
                from ..analysis.diagnostics import run_analyzer
                fa = None

                def _run_audit():
                    nonlocal fa
                    fa, diags_ = flint.audit(campaign_id)
                    return diags_

                run_analyzer("fleetlint", _run_audit)
                report["fleet_analysis"] = {
                    "counts": fa["counts"],
                    "checks": fa["checks"],
                    "path": fa.get("path"),
                }
                jr.write_report(report)
            except Exception:  # noqa: BLE001 - audit is contained
                logger.warning("fleetlint audit of campaign %s "
                               "crashed (contained)", campaign_id,
                               exc_info=True)
        if hard_abort is not None:
            raise hard_abort
        return report
    finally:
        # always: stop the journal flusher threads, whatever path
        # exits. On the happy path the dumps above already closed the
        # journals (remove=True) and these are no-ops; on an
        # exceptional exit the journal FILES are kept -- they are the
        # crash evidence.
        tr.close_journal()
        reg.close_journal()
