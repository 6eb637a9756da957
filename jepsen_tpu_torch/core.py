"""Entry point for all tests: coordinates setup of servers, running
workloads, injecting faults, and interpreting results (reference
jepsen/src/jepsen/core.clj; the port's copy of ``jepsen_tpu/core.py``).

A test is a plain dict. ``run`` nests the lifecycle exactly like the
reference (core.clj:326-397): logging -> sessions -> OS -> DB (with log
snarfing) -> relative-time -> run-case (client+nemesis setup/teardown
around the interpreter) -> save-1 -> analyze (save-2) -> log-results.

Every phase is host code; the device work is the checker's, in
``analyze``, on the caller's thread after every worker has stopped (a
Linearizable gate reaches ``torch_wgl`` and the rollout kernel there),
and, with ``test["monitor"]`` set, the streaming monitor's, on its own
thread while the interpreter runs (``monitor/core.py``). One branch
needs a module that is not ported yet and raises
``NotImplementedError`` naming it: ``test["profile?"]`` (the profiler
capture, ROADMAP.md A.11(d)).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import threading
import traceback

from . import analysis as janalysis
from . import checker as jchecker
from . import client as jclient
from . import control as c
from . import db as jdb
from . import history as jhistory
from . import monitor as jmonitor
from . import nemesis as jnemesis
from . import obs
from . import robust
from . import store
from . import util
from . import interpreter
from .control import util as cu
from .util import real_pmap

logger = logging.getLogger(__name__)

#: timeout for the synchronize barrier, seconds (core.clj:44-57)
DEFAULT_BARRIER_TIMEOUT_S = 60

NO_BARRIER = "no-barrier"


class BarrierTimeout(TimeoutError):
    """A "boring" exception (util.BORING_EXCEPTIONS): when one node's setup
    breaks the barrier, the sibling nodes' timeouts must not mask the root
    cause (core_test.clj most-interesting-exception-test)."""


def synchronize(test, timeout_s=DEFAULT_BARRIER_TIMEOUT_S):
    """Blocks until all nodes have arrived at the same point — used in
    IO-heavy DB setup to phase-align nodes (core.clj:44-57)."""
    barrier = test.get("barrier")
    if barrier == NO_BARRIER or barrier is None:
        return
    if not barrier.wait(timeout_s):
        raise BarrierTimeout(f"barrier timed out after {timeout_s}s")


class _Barrier:
    """A reusable cyclic barrier (java CyclicBarrier equivalent)."""

    def __init__(self, parties):
        self.parties = parties
        self._barrier = threading.Barrier(parties)

    def wait(self, timeout_s):
        try:
            self._barrier.wait(timeout_s)
            return True
        except threading.BrokenBarrierError:
            return False

    def reset(self):
        """Un-poison the barrier. A wait timeout breaks a
        threading.Barrier *permanently* -- every later wait fails
        instantly -- so retry loops (db.cycle) must reset between
        attempts, once all parties have unwound from the broken
        round."""
        self._barrier.reset()


def reset_barrier(test):
    """Reset the test's setup barrier if it is resettable (db.cycle
    calls this between setup retries; see _Barrier.reset)."""
    barrier = test.get("barrier")
    reset = getattr(barrier, "reset", None)
    if callable(reset):
        reset()


def primary(test):
    """The test's primary node (core.clj:66-69)."""
    return test["nodes"][0]


def prepare_test(test):
    """Fills in :start-time, :concurrency, and :barrier. Always succeeds;
    needed before accessing the test's store directory
    (core.clj:310-324)."""
    test = dict(test)
    if not test.get("start-time"):
        test["start-time"] = store.local_time()
    if not test.get("concurrency"):
        test["concurrency"] = len(test.get("nodes") or [])
    if not test.get("barrier"):
        n = len(test.get("nodes") or [])
        test["barrier"] = _Barrier(n) if n > 0 else NO_BARRIER
    return test


@contextlib.contextmanager
def with_os(test):
    """OS setup around the body; teardown in finally (core.clj:93-100)."""
    os_ = test.get("os")
    try:
        if os_ is not None:
            with obs.span("os.setup"):
                c.on_nodes(test, os_.setup)
        yield
    finally:
        if os_ is not None:
            with obs.span("os.teardown"):
                c.on_nodes(test, os_.teardown)


def snarf_logs(test):
    """Downloads DB log files from each node into the store dir
    (core.clj:102-136)."""
    db = test.get("db")
    if not isinstance(db, jdb.LogFiles) or not test.get("name"):
        return
    with obs.span("snarf-logs"):
        _snarf_logs(test)


def _snarf_logs(test):
    db = test["db"]

    def snarf(t, node):
        paths = db.log_files(t, node) or []
        # map full remote paths to short local names, dropping the common
        # directory prefix (core.clj:110-117)
        split = [str(p).split("/") for p in paths]
        common = util.longest_common_prefix_seq(split)
        for full, parts in zip(paths, split):
            short = "/".join(parts[len(common):]) or parts[-1]
            if cu.exists(full):
                logger.info("downloading %s", full)
                local = store.make_path(t, str(node), short.lstrip("/"))
                try:
                    c.download([str(full)], local)
                except OSError as e:
                    logger.info("%s download failed: %s", full, e)

    c.on_nodes(test, snarf)
    store.update_symlinks(test)


def maybe_snarf_logs(test):
    """Snarf logs, swallowing errors — used on abort paths where a snarf
    failure must not supersede the root cause (core.clj:138-148)."""
    try:
        snarf_logs(test)
    except Exception:  # noqa: BLE001
        logger.warning("Error snarfing logs:\n%s", traceback.format_exc())


@contextlib.contextmanager
def with_log_snarfing(test):
    """Ensures logs are snarfed after the body, including on errors and on
    interpreter shutdown (core.clj:150-170)."""
    import atexit
    hook_done = []

    def hook():
        if not hook_done:
            logger.info("Downloading DB logs before shutdown...")
            maybe_snarf_logs(test)

    atexit.register(hook)
    try:
        yield
        snarf_logs(test)
    finally:
        hook_done.append(True)
        atexit.unregister(hook)
        maybe_snarf_logs(test)


@contextlib.contextmanager
def with_db(test):
    """DB cycle (teardown->setup with retries) around the body; teardown in
    finally unless :leave-db-running? (core.clj:173-181)."""
    db = test.get("db")
    try:
        with with_log_snarfing(test):
            if db is not None:
                with obs.span("db.cycle"):
                    jdb.cycle(test)
            yield
    finally:
        if db is not None and not test.get("leave-db-running?"):
            with obs.span("db.teardown"):
                c.on_nodes(test, db.teardown)


@contextlib.contextmanager
def with_client_nemesis_setup_teardown(test):
    """Sets up clients (one per node, in parallel) and the nemesis (in a
    concurrent thread) before the body; tears them down after
    (core.clj:183-212)."""
    client = test["client"]
    nemesis = jnemesis.validate(test.get("nemesis") or jnemesis.noop)
    test["nemesis"] = nemesis

    nemesis_box = {}

    def setup_nemesis():
        try:
            nemesis_box["nemesis"] = nemesis.setup(test) or nemesis
        except Exception as e:  # noqa: BLE001
            nemesis_box["error"] = e

    def open_one(node):
        cl = jclient.validate(client).open(test, node)
        cl.setup(test)
        return cl

    clients = []
    with obs.span("client-nemesis.setup"):
        nf = threading.Thread(target=contextvars.copy_context().run,
                              args=(setup_nemesis,),
                              name="jepsen nemesis setup")
        nf.start()
        client_err = None
        try:
            clients = real_pmap(open_one, test.get("nodes") or [])
        except Exception as e:  # noqa: BLE001
            client_err = e
        nf.join()
        if "error" in nemesis_box:
            raise nemesis_box["error"]
        if client_err is not None:
            raise client_err
        test["nemesis"] = nemesis_box.get("nemesis", nemesis)
    try:
        yield
    finally:
        def teardown_nemesis():
            test["nemesis"].teardown(test)

        def close_one(cl):
            try:
                cl.teardown(test)
            finally:
                cl.close(test)

        with obs.span("client-nemesis.teardown"):
            nt = threading.Thread(target=contextvars.copy_context().run,
                                  args=(teardown_nemesis,),
                                  name="jepsen nemesis teardown")
            nt.start()
            real_pmap(close_one, clients)
            nt.join()


def preflight(test):
    """Static test-plan validation before any node contact
    (planlint): protocol conformance, generator/model op agreement,
    concurrency sanity. Fatal wiring defects raise PlanLintError here
    -- minutes earlier than the mid-run stack trace they would
    otherwise become. Opt out per test with ``test["preflight?"] =
    False``. Diagnostics are kept on the test map so store.save_1/2
    persist them in analysis.json."""
    if not test.get("preflight?", True):
        return test
    diags = janalysis.run_analyzer(
        "planlint", janalysis.planlint.preflight, test)
    # record even a clean report: "preflight ran, zero findings" is
    # itself evidence when a run later goes sideways
    test.setdefault("analysis", {})["plan"] = janalysis.to_json(diags)
    return test


def run_case(test):
    """Spawns nemesis and clients, runs the generator, returns the history
    (core.clj:214-219)."""
    with with_client_nemesis_setup_teardown(test):
        with obs.span("run-case"):
            return interpreter.run(test)


def _certify_monitor_verdict(test, mv):
    """Certify a monitor violation from the evidence the monitor
    parked at detection time (``analysis.certify``): replay its
    witness and cross-check the violating prefix through an
    independent CPU engine. This is the backstop for the
    ``skip-offline?`` handoff, where the monitor's False becomes the
    verdict of record with no offline re-check behind it. Contained as
    ``checker.core.certify_verdict`` is: certification never flips a
    verdict or exit code."""
    ev = test.pop("monitor-evidence", None)
    if ev is None or not (isinstance(mv, dict)
                          and mv.get("verdict") is False):
        return
    try:
        from .analysis import certify
        if not certify.enabled(test):
            return
        budget = certify.config(test)["budget"]
        holder = {}

        def build():
            summary, diags = certify.certify_monitor(ev, budget=budget)
            holder["summary"] = summary
            return diags

        janalysis.run_analyzer("certify-monitor", build)
        summary = holder.get("summary")
        if summary is None:
            return
        test.setdefault("analysis", {})["certify-monitor"] = summary
        if isinstance(test.get("results"), dict):
            test["results"]["monitor-certification"] = {
                "confirmed": summary.get("confirmed"),
                "counts": summary.get("counts")}
        if (summary.get("counts") or {}).get("error"):
            logger.warning(
                "monitor violation FAILED certification: %s",
                summary["counts"])
    except Exception:  # noqa: BLE001 - contained, never verdict-bearing
        logger.warning("monitor certification crashed", exc_info=True)


def analyze(test):
    """Index the history, run the checker, save results
    (core.clj:221-236). Salvaged runs (abort mid-run: the history is a
    prefix, not the full plan) are checked all the same, with
    ``results["salvaged"] = True`` so readers know the verdict covers
    only what was collected."""
    logger.info("Analyzing...")
    mv = test.get("monitor-verdict")
    skip = bool(mv and mv.get("verdict") in (True, False)
                and (jmonitor.config(test) or {}).get("skip-offline?"))
    # --profile: the capture around the run's device searches
    # (obs/profile.py; raises until A.11(d) ports it)
    from .obs import profile as obs_profile
    with obs_profile.scope(test), obs.span("analyze"):
        test["history"] = jhistory.index(test.get("history") or [])
        if skip:
            # monitor-verdict handoff: the run opted out of the offline
            # re-check; the monitor already decided every consumed
            # prefix with the same engines (doc/monitoring.md)
            test["results"] = {"valid": mv["verdict"],
                               "monitor-only": True}
        else:
            test["results"] = jchecker.check_safe(
                test.get("checker") or jchecker.noop(), test,
                test["history"])
    if test.get("salvaged?") or test.get("aborted"):
        results = test["results"]
        if isinstance(results, dict):
            results["salvaged"] = True
            if test.get("aborted"):
                results["abort-reason"] = str(test["aborted"])
    if mv is not None and isinstance(test.get("results"), dict):
        # persist the monitor's verdict next to the offline one so the
        # two can be cross-checked from results.json alone
        test["results"]["monitor"] = mv
    _certify_monitor_verdict(test, mv)
    logger.info("Analysis complete")
    if test.get("name"):
        store.save_2(test)
    return test


def salvage(test, cause):
    """Best-effort persistence + analysis of a partial history after an
    abnormal abort (hard signal, nemesis crash, BarrierTimeout...).

    The interpreter leaves the live history list on
    ``test["partial-history"]``; ``run`` calls this before re-raising so
    the history-so-far is persisted, *checked*, and marked
    ``results["salvaged"] = True`` instead of discarded. Never raises:
    salvage must not mask the abort's root cause."""
    hist = test.pop("partial-history", None)
    if not hist:
        return False
    test["history"] = hist
    test["salvaged?"] = True
    test.setdefault("aborted", repr(cause))
    logger.warning("Salvaging partial history (%d ops) after abort: %r",
                   len(hist), cause)
    obs.inc("robust.salvages")
    try:
        if test.get("name"):
            store.save_1(test)
        analyze(test)
    except Exception:  # noqa: BLE001 - best-effort, root cause wins
        logger.warning("Error while salvaging partial history:\n%s",
                       traceback.format_exc())
    return True


def log_results(test):
    """Log the results map and the overall verdict (core.clj:238-251)."""
    results = test.get("results") or {}
    valid = results.get("valid")
    verdict = {
        False: "Analysis invalid! (ノಥ益ಥ）ノ ┻━┻",
        "unknown": "Errors occurred during analysis, "
                   "but no anomalies found. ಠ~ಠ",
        True: "Everything looks good! ヽ('ー`)ノ",
    }.get(valid, f"Unexpected validity {valid!r}")
    logger.info("%s\n\n%s", results, verdict)
    return test


@contextlib.contextmanager
def with_logging(test):
    """Per-test log file around the body; logs crashes so they land in the
    test's own log (core.clj:296-307, store.clj:431-460)."""
    named = bool(test.get("name"))
    handler = None
    try:
        if named:
            handler = store.start_logging(test)
            test["store_dir"] = store.path(test)
        logger.info("Running test: %s", test.get("name"))
        yield
    except Exception:  # noqa: BLE001 - log the crash in-store, rethrow
        logger.warning("Test crashed!\n%s", traceback.format_exc())
        raise
    finally:
        # handler is None when start_logging itself raised; the
        # no-arg pop-latest fallback would detach a concurrent
        # sibling cell's live handler instead
        if named and handler is not None:
            store.stop_logging(handler)


@contextlib.contextmanager
def with_sessions(test):
    """Opens the control-plane session pool for the test's nodes
    (core.clj:274-294)."""
    with c.ssh_scope(test) as sessions:
        test["sessions"] = sessions
        try:
            yield test
        finally:
            test.pop("sessions", None)


def run(test):
    """Runs a test end to end and returns it with :history and :results.

    Tests are maps containing (core.clj:327-351):

      nodes        list of node names
      concurrency  how many client workers (default: node count)
      ssh          credentials, or {"dummy?": True} for a no-op remote
      os           OS protocol impl (default: none)
      db           DB protocol impl (default: none)
      remote       control transport override
      client       Client protocol impl
      nemesis      Nemesis protocol impl
      generator    generator of operations
      checker      verifies the history
      name         test name (enables the store directory)
      leave-db-running?  skip DB teardown at the end

    Fault-tolerance knobs (robust; all optional):

      op-timeout-ms   wedged-worker watchdog deadline per op
      time-limit-s    hard harness deadline -> graceful abort
      abort-grace-s   drain window for outstanding ops on abort

    Online monitoring (monitor; optional):

      monitor         True | chunk int | options dict -- run the
                      streaming linearizability monitor (or, with
                      ``family: "txn"``, the txn monitor) concurrently
                      with the interpreter; a proven violation aborts
                      the run immediately (reason "monitor-violation")
                      and ``results["monitor"]`` records the verdict,
                      detection index, and detection latency. A monitor
                      that cannot be built raises before the first op;
                      an exception on the monitor thread aborts the run
                      (reason "monitor-error"), the partial history is
                      salvaged, and the exception is re-raised
      op-sinks        extra per-op subscriber callables for the
                      interpreter's history tap

    SIGINT/SIGTERM abort gracefully (second signal hard-aborts), and on
    ANY abort the partial history is persisted, checked, and marked
    ``results["salvaged"] = True`` rather than discarded; named tests
    additionally journal every op to ``history.jsonl.journal`` so even
    SIGKILL leaves the history on disk.

    Lifecycle (core.clj:326-397): prepare -> logging -> sessions -> os ->
    db (+log snarfing) -> relative time -> run-case -> save-1 -> analyze
    (save-2) -> log-results."""
    test = prepare_test(test)
    with obs.run_scope(test):
        try:
            with with_logging(test):
                with obs.span("jepsen.run",
                              test_name=str(test.get("name"))):
                    # crash-safe telemetry: journal trace events +
                    # metric snapshots incrementally from here on
                    # (append+flush, HistoryJournal discipline), so
                    # even a kill -9 leaves the run's telemetry
                    # readable for the fleet's artifact sync
                    if test.get("name") and test.get("obs"):
                        store.open_obs_journals(test)
                    # plan preflight: fail fast on wiring defects,
                    # before sessions/OS/DB touch any node
                    preflight(test)
                    latch = test.setdefault("abort", robust.AbortLatch())
                    # the streaming monitor chains a per-run latch over
                    # test["abort"] (a violation aborts THIS run only,
                    # never a campaign's shared latch) and subscribes
                    # to the interpreter's op-sink fan-out. Signals
                    # keep targeting the BASE latch: in a campaign that
                    # is the fleet-wide latch (SIGINT must stop every
                    # cell, monitored or not), and the chained latch
                    # reads through to it either way
                    mon = jmonitor.install(test)
                    try:
                        with robust.signal_scope(latch):
                            with with_sessions(test):
                                with with_os(test):
                                    with with_db(test):
                                        with util.ensure_relative_time():
                                            if test.get("name"):
                                                test["journal"] = \
                                                    store.open_journal(
                                                        test)
                                            test["history"] = \
                                                run_case(test)
                            # sessions still open: snarfing happened
                            # inside with_db
                        # the final check. An exception of the monitor
                        # thread is re-raised here: the salvage below
                        # then persists and checks the whole history
                        try:
                            jmonitor.finalize(mon, test)
                        except BaseException:
                            test["partial-history"] = test["history"]
                            raise
                    except BaseException as e:
                        # stop the monitor (no final check: the run is
                        # already dead) so its verdict-so-far rides the
                        # salvage path into results.json; salvage runs
                        # even if the monitor thread raised too
                        try:
                            jmonitor.finalize(mon, test, finish=False)
                        finally:
                            salvage(test, e)
                        raise
                    finally:
                        journal = test.pop("journal", None)
                        if journal is not None:
                            journal.close()
                    test.pop("barrier", None)
                    if test.get("aborted"):
                        test["salvaged?"] = True
                    logger.info("Run complete, writing")
                    if test.get("name"):
                        store.save_1(test)
                    analyze(test)
                log_results(test)
        finally:
            # persist the artifacts in a finally: a CRASHED run is
            # exactly the one whose trace matters, and by now every
            # span (including jepsen.run) has closed through the
            # unwinding context managers (write_obs logs rather than
            # raises, so it cannot mask the run's own exception). Then
            # drop the handles — the tracer buffer can hold up to 1M
            # event dicts, which a retained test map must not pin.
            if test.get("name") and test.get("obs"):
                store.write_obs(test, final=True)
            test.pop("obs", None)
            test.pop("abort", None)
    return test
