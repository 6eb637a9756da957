"""DB lifecycle protocols: set up and tear down databases on nodes
(reference jepsen/src/jepsen/db.clj).

The ``DB`` protocol covers install/start/teardown; the optional capability
mixins (``Process``, ``Pause``, ``Primary``, ``LogFiles`` —
db.clj:18-41) are what the nemesis kill/pause/primary packages drive.
``cycle`` (db.clj:121-158) tears down then sets up the database on all
nodes concurrently, retrying on ``SetupFailed``.
"""

from __future__ import annotations

import logging
import time

from . import control as c
from .control import util as cu
from .robust import RetryPolicy

logger = logging.getLogger(__name__)


class DB:
    """Set up / tear down a database on one node (db.clj:11-13)."""

    def setup(self, test, node):
        """Set up the database on this particular node."""

    def teardown(self, test, node):
        """Tear down the database on this particular node."""


class Process:
    """Optional: starting and killing a DB's processes (db.clj:18-24)."""

    def start(self, test, node):
        raise NotImplementedError

    def kill(self, test, node):
        raise NotImplementedError


class Pause:
    """Optional: pausing and resuming a DB's processes (db.clj:26-29)."""

    def pause(self, test, node):
        raise NotImplementedError

    def resume(self, test, node):
        raise NotImplementedError


class Primary:
    """Optional: databases with a notion of primary nodes (db.clj:31-38)."""

    def primaries(self, test):
        """Returns a collection of nodes which are currently primaries
        (best-effort)."""
        raise NotImplementedError

    def setup_primary(self, test, node):
        """Performs one-time setup on a single node."""
        raise NotImplementedError


class LogFiles:
    """Optional: which files to snarf from each node (db.clj:40-41)."""

    def log_files(self, test, node):
        return []


class _Noop(DB):
    """Does nothing (db.clj:43-47)."""


noop = _Noop()


class SetupFailed(Exception):
    """Raising this from DB.setup/setup_primary triggers a teardown+setup
    retry (db.clj ::setup-failed)."""


#: How many tries do we get to set up a database? (db.clj:117-119)
CYCLE_TRIES = 3

#: Unified backoff for setup retries (robust.RetryPolicy); module-level
#: so tests can patch the sleeps away.
CYCLE_RETRY_POLICY = RetryPolicy(tries=CYCLE_TRIES, base_s=0.25,
                                 multiplier=2.0, jitter=0.1,
                                 max_backoff_s=10.0)


def cycle(test):
    """Tears down, then sets up, the database on all nodes concurrently.
    If setup (or primary setup) raises SetupFailed, tear down and retry the
    whole process up to CYCLE_TRIES times on the CYCLE_RETRY_POLICY
    backoff (db.clj:121-158). The setup barrier is reset between
    attempts: a BarrierTimeout poisons threading.Barrier permanently, so
    without the reset every retry's first synchronize would fail
    instantly."""
    db = test["db"]

    def attempt():
        logger.info("Tearing down DB")
        c.on_nodes(test, db.teardown)
        logger.info("Setting up DB")
        c.on_nodes(test, db.setup)
        if isinstance(db, Primary):
            primary = test["nodes"][0]
            logger.info("Setting up primary %s", primary)
            c.on_nodes(test, db.setup_primary, [primary])

    def on_retry(_attempt, _exc):
        logger.warning("Unable to set up database; retrying...")
        from . import core
        core.reset_barrier(test)

    return CYCLE_RETRY_POLICY.call(
        attempt, retry_on_exception=SetupFailed, on_retry=on_retry,
        site="db.cycle")


class Tcpdump(DB, LogFiles):
    """A DB wrapper that runs a tcpdump capture from setup to teardown and
    yields the capture as a log file (db.clj:49-115). Options:

      clients_only: only capture traffic from the control node (jepsen
        clients), not inter-DB-node traffic.
      filter: an extra pcap filter string.
      ports: ports to capture traffic on.
    """

    DIR = "/tmp/jepsen/tcpdump"

    def __init__(self, opts=None):
        opts = opts or {}
        self.ports = opts.get("ports", [])
        self.clients_only = opts.get("clients_only", False)
        self.filter = opts.get("filter")
        self.log_file = f"{self.DIR}/log"
        self.cap_file = f"{self.DIR}/tcpdump"
        self.pid_file = f"{self.DIR}/pid"

    def _filter_str(self):
        from .control import net as cn
        filters = []
        if self.ports:
            filters.append(" and ".join(f"port {p}" for p in self.ports))
        if self.clients_only:
            filters.append(f"host {cn.control_ip()}")
        if self.filter:
            filters.append(self.filter)
        return " and ".join(f for f in filters if f)

    def setup(self, test, node):
        with c.su():
            c.exec_("mkdir", "-p", self.DIR)
            # -U: unbuffered; SIGINT is supposed to flush neatly but leaves
            # captures half-finished, so don't buffer at all (db.clj:84-92)
            cu.start_daemon(
                "/usr/sbin/tcpdump",
                "-w", self.cap_file, "-s", "65535", "-B", "16384", "-U",
                self._filter_str(),
                logfile=self.log_file, pidfile=self.pid_file,
                chdir=self.DIR)

    def teardown(self, test, node):
        with c.su():
            try:
                pid = c.exec_("cat", self.pid_file)
            except c.RemoteExecError:
                pid = None
            if pid:
                # nice clean exit if possible, so the capture flushes
                try:
                    c.exec_("kill", "-s", "INT", pid)
                except c.RemoteExecError:
                    pass
                while True:
                    try:
                        c.exec_("ps", "-p", pid)
                    except c.RemoteExecError:
                        break
                    logger.info("Waiting for tcpdump %s to exit", pid)
                    time.sleep(0.05)
            cu.stop_daemon(pidfile=self.pid_file, process_name="tcpdump")
            c.exec_("rm", "-rf", self.DIR)

    def log_files(self, test, node):
        return [self.log_file, self.cap_file]


def tcpdump(opts=None):
    return Tcpdump(opts)
