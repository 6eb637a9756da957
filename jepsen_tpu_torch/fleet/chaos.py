"""Seeded chaos profiles for the fleet's own control plane (the port's
copy of ``jepsen_tpu/fleet/chaos.py``; host-only: every profile and
seed gives the reference's faults, kills and skews).

The fleet layer (dispatch/worker/sync/service) claims to survive the
faults it injects into systems under test: dead workers, flaky
transports, torn files, wedged connections. Until this module, those
claims were exercised only by hand-built test fixtures over clean
loopback transports. A `ChaosProfile` turns the "real multi-host soak"
into a reproducible single-machine test: a seeded, deterministic
schedule of

* **exec faults** -- injected ssh-style ``exit-255``s, subprocess
  timeouts, and bounded hangs on the dispatcher's cell execs (the
  lease/steal/strike machinery's diet);
* **sync faults** -- failed and *partial* downloads (a torn copy that
  reports success; the manifest verification in `fleet.sync` must
  catch it) and failed uploads;
* **worker kills** -- scheduled ``kill -9``s riding the worker's
  die-once-marker mechanism, so a chosen cell's first lease dies
  mid-run and the cell is stolen;
* **a torn ledger tail** -- a partial line appended to the persistent
  compile ledger before the campaign starts, exercising the
  torn-tail tolerance for real;
* **a coordinator kill** -- SIGKILL the dispatcher itself right after
  a seeded cell's lease-grant append, leaving a half-run campaign with
  a live lease and a dead coordinator: the `fleet.ha` standby's whole
  reason to exist.

Faults are injected through `control.remotes.FaultyRemote`; this
module only decides *when*. Per-worker schedules derive from
``random.Random(f"{seed}|{worker_id}")`` with per-fault caps, so a
given ``(profile, seed)`` replays the same pattern per worker (caps
are per worker: totals scale with fleet width, and no worker can be
struck past the dispatcher's consecutive-failure retirement bound by
injection alone -- the soak must exercise recovery, not amputation).

CLI: ``--chaos-profile NAME[:SEED]`` (e.g. ``soak:42``); see
``PROFILES`` for the named shapes.
"""

from __future__ import annotations

import dataclasses
import logging
import random

logger = logging.getLogger(__name__)

__all__ = ["ChaosProfile", "PROFILES", "parse"]


@dataclasses.dataclass(frozen=True)
class ChaosProfile:
    """One seeded fault schedule. Probabilities are per transport op;
    ``*_max`` caps bound how many of each fault ONE worker's transport
    may see (keep the sum of exec-fault caps under the dispatcher's
    ``WORKER_STRIKES`` so injection alone can't retire a worker)."""

    name: str = "custom"
    seed: int = 0
    #: injected exec exit-255s (probability / per-worker cap)
    exec_exit255_p: float = 0.0
    exec_exit255_max: int = 0
    #: injected exec subprocess timeouts
    exec_timeout_p: float = 0.0
    exec_timeout_max: int = 0
    #: injected exec hangs (sleep, then timeout result)
    hang_p: float = 0.0
    hang_max: int = 0
    hang_s: float = 3.0
    #: failed downloads (exit-255 before any byte moves)
    download_fail_p: float = 0.0
    download_fail_max: int = 0
    #: partial downloads (largest file truncated, success reported)
    download_partial_p: float = 0.0
    download_partial_max: int = 0
    #: failed uploads
    upload_fail_p: float = 0.0
    upload_fail_max: int = 0
    #: how many cells get a die-once kill -9 marker
    kills: int = 0
    #: append a torn fragment to the compile ledger at campaign start
    torn_ledger_tail: bool = False
    #: SIGKILL the ACTIVE COORDINATOR right after a seeded cell's
    #: lease grant lands in the journal (once per campaign, die-once
    #: marker): the fleet.ha standby must detect the dead lease, fence
    #: the coordinator, and finish the campaign
    coordinator_kill: int = 0
    #: per-worker wall-clock skew: each struck worker's clock stamps
    #: (the clock handshake legs ``worker-received-epoch`` /
    #: ``worker-result-epoch``) shift by a seeded offset drawn from
    #: [-clock_skew_max_s, +clock_skew_max_s]; ``obs.merge``'s
    #: worker_offsets recovers it, and the txn family's realtime-edge
    #: inference must stay sound under it (skew-bound gating)
    clock_skew_p: float = 0.0
    clock_skew_max_s: float = 0.0

    def with_seed(self, seed):
        return dataclasses.replace(self, seed=int(seed))

    def describe(self):
        """The JSON-able shape journaled into campaign.json so a soak
        is reproducible from its artifacts alone."""
        return dataclasses.asdict(self)

    def faults_for(self, worker_id):
        """The ``faults(kind)`` callable `remotes.FaultyRemote` wants,
        seeded per worker. Candidates draw in a fixed order per kind
        so the schedule depends only on (seed, worker, op index)."""
        rng = random.Random(f"{self.seed}|{worker_id}")
        left = {
            "hang": self.hang_max,
            "exit-255": self.exec_exit255_max,
            "timeout": self.exec_timeout_max,
            "download-fail": self.download_fail_max,
            "download-partial": self.download_partial_max,
            "upload-fail": self.upload_fail_max,
        }

        def draw(key, p):
            # one rng draw per candidate per op, cap or no cap: the
            # schedule must not shift when an earlier cap runs out
            wants = rng.random() < p
            if wants and left[key] > 0:
                left[key] -= 1
                return True
            return False

        def faults(kind):
            if kind == "execute":
                if draw("hang", self.hang_p):
                    return ("hang", self.hang_s)
                if draw("exit-255", self.exec_exit255_p):
                    return "exit-255"
                if draw("timeout", self.exec_timeout_p):
                    return "timeout"
            elif kind == "download":
                if draw("download-fail", self.download_fail_p):
                    return "exit-255"
                if draw("download-partial", self.download_partial_p):
                    return "partial"
            elif kind == "upload":
                if draw("upload-fail", self.upload_fail_p):
                    return "exit-255"
            return None

        return faults

    def skew_for(self, worker_id):
        """This worker's injected wall-clock offset in seconds (0.0
        when unstruck): deterministic in (seed, worker), independent of
        the transport-fault draws."""
        if not self.clock_skew_p or not self.clock_skew_max_s:
            return 0.0
        rng = random.Random(f"{self.seed}|clock-skew|{worker_id}")
        if rng.random() >= self.clock_skew_p:
            return 0.0
        return round(rng.uniform(-self.clock_skew_max_s,
                                 self.clock_skew_max_s), 3)

    def skew_bound_s(self):
        """A sound bound on the pairwise clock disagreement this
        profile can inject: the width of the offset envelope (both
        tails) -- what a txn suite should pass as its skew bound."""
        return 2.0 * float(self.clock_skew_max_s) \
            if self.clock_skew_p and self.clock_skew_max_s else 0.0

    def plan_kills(self, cell_ids):
        """The deterministic set of cells whose FIRST lease kill -9s
        its worker (die-once markers make the second lease run)."""
        ids = sorted(str(c) for c in cell_ids)
        n = min(max(0, int(self.kills)), len(ids))
        if not n:
            return set()
        rng = random.Random(f"{self.seed}|kills")
        return set(rng.sample(ids, n))

    def plan_coordinator_kill(self, cell_ids):
        """The deterministic cell whose lease-grant append is the
        coordinator's last act (dispatch SIGKILLs itself right after
        journaling that grant), or None when this profile doesn't kill
        the coordinator. The first cell (sorted order) is skipped when
        there is any other choice so the kill lands MID-campaign --
        after some cells already ran -- which is the interesting
        takeover case."""
        ids = sorted(str(c) for c in cell_ids)
        if not self.coordinator_kill or not ids:
            return None
        rng = random.Random(f"{self.seed}|coordinator-kill")
        if len(ids) > 1:
            return ids[rng.randrange(1, len(ids))]
        return ids[0]


#: the named shapes ``--chaos-profile`` accepts. "soak" is the CI /
#: bench shape: a couple of exec exit-255s, one hang per worker, one
#: worker kill -9, one partial download, and a torn ledger tail --
#: every recovery path lit, no path pushed past its budget.
PROFILES = {
    "none": ChaosProfile(name="none"),
    "flaky-exec": ChaosProfile(
        name="flaky-exec",
        exec_exit255_p=0.4, exec_exit255_max=2,
        exec_timeout_p=0.2, exec_timeout_max=1),
    "lossy-sync": ChaosProfile(
        name="lossy-sync",
        download_fail_p=0.4, download_fail_max=2,
        download_partial_p=0.4, download_partial_max=2,
        upload_fail_p=0.2, upload_fail_max=1),
    "soak": ChaosProfile(
        name="soak",
        exec_exit255_p=0.5, exec_exit255_max=1,
        hang_p=0.4, hang_max=1, hang_s=2.0,
        download_partial_p=0.5, download_partial_max=1,
        kills=1, torn_ledger_tail=True),
    "coordinator-kill": ChaosProfile(
        name="coordinator-kill", coordinator_kill=1),
    # the txn family's clock soak: every worker's clock skews by up to
    # +/-45s (plus mild exec flakiness so skew composes with retries);
    # RT-edge inference must not fabricate anomalies from it
    "txn-skew": ChaosProfile(
        name="txn-skew",
        clock_skew_p=1.0, clock_skew_max_s=45.0,
        exec_exit255_p=0.2, exec_exit255_max=1),
}


def parse(spec):
    """``"soak"`` / ``"soak:42"`` -> a seeded ChaosProfile (also
    accepts a ready profile and passes it through)."""
    if isinstance(spec, ChaosProfile):
        return spec
    if spec is None:
        return None
    name, sep, seed = str(spec).partition(":")
    if name not in PROFILES:
        raise ValueError(f"unknown chaos profile {name!r}; known: "
                         f"{sorted(PROFILES)}")
    prof = PROFILES[name]
    if sep:
        try:
            prof = prof.with_seed(int(seed))
        except ValueError:
            raise ValueError(f"chaos profile seed {seed!r} should be "
                             "an integer") from None
    return prof


def tear_ledger_tail(ledger):
    """Append a torn (newline-less, unparseable) fragment to the
    persistent compile ledger: the on-disk state a writer killed
    mid-append leaves behind. The ledger's readers/appenders must
    tolerate it; this plants it on purpose."""
    try:
        with open(ledger.path, "ab") as f:
            f.write(b'{"key": ["chaos-torn')
            f.flush()
        logger.warning("chaos: tore the compile-ledger tail (%s)",
                       ledger.path)
    except OSError:  # pragma: no cover - ledger dir missing
        logger.warning("chaos: couldn't tear ledger tail",
                       exc_info=True)
