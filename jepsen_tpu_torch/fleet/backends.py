"""Backend failover tiering: a card that is down degrades a campaign
to slower verdicts instead of none (the port's copy of
``jepsen_tpu/fleet/backends.py``).

An ordered ladder of backend *tiers*::

    gpu -> cpu

each with a health probe (torch's CUDA init and a small allocation on
the card, in a KILLABLE subprocess: a wedged CUDA stack hangs rather than
errors) and a cached verdict, so per-cell tier choice costs a dict
lookup, not a probe. The last tier (``cpu``) is the unconditional
floor: the CPU engines (the ``linear`` event sweep, the plain PyTorch
paths on the CPU) still produce verdicts -- slower, budget-capped, but
never none.

The reference's tiers are JAX platforms (``tpu``, ``gpu``, ``cpu``),
and its workers reach theirs through ``JAX_PLATFORMS``. The port's
differ (ROADMAP.md, deliberate divergences):

* there is no ``tpu`` tier; a ladder that names one raises
  ``ValueError`` saying so;
* no tier travels through an environment variable that hides the
  card. A tier is the cell's ``device`` option (``tier_options``: the
  port's own option, ``demo.py``) plus, for ``cpu``, the ``linear``
  algorithm on every ``Linearizable`` gate (``apply``).

Two application points:

* **in-process** (campaign scheduler): the cell's test map is already
  built, so ``apply`` degrades the CHECKER -- every ``Linearizable``
  gate in the cell's checker tree is re-pointed at the tier's
  algorithm (cpu tier -> the ``linear`` event-sweep, the monitor's own
  CPU-only choice).
* **cross-process** (fleet dispatch / workers): the worker overlays
  ``tier_options`` on the cell's options before it builds the test
  map, then applies the tier as above.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import threading
import time

logger = logging.getLogger(__name__)

__all__ = ["TIERS", "DEFAULT_LADDER", "tier_options", "probe", "Failover",
           "ladder_of", "as_failover", "apply"]

#: known tiers: the cell's ``device`` option + the in-process checker
#: algorithm the tier degrades to (None = leave the checker's own
#: choice alone)
TIERS = {
    "gpu": {"device": "cuda", "algorithm": None},
    "cpu": {"device": "cpu", "algorithm": "linear"},
}

#: the default failover ladder, best tier first
DEFAULT_LADDER = ("gpu", "cpu")

#: how long one probe verdict stays fresh
PROBE_TTL_S = 300.0

PROBE_TIMEOUT_S = 60.0

#: what the probe subprocess runs per tier: CUDA init plus one small
#: allocation and a host read on the card, or just the import
_PROBES = {
    "gpu": ("import torch\n"
            "assert torch.cuda.is_available(), 'no CUDA device'\n"
            "x = torch.ones(1024, device='cuda')\n"
            "assert float(x.sum().item()) == 1024.0\n"),
    "cpu": "import torch\nassert float(torch.ones(4).sum()) == 4.0\n",
}


def _check_tier(tier):
    tier = str(tier)
    if tier == "tpu":
        raise ValueError("the port has no TPU tier: its tiers are "
                         f"{list(TIERS)} (ROADMAP.md, deliberate "
                         "divergences)")
    if tier not in TIERS:
        raise ValueError(f"unknown backend tier {tier!r}; known: "
                         f"{list(TIERS)}")
    return tier


def tier_options(tier):
    """The cell options a fresh worker process overlays to run on
    ``tier``: its ``device``."""
    return {"device": TIERS[_check_tier(tier)]["device"]}


def probe(tier, timeout_s=PROBE_TIMEOUT_S):
    """Is ``tier`` usable? Probed in a killable subprocess -- a wedged
    CUDA stack can hang its init, and a hang must read as "down", not
    block the scheduler. Returns None when healthy, an error string
    otherwise."""
    code = _PROBES[_check_tier(tier)]
    try:
        p = subprocess.run([sys.executable, "-c", code],
                           timeout=timeout_s, capture_output=True,
                           text=True)
    except subprocess.TimeoutExpired:
        return f"backend init hung >{timeout_s:g}s"
    except OSError as e:  # pragma: no cover - no python?!
        return repr(e)
    if p.returncode == 0:
        return None
    return (p.stderr.strip()[-300:] or "backend init failed")


class Failover:
    """The per-campaign tier chooser: probe verdicts cached with a TTL
    so the scheduler consults it per CELL for the cost of a lookup,
    while a tier that comes back up is noticed within ``ttl_s``."""

    def __init__(self, ladder=DEFAULT_LADDER, probe_fn=probe,
                 ttl_s=PROBE_TTL_S, probe_timeout_s=PROBE_TIMEOUT_S):
        ladder = [str(t) for t in ladder]
        if "tpu" in ladder:
            _check_tier("tpu")
        unknown = [t for t in ladder if t not in TIERS]
        if unknown:
            raise ValueError(f"unknown backend tier(s) {unknown}; "
                             f"known: {list(TIERS)}")
        if not ladder:
            raise ValueError("failover ladder needs at least one tier")
        self.ladder = ladder
        self.probe_fn = probe_fn
        self.ttl_s = float(ttl_s)
        self.probe_timeout_s = probe_timeout_s
        self._lock = threading.Lock()
        self._probe_lock = threading.Lock()
        self._cache = {}     # tier -> (monotonic stamp, error|None)

    def _cached(self, tier):
        with self._lock:
            hit = self._cache.get(tier)
            if hit is not None \
                    and time.monotonic() - hit[0] < self.ttl_s:
                return hit
        return None

    def health(self, tier):
        """Cached probe verdict for one tier (None = healthy). Probes
        are serialized and double-checked: N worker threads missing
        the cache together must launch ONE probe subprocess, not N
        interpreter boots."""
        hit = self._cached(tier)
        if hit is not None:
            return hit[1]
        with self._probe_lock:
            hit = self._cached(tier)   # a peer probed while we waited
            if hit is not None:
                return hit[1]
            err = self.probe_fn(tier, timeout_s=self.probe_timeout_s)
            if err is not None:
                logger.warning("backend tier %r unhealthy: %s", tier,
                               err)
            with self._lock:
                self._cache[tier] = (time.monotonic(), err)
            return err

    def choose(self):
        """The best healthy tier; the ladder's LAST tier is the
        unconditional floor (degraded verdicts beat none)."""
        for tier in self.ladder[:-1]:
            if self.health(tier) is None:
                return tier
        return self.ladder[-1]

    def apply(self, test, tier):
        """In-process degrade: re-point the cell's checker at the
        tier's algorithm (see module docstring)."""
        apply(test, tier)


def apply(test, tier):
    """Rewrite every Linearizable gate in ``test``'s checker tree to
    the tier's algorithm and stamp ``test["backend"]``. A tier whose
    algorithm is None (a healthy card) leaves the checker alone."""
    algorithm = TIERS[_check_tier(tier)]["algorithm"]
    test["backend"] = str(tier)
    if algorithm is None:
        return test
    from ..checker.checkers import Linearizable
    seen = set()

    def walk(c):
        if c is None or id(c) in seen:
            return
        seen.add(id(c))
        if isinstance(c, Linearizable):
            c.algorithm = algorithm
            return
        for attr in ("inner", "checker"):
            walk(getattr(c, attr, None))
        cmap = getattr(c, "checker_map", None)
        if isinstance(cmap, dict):
            for child in cmap.values():
                walk(child)

    walk(test.get("checker"))
    return test


def ladder_of(x):
    """The tier names of run_cells/run_fleet's ``backends`` argument, in
    every shape ``as_failover`` takes (a Failover, a tier list, a comma
    string, True), without building a Failover: planlint PL014 lints
    these names. The reference hands the raw argument to PL014, which
    reads a comma string character by character and cannot iterate a
    Failover (ROADMAP.md C.10)."""
    if isinstance(x, Failover):
        return list(x.ladder)
    if x is True:
        return list(DEFAULT_LADDER)
    if isinstance(x, str):
        return [t.strip() for t in x.split(",") if t.strip()]
    return [str(t) for t in x]


def as_failover(x):
    """Coerce run_cells/run_fleet's ``backends`` argument: an existing
    Failover passes through; a tier list (or comma string) becomes the
    ladder; True means the default ladder."""
    if isinstance(x, Failover):
        return x
    if x is True:
        return Failover()
    if isinstance(x, str):
        x = [t.strip() for t in x.split(",") if t.strip()]
    return Failover(ladder=list(x))
