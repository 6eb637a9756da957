"""Simulated concurrent histories for tests and benchmarks.

Runs a randomized concurrent schedule against a real sequential object
(register/cas-register/mutex/fifo-queue), recording invoke/ok/fail events,
with a tunable probability of lost completions (info ops). The histories are
linearizable by construction unless ``corrupt`` flips a read; this is the
same role the reference's simulated-time generator harness plays for its
tests (jepsen/src/jepsen/generator/test.clj) and what BASELINE.json's config
ladder is measured on.
"""

from __future__ import annotations

import random

from . import history as h


def random_history(rng: random.Random, spec_name: str, n_procs: int,
                   n_ops: int, crash_p: float = 0.1):
    """Generate an (indexed) event history for ``spec_name``."""
    hist = []
    if spec_name in ("register", "cas-register"):
        state = {"v": None}

        def gen_invoke(p):
            f = rng.choice(["read", "write", "cas"]
                           if spec_name == "cas-register"
                           else ["read", "write"])
            if f == "read":
                return h.invoke_op(p, "read", None)
            if f == "write":
                return h.invoke_op(p, "write", rng.randrange(4))
            return h.invoke_op(p, "cas", (rng.randrange(4), rng.randrange(4)))

        def apply(inv):
            f, v = inv["f"], inv["value"]
            if f == "read":
                return True, state["v"]
            if f == "write":
                state["v"] = v
                return True, v
            old, new = v
            if state["v"] == old:
                state["v"] = new
                return True, v
            return False, v
    elif spec_name == "mutex":
        state = {"locked": False}

        def gen_invoke(p):
            return h.invoke_op(p, rng.choice(["acquire", "release"]), None)

        def apply(inv):
            if inv["f"] == "acquire":
                if state["locked"]:
                    return False, None
                state["locked"] = True
                return True, None
            if not state["locked"]:
                return False, None
            state["locked"] = False
            return True, None
    elif spec_name in ("fifo-queue", "unordered-queue"):
        state = {"q": [], "next": 0}

        def gen_invoke(p):
            if rng.random() < 0.5:
                state["next"] += 1
                return h.invoke_op(p, "enqueue", state["next"])
            return h.invoke_op(p, "dequeue", None)

        def apply(inv):
            if inv["f"] == "enqueue":
                state["q"].append(inv["value"])
                return True, inv["value"]
            if state["q"]:
                i = (0 if spec_name == "fifo-queue"
                     else rng.randrange(len(state["q"])))
                return True, state["q"].pop(i)
            return False, None
    else:
        raise ValueError(f"unknown spec {spec_name!r}")

    outstanding = {}
    ops_done = 0
    while ops_done < n_ops or outstanding:
        free = [p for p in range(n_procs) if p not in outstanding]
        if free and ops_done < n_ops and (not outstanding
                                          or rng.random() < .6):
            p = rng.choice(free)
            inv = gen_invoke(p)
            outstanding[p] = inv
            hist.append(inv)
            ops_done += 1
        else:
            p = rng.choice(list(outstanding))
            inv = outstanding.pop(p)
            took_effect, res = apply(inv)
            if rng.random() < crash_p:
                hist.append(h.info_op(p, inv["f"], inv["value"]))
            elif took_effect:
                v = res if inv["f"] in ("read", "dequeue") else inv["value"]
                hist.append(h.ok_op(p, inv["f"], v))
            else:
                hist.append(h.fail_op(p, inv["f"], inv["value"]))
    return h.index(hist)


def corrupt(rng: random.Random, hist):
    """Flip one read/dequeue completion value to (probably) break
    linearizability."""
    hist = [h.Op(o) for o in hist]
    cands = [i for i, o in enumerate(hist)
             if o["type"] == "ok" and o["f"] in ("read", "dequeue")
             and o.get("value") is not None]
    if not cands:
        return hist
    i = rng.choice(cands)
    hist[i]["value"] = (hist[i]["value"] or 0) + rng.randrange(1, 5)
    return hist


def bench_histories(n_keys=256):
    """The JAX package's headline key batch (``bench.py`` rungs 2 and 2b)
    and its rung-4 FIFO history, drawn as ``bench.py`` draws them: the
    first 32 cas-register keys (200 ops, 8 processes, crash_p 0.02, every
    8th key corrupted) from ``random.Random(45100)``, which then draws
    rung 3's 10k-op mutex history (discarded here) and rung 4's 150-op,
    6-process FIFO history; the remaining keys from
    ``random.Random(20260730)``. Returns (the first ``n_keys`` keys, the
    FIFO history)."""
    rng = random.Random(45100)
    keys = []
    for k in range(32):
        hist = random_history(rng, "cas-register", 8, 200, 0.02)
        keys.append(corrupt(rng, hist) if k % 8 == 7 else hist)
    random_history(rng, "mutex", 64, 10_000, 0.02)
    fifo = random_history(rng, "fifo-queue", 6, 150, 0.02)
    rng2 = random.Random(20260730)
    for k in range(32, n_keys):
        hist = random_history(rng2, "cas-register", 8, 200, 0.02)
        keys.append(corrupt(rng2, hist) if k % 8 == 7 else hist)
    return keys[:n_keys], fifo
