"""Folds that hold the fold kernel (``fold_kernel.py``) against its plain
version on the paths its bookkeeping adds.

``cases`` builds, from seeded histories, folds that must end in each of
the ways a fold can end and take each of the paths a lane can take: a
violation (status 1), an overflow in the middle of a fold (later events
no-ops), more open ops at a return than the open-op axis holds
(``n_open > C``), a lane batch with a pad lane, sealed slots cleared at
the end (``clear_w``), and the ``mutex``, ``register`` and
``multi-register-3`` models beside ``cas-register``. Each case's
``status`` is what each lane must end in, so a case that stopped
exercising its path would fail. The CPU tests hold ``fold_kernel.plain``
against the JAX package's fold on them; the card tests and
``chip_smoke.py`` hold the kernel against ``fold_kernel.plain``.

Histories stay under 62 ops and multi-register values avoid 0: the
reference's fingerprint pair is blind to a word's top bit at odd word
indices (ROADMAP.md C.3), so there the JAX fold's order, and so its
arrays, would part from the port's.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import numpy as np

from .. import models, simulate
from ..history import index, info_op, invoke_op, ok_op
from . import streamlin

__all__ = ["Case", "MULTI_KEYS", "NAMES", "cases", "multi_history",
           "spec_of"]

MULTI_KEYS = ("x", "y", "z")
#: the cases' names, in ``cases``' order
NAMES = ("violation", "overflow mid-fold", "n_open > C", "pad lane",
         "clear_w", "mutex", "mutex corrupted", "register",
         "register corrupted", "multi-register-3",
         "multi-register-3 corrupted")


class Case(NamedTuple):
    name: str
    model: str          # model name (multi-register over MULTI_KEYS)
    jobs: list          # FoldJobs of one shape, folded as one batch
    status: tuple       # each job's final status


def spec_of(model):
    if model.startswith("multi-register"):
        return models.multi_register_spec(MULTI_KEYS)
    return models.model_spec(model)


def multi_history(rng, n_procs, n_ops, crash_p=0.1):
    """A concurrent multi-register history over ``MULTI_KEYS``: writes of
    one or two keys (values 1-3), reads of every key, each applied at its
    completion, some completions lost (info)."""
    state = dict.fromkeys(MULTI_KEYS)
    hist, outstanding, done = [], {}, 0
    while done < n_ops or outstanding:
        free = [p for p in range(n_procs) if p not in outstanding]
        if free and done < n_ops and (not outstanding or rng.random() < .6):
            p = rng.choice(free)
            if rng.random() < 0.5:
                v = {k: rng.randrange(1, 4)
                     for k in rng.sample(MULTI_KEYS, rng.randrange(1, 3))}
                inv = invoke_op(p, "write", v)
            else:
                inv = invoke_op(p, "read", None)
            outstanding[p] = inv
            hist.append(inv)
            done += 1
            continue
        p = rng.choice(list(outstanding))
        inv = outstanding.pop(p)
        if inv["f"] == "write":
            state.update(inv["value"])
            v = inv["value"]
        else:
            v = dict(state)
        if rng.random() < crash_p:
            hist.append(info_op(p, inv["f"], inv["value"]))
        else:
            hist.append(ok_op(p, inv["f"], v))
    return index(hist)


def _corrupt_multi(rng, hist):
    """One ok read's value bumped on one key (probably no longer
    linearizable)."""
    reads = [i for i, o in enumerate(hist)
             if o["type"] == "ok" and o["f"] == "read"]
    o = hist[rng.choice(reads)]
    k = rng.choice(MULTI_KEYS)
    o["value"] = dict(o["value"], **{k: ((o["value"][k] or 0) % 3) + 1})
    return hist


def _corrupt_mutex(rng, hist):
    """One failed completion made ok (probably two holders at once)."""
    fails = [i for i, o in enumerate(hist) if o["type"] == "fail"]
    if fails:
        hist[rng.choice(fails)]["type"] = "ok"
    return hist


def _history(rng, model, n_ops, procs, crash_p, corrupt):
    if model.startswith("multi-register"):
        h = multi_history(rng, procs, n_ops, crash_p)
        return _corrupt_multi(rng, h) if corrupt else h
    h = simulate.random_history(rng, model, procs, n_ops, crash_p)
    if not corrupt:
        return h
    if model == "mutex":
        return _corrupt_mutex(rng, [dict(o) for o in h])
    return simulate.corrupt(rng, h)


def _status(job):
    """The final status of the job's fold on the CPU."""
    cpu = streamlin.FoldJob(job.spec, job.C, job.arrays, len(job), "cpu")
    return streamlin.solo_fold(cpu)["status"]


def _draw(rng, model, status, *, F=256, C=None, n_ops=48, procs=5,
          crash_p=0.05, corrupt=False, clear=False, device="cpu"):
    """The first job, drawn from ``rng``, whose fold ends in ``status``:
    the whole history of ``n_ops`` ops at F rows (C the history's open-op
    bucket unless given); with ``clear``, clear_w holds every slot that
    returns among its events."""
    spec = spec_of(model)
    for _ in range(64):
        e, init = spec.encode(_history(rng, model, n_ops, procs, crash_p,
                                       corrupt))
        job = streamlin.history_job(spec, e, init, F, device)
        if C is not None:
            job.C = C
        if clear:
            kinds, slots = job.arrays["ev_kind"], job.arrays["ev_slot"]
            cw = np.zeros(job.B, np.uint32)
            for s in slots[kinds == 2]:
                cw[s // 32] |= np.uint32(1) << np.uint32(s % 32)
            job.arrays["clear_w"] = cw
        if _status(job) == status:
            return job
    raise AssertionError(f"fold_cases: no {model} history ends in status "
                         f"{status}")


def cases(device="cpu"):
    """The cases, their jobs on ``device``."""
    rng = random.Random(45117)
    out = [
        Case("violation", "cas-register",
             [_draw(rng, "cas-register", 1, crash_p=0.0, corrupt=True,
                    device=device)], (1,)),
        # F = 16 rows: the frontier outgrows them after some passes
        Case("overflow mid-fold", "cas-register",
             [_draw(rng, "cas-register", 2, F=16, n_ops=56, procs=6,
                    crash_p=0.1, device=device)], (2,)),
        # C = 2: a return finds more ops open than the axis holds
        Case("n_open > C", "cas-register",
             [_draw(rng, "cas-register", 2, C=2, n_ops=40, procs=6,
                    crash_p=0.2, device=device)], (2,)),
        # three lanes of one shape: K = 4, lane 3 a pad lane
        Case("pad lane", "cas-register",
             [_draw(rng, "cas-register", s, F=64, C=8, corrupt=s == 1,
                    device=device) for s in (0, 1, 0)], (0, 1, 0)),
        Case("clear_w", "register",
             [_draw(rng, "register", 0, n_ops=50, crash_p=0.1,
                    clear=True, device=device)], (0,)),
    ]
    for model in ("mutex", "register", "multi-register-3"):
        out.append(Case(model, model,
                        [_draw(rng, model, 0, device=device)], (0,)))
        out.append(Case(model + " corrupted", model,
                        [_draw(rng, model, 1, corrupt=True,
                               device=device)], (1,)))
    return out

