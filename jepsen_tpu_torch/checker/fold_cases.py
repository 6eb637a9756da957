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
exercising its path would fail. Three more take the kernel's own
branches: a fold that starts from live rows out of fingerprint order
(the first pass sorts them with its candidates), a fold whose pool
outgrows the kernel's shared memory in some passes and not in others,
and two configs of one pass that share h1 and no other fingerprint (the
run of equal h1 is put in order after the sort); ``BRANCHES`` names the
kernel statistic (``fold_kernel.STAT_NAMES``) each must raise, which the
card's checks read, and the first and last are checked here on the host
as well. The CPU tests hold ``fold_kernel.plain`` against the JAX
package's fold on them; the card tests and ``chip_smoke.py`` hold the
kernel against ``fold_kernel.plain``.

Histories stay under 62 ops and multi-register values avoid 0: the
reference's fingerprint pair is blind to a word's top bit at odd word
indices (ROADMAP.md C.3), so there the JAX fold's order, and so its
arrays, would part from the port's.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import numpy as np
import torch

from .. import models, simulate
from ..history import index, info_op, invoke_op, ok_op
from . import fold_kernel, streamlin

__all__ = ["BRANCHES", "Case", "MULTI_KEYS", "NAMES", "cases",
           "multi_history", "spec_of"]

MULTI_KEYS = ("x", "y", "z")
#: the cases' names, in ``cases``' order
NAMES = ("violation", "overflow mid-fold", "n_open > C", "pad lane",
         "clear_w", "mutex", "mutex corrupted", "register",
         "register corrupted", "multi-register-3",
         "multi-register-3 corrupted", "rows out of order",
         "pool past shared memory", "h1 collision")
#: the kernel's branch each of the last cases takes: the statistic of
#: ``fold_kernel.STAT_NAMES`` its fold must raise on the card
BRANCHES = {"rows out of order": "full_sort_passes",
            "pool past shared memory": "global_pool_passes",
            "h1 collision": "fixup_passes"}


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


def _rows_in_order(job):
    """Whether the job's live rows are in (h1, h2, h3, h4) order."""
    a = job.arrays
    lin = torch.as_tensor(np.asarray(a["lin"]).view(np.int32))
    st = torch.as_tensor(np.asarray(a["st"]))
    h = fold_kernel._fingerprints(
        lin, st, fold_kernel._fingerprint_cols(job.B + job.S, "cpu"))
    rows = np.flatnonzero(np.asarray(a["live"]))
    keys = list(zip(*(x[rows].tolist() for x in h)))
    return keys == sorted(keys)


def _resumed(job, device):
    """``job`` resumed in the middle: its first events folded on the
    CPU, then the rest from the frontier they leave with its rows
    reversed, so that the live rows are out of fingerprint order (as a
    caller's rows, or rows clear_w changed, can be). The cut is the
    first event past the middle after which the frontier holds two live
    rows or more."""
    a = job.arrays
    kinds = np.asarray(a["ev_kind"])
    slots = np.asarray(a["ev_slot"])
    for cut in range(len(job) // 2, len(job)):
        head = dict(a, ev_kind=np.where(np.arange(kinds.size) < cut,
                                        kinds, 0))
        r = streamlin.solo_fold(
            streamlin.FoldJob(job.spec, job.C, head, cut, "cpu"))
        if r["n_live"] < 2:
            continue

        def tail(x):
            return np.concatenate([x[cut:], np.zeros(cut, np.int32)])

        out = streamlin.FoldJob(job.spec, job.C, dict(
            a, lin=r["lin"].numpy().view(np.uint32)[::-1].copy(),
            st=r["st"].numpy()[::-1].copy(),
            live=r["live"].numpy()[::-1].copy(),
            open_w=r["open_w"].numpy().view(np.uint32).copy(),
            ev_kind=tail(kinds), ev_slot=tail(slots)), len(job) - cut,
            device)
        if not _rows_in_order(out):
            return out
    raise AssertionError("fold_cases: no cut leaves live rows out of order")


def _collision_history(x, y):
    """Writes of x and y (slots 0 and 1) that never complete, and a read
    of nothing (slot 2) whose return is the fold's last event: its
    closure's first pool holds the configs ({slot 0}, x) and
    ({slot 1}, y), and the order it gives them stays in the fold's
    output rows."""
    return index([invoke_op(0, "write", x), invoke_op(1, "write", y),
                  invoke_op(2, "read", None), ok_op(2, "read", None),
                  info_op(0, "write", x), info_op(1, "write", y)])


def _h1_collision(rng, device):
    """The register job of ``_collision_history`` whose two configs share
    h1 and whose second (the later pool index) has the smaller h2, so
    the fold's order must swap the pair that a stable sort on h1 leaves
    in pool-index order: values found by a birthday search over 2^17
    values of each side, seeded from ``rng`` (about four colliding pairs
    are expected, since h1 has 32 bits, half of them in that h2 order).
    The configs differ in bitset word 0 (bit 0 against bit 1) and in the
    state word, so h1 agrees when the state words' terms differ by the
    bitset words' terms' difference."""
    spec = models.model_spec("register")
    B = streamlin.history_job(spec, *spec.encode(_collision_history(1, 2)),
                              device="cpu").B
    cols = fold_kernel.fingerprint_words(B + 1).astype(np.int64)
    c0, cs = int(cols[0, 0]), int(cols[0, B])
    mix = fold_kernel._mix
    gap = int(mix(torch.tensor(2), c0)) - int(mix(torch.tensor(1), c0))
    g = np.random.default_rng(rng.randrange(2**32))
    xs = torch.as_tensor(g.integers(1, 2**30, 1 << 17))
    ys = torch.as_tensor(g.integers(1, 2**30, 1 << 17))
    # h1(a) = mix(1, c0) + mix(x, cs) and h1(b) = mix(2, c0) + mix(y, cs)
    hx = ((mix(xs, cs) - gap) % 2**32).numpy()
    hy = mix(ys, cs).numpy()
    _, ix, iy = np.intersect1d(hx, hy, return_indices=True)
    for i, j in zip(ix, iy):
        x, y = int(xs[i]), int(ys[j])
        if x == y:
            continue
        job = streamlin.history_job(
            spec, *spec.encode(_collision_history(x, y)), device=device)
        lin = torch.zeros((2, B), dtype=torch.int32)
        lin[0, 0], lin[1, 0] = 1, 2
        h = fold_kernel._fingerprints(
            lin, torch.tensor([[x], [y]], dtype=torch.int32),
            fold_kernel._fingerprint_cols(B + 1, "cpu"))
        if h[0][0] == h[0][1] and h[1][1] < h[1][0]:
            return job
    raise AssertionError("fold_cases: the birthday search found no h1 "
                         "collision")


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
    out.append(Case("rows out of order", "cas-register",
                    [_resumed(_draw(rng, "cas-register", 0, F=256,
                                    device="cpu"), device)], (0,)))
    # F = 4096 rows, C = 16: passes of more candidates than the kernel's
    # shared pool holds (fold_kernel.SMEM_POOL) beside smaller ones, up
    # to the overflow
    out.append(Case("pool past shared memory", "cas-register",
                    [_draw(rng, "cas-register", 2, F=4096, n_ops=40,
                           procs=10, crash_p=0.2, device=device)], (2,)))
    out.append(Case("h1 collision", "register",
                    [_h1_collision(rng, device)], (0,)))
    return out

