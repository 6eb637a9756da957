"""Rank processes for the port's mesh tests (``test_torch_searchshard``,
``test_torch_keyshard_mesh``): ``spawn`` starts D processes joined by a
gloo process group over a ``FileStore`` (no TCP port), each runs the
same jobs over a 1-D "cpu" ``DeviceMesh``, and rank r's outputs come
back as the r-th list. The ranks import only torch and
``jepsen_tpu_torch``."""

import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _spec(model, fast_check=True):
    from jepsen_tpu_torch import models
    spec = models.model_spec(model)
    return spec if fast_check else dataclasses.replace(spec,
                                                       fast_check=None)


def job_sharded(mesh, model, hist, **kw):
    """``check_history_sharded`` on one history."""
    from jepsen_tpu_torch.parallel import check_history_sharded
    return check_history_sharded(_spec(model), hist, mesh, **kw)


def job_obs(mesh, job, **kw):
    """Job ``job`` under a fresh bound registry and tracer
    (``obs.run_scope``): its output, the registry's snapshot and the
    trace's events."""
    from jepsen_tpu_torch import obs
    test = {}
    with obs.run_scope(test):
        r = JOBS[job](mesh, **kw)
    return (r, test["obs"]["registry"].snapshot(),
            test["obs"]["tracer"].events())


def job_carries(mesh, model, hist, bounds):
    """This rank's sharded-search carry (the JAX layout, K=1, one table
    group) after the iteration bounds ``bounds``, built as
    ``check_encoded_sharded`` builds its search."""
    from jepsen_tpu_torch.checker import torch_wgl as tw
    from jepsen_tpu_torch.parallel import keyshard
    spec = _spec(model)
    e, st = spec.encode(hist)
    (_, inv32, ret32, fop, args, rets, ok_words, st, n_pad, C, A,
     S) = tw._prepare_search(spec, e, st)[1]
    B, W, O, T = tw._plan_sizes(n_pad, S, C)
    group = keyshard.mesh_group(mesh)
    init_carry, _, run_chunk = tw._build_search(
        spec.step, 1, n_pad, B, S, C, A, W, O, T, device="cpu",
        group=group)
    consts = tw.make_consts(inv32, ret32, fop, args, rets, ok_words, "cpu")
    carry = init_carry(st[None])
    if dist.get_rank(group):
        carry = (carry[:tw.IDX_TOP] + (torch.zeros_like(carry[tw.IDX_TOP]),)
                 + carry[tw.IDX_TOP + 1:])
    out = []
    for b in bounds:
        carry = run_chunk(carry, consts, b)
        out.append(tw.carry_to_numpy(carry))
    return out


def job_batch(mesh, model, hists, fast_check=True, **kw):
    """``check_batch_encoded`` over the mesh."""
    from jepsen_tpu_torch.parallel import check_batch_encoded
    spec = _spec(model, fast_check)
    return check_batch_encoded(spec, [spec.encode(h) for h in hists],
                               mesh=mesh, **kw)


def job_check(mesh, model, hist, independent=False, **engine_opts):
    """``checker.core.check`` with ``linearizable(jax-wgl)`` over the
    mesh; with ``independent``, under the independent checker, the
    history's ``[k v]`` lists becoming the port's tuples."""
    from jepsen_tpu_torch import independent as ind
    from jepsen_tpu_torch.checker import checkers as ck
    from jepsen_tpu_torch.checker import core as cc
    if independent:
        hist = [{**o, "value": ind.tuple_(*o["value"])} for o in hist]
    c = ck.linearizable({"model": model, "algorithm": "jax-wgl",
                         "engine_opts": {"mesh": mesh, **engine_opts}})
    test = {}
    r = cc.check(ind.checker(c) if independent else c, test, hist)
    return r, test.get("certificate")


def job_refusals(mesh):
    """The mesh refusals: a 2-D mesh, a device that disagrees with the
    mesh, a mesh under another algorithm. Returns the exception types
    and messages."""
    from torch.distributed.device_mesh import init_device_mesh
    from jepsen_tpu_torch.checker import checkers as ck
    from jepsen_tpu_torch.parallel import (check_batch_encoded,
                                           check_encoded_sharded)
    spec = _spec("cas-register")
    e, st = spec.encode([])
    D = mesh.size()
    flat = init_device_mesh("cpu", (1, D), mesh_dim_names=("a", "b"))
    out = []
    for call in (lambda: check_encoded_sharded(spec, e, st, flat),
                 lambda: check_batch_encoded(spec, [(e, st)], mesh=flat),
                 lambda: check_encoded_sharded(spec, e, st, mesh,
                                               device="cuda"),
                 lambda: ck.linearizable({"model": "cas-register",
                                          "engine_opts": {"mesh": mesh}})):
        try:
            call()
            out.append(None)
        except Exception as err:  # noqa: BLE001 - the refusal is the result
            out.append((type(err).__name__, str(err)))
    return out


JOBS = {"sharded": job_sharded, "obs": job_obs, "carries": job_carries,
        "batch": job_batch, "check": job_check, "refusals": job_refusals}


def _rank(rank, D, store, jobs_path, out_path):
    # a rank stands without JAX: any import of it fails loudly
    sys.modules["jax"] = None
    sys.modules["jepsen_tpu"] = None
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, D),
                            rank=rank, world_size=D)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (D,), mesh_dim_names=("search",))
        with open(jobs_path, "rb") as f:
            jobs = pickle.load(f)
        out = [JOBS[name](mesh, **kw) for name, kw in jobs]
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(tmp_dir, D, jobs):
    """Run ``jobs`` (a list of (job name, kwargs)) on D gloo ranks;
    returns one list of outputs per rank."""
    tmp_dir = str(tmp_dir)
    jobs_path = os.path.join(tmp_dir, f"jobs{D}.pkl")
    out_path = os.path.join(tmp_dir, f"out{D}")
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    mp.spawn(_rank, args=(D, os.path.join(tmp_dir, f"store{D}"), jobs_path,
                          out_path), nprocs=D)
    outs = []
    for r in range(D):
        with open(f"{out_path}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs


#: series whose values are seconds, and event fields that follow the
#: clock: compared by presence only
TIMED = ("wgl.phase_s", "wgl.device_busy_s")
CLOCKED = ("chunk_s", "device_s")


def obs_series(snap):
    """{(kind, series key): value} of a registry snapshot, seconds mapped
    to None, histograms to their counts; the JAX package's compile
    ledger (``campaign.*``) left out and its ``compile`` lap read as a
    ``device`` lap (the port arms it on the card only)."""
    out = {}
    for kind in ("counters", "gauges", "histograms"):
        for k, v in snap[kind].items():
            if k.startswith("campaign."):
                continue
            k = k.replace("phase=compile", "phase=device")
            if kind == "histograms":
                v = v["count"]
            out[(kind, k)] = None if k.startswith(TIMED) else v
    return out


def obs_events(events):
    """The wgl.* instant events with their clock-free args, and the set
    of wgl.* span names."""
    instants, spans = [], set()
    for e in events:
        name = e["name"].replace("wgl.phase.compile", "wgl.phase.device")
        if not name.startswith("wgl."):
            continue
        if e.get("cat") == "phase" or e["ph"] == "X":
            spans.add(name)
        else:
            instants.append((name, e["ph"], {
                k: v for k, v in (e.get("args") or {}).items()
                if k not in CLOCKED}))
    return instants, spans


def concat_carries(per_rank):
    """The ranks' carries (JAX layout, one table group each) as the JAX
    sharded search's global carry: every array concatenated along its
    leading axis in rank order."""
    return [np.concatenate([c[i] for c in per_rank]) for i in
            range(len(per_rank[0]))]
