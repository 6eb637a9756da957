"""Device-resident incremental linearizability: the streaming frontier
fold (the PyTorch port of ``jepsen_tpu.checker.streamlin``).

``checker/linear.py`` sweeps a history's *events* in time order,
maintaining the set of configurations (linearized-bitset, model state)
consistent with the prefix so far; an empty set at a return event is
the violation. The config set after a prefix is a *frontier* that later
events only ever extend, so the monitor keeps it ON DEVICE across chunk
boundaries (``monitor/wgl_stream.py`` owns the seal/probe split that
makes the carry sound) and re-checks a live stream in O(window):

    fold :: (frontier tensor, newly encoded cells) -> extended frontier

Device layout (all pow-2 shapes, a leading lane axis K of streams):

* ``lin``   (K, F, B) int32 -- per-config linearized bitset over window
                               SLOTS, uint32 bit patterns (B = NW/32)
* ``st``    (K, F, S) int32 -- per-config model state (fixed-width
                               models only; dynamic sizes fall back)
* ``live``  (K, F)    bool  -- which frontier rows are real configs
* ``open_w``(K, B)    int32 -- the open-op slot set as a bitset
* events    (K, E) host     -- 1 = invoke (opens the slot),
                               2 = return (forces the closure), 0 = pad

At a return event the fold runs the same BFS closure as the CPU sweep:
every not-yet-done config expands by every open op through the
branch-free ``spec.step`` (component first, over F*C candidates), the
pool dedups by multiply-shift fingerprints (sort + adjacent compare),
and the survivors compact back into the F rows.

The dedup differs from the JAX package's in one respect. The reference
keys it on one pair of 32-bit sums whose per-word multipliers
(``idx * 0x9E3779B1 + 0x85EBCA6B`` and ``idx * 0xC2B2AE35 + 0x27D4EB2F``)
are even at every odd word index, so the pair cannot tell apart configs
that differ only in those words' top bits (slots 62-63, 127, 189-191,
...): it drops one of them, and on histories of more than 62 ops the
offline face reports violations that the CPU sweep does not. Here a
second pair with odd multipliers (``words.hash_keys``) joins the sort
key after the reference's pair and the duplicate test, so distinct
configs survive. Where the reference's pair has no such collision, the
order, and so every carry array, is the reference's. ``n_keep > F`` or
more than C simultaneously-open slots flags overflow (status 2): the
caller grows the capacity and retries, or falls back to the flat
engines.

The JAX package compiles the fold into one program: a ``lax.scan`` over
the events, a ``lax.cond`` per event and a ``lax.while_loop`` of
closure passes per return. Its counterpart here is one launch of the
CUDA kernel ``csrc/fold.cu`` (``fold_kernel``): on the card the event
arrays go up once, every event of every lane and every closure pass run
in the kernel, and the results come back in one host read (``syncs``
counts it). Lanes (the reference's ``vmap``) are independent, so a
lane's result equals its solo fold; after a violation or an overflow
every later event of that lane is a no-op. On the CPU, and on the card
for a model the kernel has no step for, the fold is
``fold_kernel.plain``: a host loop over the events in torch ops that
reads, once before a return's first pass and once after each pass,
whether any lane still has work.

``check_encoded`` is the offline face: one fold over a whole encoded
history, with the verdict names of ``linear.check_encoded``.
``FoldJob``/``solo_fold``/``batch_fold`` run one stream or many streams
of one shape in one fold; under a bound obs registry ``batch_fold``
records the JAX batch fold's plan and heartbeat (``obs/search.py``)
from numbers it has already read. Each fold notes its plan shape to
the campaign's plan-shape counter (``campaign.compile_cache``, labels
``"torch-streamlin"`` / ``"torch-streamlin-batch"``). The service's
coalescer (``fleet/service.py``) batches monitored streams' folds on one
lane per model (``fold_lane_spec``, named ``"streamlin:<model>"``) and
hands each batch to ``batch_fold`` with its owners and event bucket.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..campaign import compile_cache
from ..history import INF_TIME
from ..obs import search as obs_search
from ..util import bucket as _bucket
from . import fold_kernel
# the fold's fingerprints, named here too
from .fold_kernel import _fingerprint_cols, _fingerprints  # noqa: F401

__all__ = ["DEFAULT_FRONTIER_CAP", "FRONTIER_CAP_MAX",
           "DEFAULT_WINDOW_CAP", "WINDOW_FLOOR", "OPEN_FLOOR",
           "EVENT_FLOOR", "STREAM_LANE_PREFIX", "FoldJob",
           "fold_lane_spec", "fresh_frontier", "history_job",
           "fold_inputs", "solo_fold", "batch_fold", "check_encoded"]

#: default / hard maximum frontier capacity (configs)
DEFAULT_FRONTIER_CAP = 4096
FRONTIER_CAP_MAX = 65536

#: initial frontier capacity floor (growth doubles, in pow-2 buckets)
FRONTIER_FLOOR = 64

#: window slot capacity: unsealed + forever-open (info) rows live in
#: slots; past the cap the stream degrades to flat re-checks
DEFAULT_WINDOW_CAP = 4096
WINDOW_FLOOR = 64

#: pow-2 floors for the open-op candidate axis and the event axis
OPEN_FLOOR = 8
EVENT_FLOOR = 64

#: the coalescer lane's model-name prefix: monitor folds queue per
#: ("streamlin:<model>", pow-2 event bucket) like WGL tenants queue
#: per (model, op bucket)
STREAM_LANE_PREFIX = "streamlin:"

#: positional order of FoldJob.arrays
_ARRAY_ORDER = ("lin", "st", "live", "open_w", "ev_kind", "ev_slot",
                "w_f", "w_args", "w_ret", "clear_w")

#: host reads of device values made by folds: a plain module counter;
#: set it to 0 before a run to count. On the card a fold whose model the
#: kernel knows makes one (its results); ``fold_kernel.plain`` also reads
#: its loop condition before and after every closure pass
syncs = 0
_syncs_lock = threading.Lock()


def _read(t):
    """One host read of a device tensor, counted."""
    global syncs
    with _syncs_lock:
        syncs += 1
    return t.tolist()


def _fold(step, arrays, ev_kind, ev_slot, C):
    """Fold the events ``ev_kind``/``ev_slot`` (host int (K, E)) into
    the frontiers ``arrays`` (device tensors with a leading lane axis
    K, named as ``_ARRAY_ORDER``): ``fold_kernel.run``, the kernel on the
    card. Returns (lin, st, live, open_w, status, viol, passes, steps,
    n_live), each with the lane axis."""
    return fold_kernel.run(step, arrays, ev_kind, ev_slot, C, read=_read)


def fresh_frontier(F, B, S, init_state):
    """The singleton frontier {(nothing linearized, init_state)} as
    host arrays shaped for the fold."""
    lin = np.zeros((F, B), np.uint32)
    st = np.zeros((F, S), np.int32)
    st[0] = np.asarray(init_state, np.int32)
    live = np.zeros(F, bool)
    live[0] = True
    open_w = np.zeros(B, np.uint32)
    return lin, st, live, open_w


def _tensor(a, dev):
    """A fold array (numpy, uint32 bitsets as int32 bit patterns, or a
    tensor) on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


class FoldJob:
    """One stream's frontier-extension step, for the solo path or a
    batch. ``arrays`` follow ``_ARRAY_ORDER``; ``len(job)`` is the REAL
    event count. Event arrays are host numpy; the frontier and window
    arrays may be tensors on the job's ``device`` (None: CUDA)."""

    __slots__ = ("spec", "C", "arrays", "n_events", "device")

    def __init__(self, spec, C, arrays, n_events, device=None):
        self.spec = spec
        self.C = int(C)
        self.arrays = arrays
        self.n_events = int(n_events)
        self.device = resolve_device(device)

    def __len__(self):
        return self.n_events

    @property
    def F(self):
        return int(self.arrays["lin"].shape[0])

    @property
    def B(self):
        return int(self.arrays["lin"].shape[1])

    @property
    def S(self):
        return int(self.arrays["st"].shape[1])

    @property
    def E(self):
        return int(self.arrays["ev_kind"].shape[0])

    @property
    def A(self):
        return int(self.arrays["w_args"].shape[1])

    def shape_key(self):
        return (self.spec.name, self.F, self.B, self.S, self.C, self.A)


class _FoldLaneSpec:
    """The coalescer's stand-in "model" for stream frontier folds:
    monitored streams queue per (``streamlin:<model>``, pow-2 event
    bucket) as WGL tenants queue per (model, op bucket), and one
    lane-batched fold answers the whole batch (``batch_fold``)."""

    __slots__ = ("name", "spec")

    def __init__(self, spec):
        self.spec = spec
        self.name = STREAM_LANE_PREFIX + spec.name


_lane_lock = threading.Lock()
_lane_specs: dict = {}


def fold_lane_spec(spec):
    """The interned coalescer lane spec for a model (one per model, so
    every stream of that model shares the lane)."""
    with _lane_lock:
        lane = _lane_specs.get(spec.name)
        if lane is None:
            lane = _lane_specs[spec.name] = _FoldLaneSpec(spec)
        return lane


def _results(out, batch=None):
    """Per-lane result dicts of one fold (one host read)."""
    rows = _read(torch.stack(list(out[4:9]), 1))
    res = []
    for k, (status, viol, passes, steps, n_live) in enumerate(rows):
        r = {"engine": "streamlin", "status": status, "viol_slot": viol,
             "passes": passes, "steps": steps, "n_live": n_live,
             "lin": out[0][k], "st": out[1][k], "live": out[2][k],
             "open_w": out[3][k]}
        if batch is not None:
            r["batch"] = batch
        res.append(r)
    return res


def fold_inputs(members, e_bucket=None):
    """The arguments of one fold (``_fold``/``fold_kernel.run``) over
    FoldJobs of one shape key and device: (step, arrays, ev_kind,
    ev_slot, C). One member folds as itself (K = 1); more pad the event
    axis to at least ``e_bucket`` and K to a pow-2 with inert lanes
    (member 0 with no events: a fold over zero events is the
    identity)."""
    dev = members[0].device
    if len(members) == 1:
        job = members[0]
        arrays = {k: _tensor(job.arrays[k], dev)[None]
                  for k in _ARRAY_ORDER if not k.startswith("ev_")}
        ev = {k: np.asarray(job.arrays[k], np.int32)[None]
              for k in ("ev_kind", "ev_slot")}
    else:
        E = _bucket(max(max(m.E for m in members), int(e_bucket or 1)),
                    EVENT_FLOOR)
        pad = _bucket(len(members), 1) - len(members)
        arrays = {}
        for name in _ARRAY_ORDER:
            if name.startswith("ev_"):
                continue
            parts = [_tensor(m.arrays[name], dev) for m in members]
            arrays[name] = torch.stack(parts + parts[:1] * pad)
        ev = {name: np.stack([_pad_events(m.arrays[name], E)
                              for m in members]
                             + [np.zeros(E, np.int32)] * pad)
              for name in ("ev_kind", "ev_slot")}
    return (members[0].spec.step, arrays, ev["ev_kind"], ev["ev_slot"],
            members[0].C)


def solo_fold(job):
    """Run one FoldJob. Returns the fold result dict; the frontier
    tensors stay on the job's device for the caller to re-commit."""
    compile_cache.note("torch-streamlin",
                       (job.spec.name, 1, job.F, job.B, job.S, job.C,
                        job.E, job.A))
    t0 = time.monotonic()
    r = _results(_fold(*fold_inputs([job])))[0]
    r["device_s"] = time.monotonic() - t0
    return r


def _pad_events(a, E):
    a = np.asarray(a, np.int32)
    if a.shape[0] == E:
        return a
    return np.pad(a, (0, E - a.shape[0]))


def batch_fold(jobs, owners=None, e_bucket=None):
    """Run many FoldJobs as lane-batched folds, grouped by full shape
    key and device (a mixed batch can never mis-stack). Each group's
    event axis pads to at least ``e_bucket`` (the coalescer's group
    bucket) and K to a pow-2 with inert (zero-event) lanes. ``owners``
    (parallel to ``jobs``) name the streams' tenants, pure metadata for
    the plan record. Returns one result dict per job, in order, each
    with ``batch``, the member count of its group."""
    results = [None] * len(jobs)
    groups: dict = {}
    for i, job in enumerate(jobs):
        groups.setdefault((job.shape_key(), job.device), []).append(i)
    t0 = time.monotonic()
    for (key, dev), idxs in groups.items():
        members = [jobs[i] for i in idxs]
        if len(members) == 1:
            results[idxs[0]] = dict(solo_fold(members[0]), batch=1)
            continue
        model, F, B, S, C, A = key
        args = fold_inputs(members, e_bucket)
        K, E = args[2].shape
        compile_cache.note("torch-streamlin-batch",
                           (model, K, F, B, S, C, E, A))
        out = _fold(*args)
        for i, r in zip(idxs, _results(out, batch=len(members))):
            results[i] = r
    dt = time.monotonic() - t0
    so = obs_search.capture()
    so.plan("streamlin-batch",
            _bucket(max((len(j) for j in jobs), default=1), EVENT_FLOOR),
            sum(len(j) for j in jobs), sum(j.E for j in jobs),
            keys=len(jobs), owners=len(set(owners)) if owners else 1)
    so.heartbeat("streamlin-batch", iteration=1, chunk_s=dt, device_s=dt,
                 frontier=max((r["n_live"] for r in results if r),
                              default=0))
    return results


def history_job(spec, e, init_state, F=FRONTIER_FLOOR, device=None):
    """The fold job of a whole encoded history, as the offline face
    folds it: every invoke and return in time order, op row i in slot i,
    the singleton frontier in F rows, and C the bucket of the history's
    peak count of open ops."""
    n = len(e)
    init = np.asarray(init_state, np.int32)
    S = max(1, int(init.shape[0]))
    A = int(spec.arg_width)
    NW = _bucket(n, WINDOW_FLOOR)
    B = NW // 32
    events = sorted(
        [(int(e.invoke_idx[i]), 1, i) for i in range(n)]
        + [(int(e.return_idx[i]), 2, i) for i in range(n)
           if e.return_idx[i] < INF_TIME])
    c_now = c_max = 0
    for _t, kind, _i in events:
        c_now += 1 if kind == 1 else -1
        c_max = max(c_max, c_now)
    C = min(NW, _bucket(max(1, c_max), OPEN_FLOOR))
    E = _bucket(len(events), EVENT_FLOOR)
    ev_kind = np.zeros(E, np.int32)
    ev_slot = np.zeros(E, np.int32)
    for k, (_t, kind, i) in enumerate(events):
        ev_kind[k] = kind
        ev_slot[k] = i
    w_f = np.zeros(NW, np.int32)
    w_args = np.zeros((NW, A), np.int32)
    w_ret = np.zeros((NW, A), np.int32)
    w_f[:n] = e.f
    w_args[:n] = np.asarray(e.args, np.int32).reshape(n, A)
    w_ret[:n] = np.asarray(e.ret, np.int32).reshape(n, A)
    lin, st, live, open_w = fresh_frontier(F, B, S, init)
    return FoldJob(spec, C, {
        "lin": lin, "st": st, "live": live, "open_w": open_w,
        "ev_kind": ev_kind, "ev_slot": ev_slot, "w_f": w_f,
        "w_args": w_args, "w_ret": w_ret,
        "clear_w": np.zeros(B, np.uint32)}, len(events), device)


def check_encoded(spec, e, init_state, max_configs=DEFAULT_FRONTIER_CAP,
                  cancel=None, device=None):
    """The offline face: one frontier fold over a whole encoded history
    on ``device`` (None: CUDA). Same verdict names as
    ``linear.check_encoded`` (True / False with the violating ``op`` /
    "unknown" with ``max-configs-exceeded``); ``configs_explored``
    counts model-step evaluations."""
    n = len(e)
    if n == 0 or e.n_ok == 0:
        return {"valid": True, "configs_explored": 0,
                "engine": "streamlin"}
    dev = resolve_device(device)
    cap = min(_bucket(max(1, int(max_configs))), FRONTIER_CAP_MAX)
    F = min(cap, FRONTIER_FLOOR)
    steps = 0
    while True:
        if cancel is not None and cancel.is_set():
            return {"valid": "unknown", "error": "cancelled",
                    "configs_explored": steps, "engine": "streamlin"}
        r = solo_fold(history_job(spec, e, init_state, F, dev))
        steps += r["steps"]
        if r["status"] == 2 and F < cap:
            F = min(cap, F * 2)
            continue
        break
    if r["status"] == 2:
        return {"valid": "unknown", "error": "max-configs-exceeded",
                "configs_explored": steps, "engine": "streamlin",
                "frontier_cap": F}
    if r["status"] == 1:
        out = {"valid": False, "configs_explored": steps,
               "engine": "streamlin"}
        i = r["viol_slot"]
        if e.ops is not None and 0 <= i < len(e.ops):
            inv, comp = e.ops[i]
            out["op"] = dict(comp if comp is not None else inv)
        return out
    return {"valid": True, "configs_explored": steps,
            "engine": "streamlin", "frontier": r["n_live"]}
