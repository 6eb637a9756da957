"""StreamCheck: the chunk loop around the device-resident frontier
(``checker/streamlin.py``); the PyTorch port of
``jepsen_tpu.monitor.wgl_stream``.

The naive carry -- fold every chunk's events into a persistent
frontier -- is UNSOUND: a config may speculatively linearize a
still-open op using its unknown (NIL) result, and when the concrete
result lands later the offline sweep would have pruned differently.
The fix is the **stable horizon**:

    horizon = min(invoke index) over TRULY-OPEN rows
              (awaiting a completion -- ``StreamEncoder._open``)

Every event before the horizon belongs to a row whose encoding is
final: completed-ok rows carry their concrete result, info rows stay
NIL *forever*. So each chunk check runs at most three device steps,
none of which grows with the prefix:

* **upload** -- scatter the chunk's new/re-encoded rows into the
  device-resident window tensors;
* **seal** -- fold events that crossed the horizon into the committed
  frontier, exactly once per event. Fully-sealed slots recycle: their
  bit is set in every surviving config, so a uniform mask clears them;
* **probe** -- fold the open-window events [horizon, now) from the
  sealed frontier and read the verdict; the probe frontier is
  discarded (those rows may still re-encode).

Seal+probe sweep the identical event sequence with identical encoded
data as the offline engine on the full prefix, so verdicts are EXACTLY
the offline engine's. The designed degrades, each counted:

* frontier overflow pow-2-grows (``util.bucket``) up to the
  configured cap; past it a SEAL overflow degrades the stream
  permanently to flat re-checks and a PROBE overflow falls back flat
  for that one chunk;
* dynamic-state-size models (queues) and window-slot exhaustion degrade
  to flat re-checks the same way;
* a False frontier verdict is a *suspicion*: the flat engine re-checks
  the materialized prefix and owns the verdict of record and the
  witness, so a fingerprint collision can cost a confirm, never a wrong
  verdict.

Anything else -- a device or build error in a fold -- raises: the JAX
package's catch-alls that degrade a crashed stream are not carried
over.

Chunk folds route through the service's coalescer when one is
configured (``fleet.service.configure_coalesce``) and the stream's
``coalesce?`` option is on (the default): monitored streams share
lane-batched ``(streamlin:<model>, event bucket)`` folds as
``/api/check`` tenants share key batches. A fold whose deadline
(``FOLD_DEADLINE_S``) passes in the queue, or whose coalescer was
stopped, folds solo; a failed batch raises here as a failed solo fold
does (the reference folds solo after any coalescer error). With no
coalescer every fold runs solo (``streamlin.solo_fold``).

Telemetry: the obs sinks in force when a ``StreamCheck`` is built are
the ones it reports to for its whole life (``so.plan`` once, a
``streamlin`` heartbeat per chunk check, and the JAX package's
``monitor.*`` counters and gauges). ``monitor.stream_fallbacks`` has no
counterpart: the reference counts its catch-all degrades there, which
the port does not have.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs, resolve_device
from ..checker import streamlin
from ..obs import search as obs_search
from ..util import DEFAULT_N_FLOOR
from ..util import bucket as _bucket
from .stream import StreamEncoder

__all__ = ["StreamCheck", "FOLD_DEADLINE_S"]

#: per-fold coalescer deadline: a fold is one bounded dispatch, so the
#: budget only matters when the batcher is wedged -- after it the
#: stream folds solo
FOLD_DEADLINE_S = 30.0


class _Degrade(Exception):
    """Internal: permanently degrade this stream to flat re-checks."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


def _pad(x, dim, n):
    """``x`` with ``n`` zero entries appended along ``dim``."""
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, x.new_zeros(shape)], dim)


class StreamCheck:
    """One monitored stream's incremental checker on ``device`` (None:
    CUDA). Duck-types the StreamEncoder surface (``offer`` /
    ``materialize`` / ``truncate_before`` / ``__len__``) and adds
    ``check(cancel)``. Flat checks and confirms
    run ``confirm-engine`` (default ``jax-wgl``, the device search) on
    the same device. ``owner`` (or ``opts["owner"]``) names the stream's
    tenant to the service's coalescer."""

    def __init__(self, spec, init_ops=(), opts=None, device=None,
                 owner="monitor"):
        opts = dict(opts or {})
        self.spec = spec
        self.device = resolve_device(device)
        self.enc = StreamEncoder(spec, init_ops)
        cap = int(opts.get("frontier-cap")
                  or streamlin.DEFAULT_FRONTIER_CAP)
        self.frontier_cap = min(streamlin.FRONTIER_CAP_MAX,
                                _bucket(max(1, cap)))
        self.window_cap = _bucket(int(opts.get("window-cap")
                                      or streamlin.DEFAULT_WINDOW_CAP))
        self.confirm_engine = opts.get("confirm-engine") or "jax-wgl"
        self.confirm_opts = {"device": self.device,
                             **(opts.get("confirm-opts") or {})}
        self.coalesce = bool(opts.get("coalesce?", True))
        self.owner = str(opts.get("owner") or owner)
        # the sinks of this stream's whole life, captured now
        _, self._reg = obs.current_sinks()
        self.so = obs_search.capture()
        self._planned = False
        # counters (stream_summary)
        self.checks = 0
        self.seal_folds = 0
        self.probe_folds = 0
        self.fold_passes = 0
        self.fold_cells = 0
        self.frontier_grows = 0
        self.window_grows = 0
        self.flat_checks = 0
        self.probe_overflows = 0
        self.confirm_mismatches = 0
        self.coalesced_folds = 0
        self.solo_folds = 0
        #: widest batch any of this stream's folds rode (>= 2 shows
        #: strangers' streams shared a fold)
        self.batch_peak = 1
        self.sealed_rows = 0
        self.frontier_size = 1
        self.frontier_peak = 1
        self.device_s = 0.0
        #: non-None once the stream degraded to flat re-checks, with
        #: the reason (fallbacks are permanent except probe overflow)
        self.fallback = None
        # the frontier tensor is (F, S) and carries across chunks, so S
        # must not depend on the (growing) encoded history
        try:
            self.S = int(spec.state_size(None))
        except (AttributeError, TypeError):  # queues: sized by the history
            self.S = None
            self.fallback = "dynamic-state-size"
        # host bookkeeping for the device window
        self.F = None               # frontier rows (set at first check)
        self.NW = streamlin.WINDOW_FLOOR
        self.C = streamlin.OPEN_FLOOR
        self._committed = None      # (lin, st, live, open_w)
        self._window = None         # (w_f, w_args, w_ret)
        self._free = list(range(self.NW - 1, -1, -1))
        self._slot_by_row = {}      # id(row) -> slot
        self._row_by_slot = {}      # slot -> row (pins the row object)
        self._open_committed = 0    # open slots in the COMMITTED set
        self._pending = []          # (t, kind, row): unsealed events
        self._dirty = {}            # slot -> row awaiting upload
        if self.fallback is None:
            for row in self.enc.rows:   # init_ops: already-closed rows
                self._admit(row)

    # -- encoder surface --------------------------------------------------

    def __len__(self):
        return len(self.enc)

    @property
    def last_index(self):
        return self.enc.last_index

    @property
    def skipped(self):
        return self.enc.skipped

    def materialize(self):
        return self.enc.materialize()

    def truncate_before(self, cut_invoke_idx, seed_invoke_idx=None):
        # quiescent-cut carry: bounds the FLAT fall-back's materialized
        # prefix; the device window tracks rows on its own
        return self.enc.truncate_before(cut_invoke_idx, seed_invoke_idx)

    def offer(self, op, index):
        p = op.get("process")
        prev = self.enc._open.get(p)
        completed = self.enc.offer(op, index)
        if self.fallback is not None:
            return completed
        try:
            t = op.get("type")
            if t == "invoke":
                row = self.enc._open.get(p)
                if row is not None and row is not prev:
                    self._admit(row)
            elif completed and prev is not None:
                if t == "fail":
                    self._discard(prev)
                elif prev.is_ok:
                    self._complete(prev)
                # info (or an ok whose re-encode failed): the window
                # row is already final -- NIL result, open forever
        except _Degrade as d:
            self._degrade(d.reason)
        return completed

    # -- window bookkeeping ---------------------------------------------

    def _degrade(self, reason):
        if self.fallback is None:
            self.fallback = str(reason)

    def _inc(self, name, n=1):
        if self._reg is not None:
            self._reg.inc(name, n)

    def _admit(self, row):
        if not self._free:
            self._grow_window()
        slot = self._free.pop()
        self._slot_by_row[id(row)] = slot
        self._row_by_slot[slot] = row
        self._dirty[slot] = row
        self._pending.append((row.invoke_idx, 1, row))
        if row.is_ok:
            self._pending.append((row.return_idx, 2, row))

    def _complete(self, row):
        slot = self._slot_by_row.get(id(row))
        if slot is None:
            raise _Degrade("completion-for-unknown-row")
        self._dirty[slot] = row          # ok re-encoded args/ret
        self._pending.append((row.return_idx, 2, row))

    def _discard(self, row):
        # fail: the op definitely did not happen. A truly-open row's
        # invoke is >= horizon by definition, so it was never sealed
        # and removing its pending invoke erases it entirely.
        slot = self._slot_by_row.pop(id(row), None)
        if slot is None:
            return
        self._row_by_slot.pop(slot, None)
        self._dirty.pop(slot, None)
        self._pending = [ev for ev in self._pending
                         if ev[2] is not row]
        self._free.append(slot)

    def _grow_window(self):
        NW2 = self.NW * 2
        if NW2 > self.window_cap:
            raise _Degrade("window-overflow")
        B, B2 = self.NW // 32, NW2 // 32
        if self._committed is not None:
            lin, st, live, open_w = self._committed
            self._committed = (_pad(lin, 1, B2 - B), st, live,
                               _pad(open_w, 0, B2 - B))
        if self._window is not None:
            self._window = tuple(_pad(w, 0, NW2 - self.NW)
                                 for w in self._window)
        self._free.extend(range(NW2 - 1, self.NW - 1, -1))
        self.NW = NW2
        self.window_grows += 1

    def _grow_frontier(self):
        F2 = min(self.frontier_cap, _bucket(self.F * 2, DEFAULT_N_FLOOR))
        if F2 <= self.F:
            return False
        lin, st, live, open_w = self._committed
        self._committed = (_pad(lin, 0, F2 - self.F),
                           _pad(st, 0, F2 - self.F),
                           _pad(live, 0, F2 - self.F), open_w)
        self.F = F2
        self.frontier_grows += 1
        return True

    def _ensure_committed(self):
        if self._committed is not None:
            return
        e, init = self.enc.materialize()
        init = np.asarray(init, np.int32)
        if int(init.shape[0]) != self.S:
            raise _Degrade("init-state-width-mismatch")
        self.F = min(self.frontier_cap, streamlin.FRONTIER_FLOOR)
        B = self.NW // 32
        self._committed = tuple(
            streamlin._tensor(a, self.device) for a in
            streamlin.fresh_frontier(self.F, B, self.S, init))
        A = int(self.spec.arg_width)
        self._window = (
            torch.zeros(self.NW, dtype=torch.int32, device=self.device),
            torch.zeros((self.NW, A), dtype=torch.int32,
                        device=self.device),
            torch.zeros((self.NW, A), dtype=torch.int32,
                        device=self.device))

    def _upload(self, dirty):
        slots = torch.as_tensor(np.fromiter(dirty.keys(), np.int64,
                                            len(dirty)),
                                device=self.device)
        rows = list(dirty.values())
        vals = [np.asarray([r.f for r in rows], np.int32),
                np.asarray([r.args for r in rows], np.int32),
                np.asarray([r.ret for r in rows], np.int32)]
        self._window = tuple(
            w.index_put((slots,), torch.as_tensor(v, device=self.device))
            for w, v in zip(self._window, vals))

    # -- the chunk check ------------------------------------------------

    def check(self, cancel=None):
        """One chunk re-check over everything consumed so far. Returns
        an engine result dict ({"valid": ...}) with the flat engines'
        verdict names; the device work is O(window), independent of
        the prefix length."""
        self.checks += 1
        if self.fallback is not None:
            return self._flat_check(cancel)
        try:
            return self._stream_check(cancel)
        except _Degrade as d:
            self._degrade(d.reason)
            return self._flat_check(cancel)

    def _flat_check(self, cancel, once=False):
        """The designed fall-back: flat re-search over the materialized
        prefix with the confirm engine. Never flips a verdict -- this
        IS the offline engine."""
        from . import engine as mengine
        self.flat_checks += 1
        self._inc("monitor.stream_flat_checks")
        e, init = self.enc.materialize()
        r = dict(mengine.check_prefix(self.spec, e, init,
                                      engine=self.confirm_engine,
                                      engine_opts=self.confirm_opts,
                                      cancel=cancel))
        r["stream_fallback"] = "probe-overflow" if once \
            else (self.fallback or "unknown")
        return r

    def _max_open_during(self, events):
        c = c_max = self._open_committed
        for _t, kind, _row in events:
            c += 1 if kind == 1 else -1
            c_max = max(c_max, c)
        return max(1, c_max)

    def _fold(self, events, clear_slots, cancel):
        """One fold (plus pow-2 frontier regrows on overflow while below
        the cap). Returns the raw fold result."""
        need_c = self._max_open_during(events)
        if need_c > self.C:
            self.C = min(self.NW, _bucket(need_c, streamlin.OPEN_FLOOR))
        B = self.NW // 32
        E = _bucket(len(events), streamlin.EVENT_FLOOR)
        ev_kind = np.zeros(E, np.int32)
        ev_slot = np.zeros(E, np.int32)
        for k, (_t, kind, row) in enumerate(events):
            ev_kind[k] = kind
            ev_slot[k] = self._slot_by_row[id(row)]
        clear_w = np.zeros(B, np.uint32)
        for s in clear_slots or ():
            clear_w[s // 32] |= np.uint32(1) << np.uint32(s % 32)
        while True:
            if cancel is not None and cancel.is_set():
                raise _Degrade("cancelled")
            lin, st, live, open_w = self._committed
            w_f, w_args, w_ret = self._window
            job = streamlin.FoldJob(self.spec, self.C, {
                "lin": lin, "st": st, "live": live, "open_w": open_w,
                "ev_kind": ev_kind, "ev_slot": ev_slot, "w_f": w_f,
                "w_args": w_args, "w_ret": w_ret, "clear_w": clear_w},
                len(events), self.device)
            r = self._dispatch(job)
            self.fold_passes += r["passes"]
            self.fold_cells += r["steps"]
            self.device_s += float(r.get("device_s") or 0.0)
            if r["status"] == 2 and self.F < self.frontier_cap \
                    and self._grow_frontier():
                continue
            return r

    def _dispatch(self, job):
        """Coalesced when the service's coalescer is live, solo
        otherwise. A deadline "unknown" and a stopped coalescer both
        fold solo (per-stream isolation, never a verdict change); an
        error of the batch itself is re-raised by ``wait``."""
        if self.coalesce:
            from ..fleet import service as fsvc
            co = fsvc.coalescer()
            if co is not None:
                try:
                    item = co.submit(
                        streamlin.fold_lane_spec(self.spec), job, None,
                        deadline=time.monotonic() + FOLD_DEADLINE_S,
                        owner=self.owner)
                except fsvc.CoalescerStopped:
                    item = None
                got = co.wait(item) if item is not None else None
                if isinstance(got, dict) and "status" in got:
                    self.coalesced_folds += 1
                    self.batch_peak = max(self.batch_peak,
                                          int(got.get("batch") or 1))
                    return got
        self.solo_folds += 1
        return streamlin.solo_fold(job)

    def _stream_check(self, cancel):
        t0 = time.monotonic()
        d0 = self.device_s
        self._ensure_committed()
        if not self._planned:
            self.so.plan("streamlin", self.F, len(self.enc), self.NW,
                         owners=1)
            self._planned = True
        open_rows = [r for r in self.enc._open.values() if not r.dead]
        horizon = min((r.invoke_idx for r in open_rows), default=None)
        pend = sorted(self._pending, key=lambda ev: (ev[0], ev[1]))
        if horizon is None:
            seal_ev, probe_ev = pend, []
        else:
            seal_ev = [ev for ev in pend if ev[0] < horizon]
            probe_ev = [ev for ev in pend if ev[0] >= horizon]
        if self._dirty:
            dirty, self._dirty = self._dirty, {}
            self._upload(dirty)
        cells0 = self.fold_cells
        if seal_ev:
            sealed_slots = [self._slot_by_row[id(row)]
                            for (_t, kind, row) in seal_ev if kind == 2]
            r = self._fold(seal_ev, sealed_slots, cancel)
            if r["status"] == 1:
                return self._confirm(r, cancel)
            if r["status"] == 2:
                # a seal that cannot fit even at the cap can never
                # commit -- the carry is gone for good on this stream
                raise _Degrade("frontier-overflow")
            self._committed = (r["lin"], r["st"], r["live"],
                               r["open_w"])
            self.seal_folds += 1
            self._inc("monitor.seal_folds")
            self.frontier_size = r["n_live"]
            self.frontier_peak = max(self.frontier_peak, r["n_live"])
            for _t, kind, row in seal_ev:
                if kind == 1:
                    self._open_committed += 1
                else:
                    self._open_committed -= 1
                    # fully sealed: recycle the slot (its frontier
                    # bits were cleared by this fold's clear_w)
                    slot = self._slot_by_row.pop(id(row), None)
                    if slot is not None:
                        self._row_by_slot.pop(slot, None)
                        self._free.append(slot)
                        self.sealed_rows += 1
        self._pending = probe_ev
        if probe_ev:
            r = self._fold(probe_ev, None, cancel)
            self.probe_folds += 1
            self._inc("monitor.probe_folds")
            if r["status"] == 1:
                return self._confirm(r, cancel)
            if r["status"] == 2:
                # transient: the open window alone blew the cap; check
                # this one chunk flat and keep the carry for the next
                self.probe_overflows += 1
                self._inc("monitor.stream_probe_overflows")
                return self._flat_check(cancel, once=True)
            self.frontier_size = max(1, r["n_live"])
            self.frontier_peak = max(self.frontier_peak,
                                     self.frontier_size)
        cells = self.fold_cells - cells0
        self._inc("monitor.fold_cells", cells)
        if self._reg is not None:
            self._reg.set_gauge("monitor.frontier_size",
                                int(self.frontier_size))
            self._reg.max_gauge("monitor.frontier_peak",
                                int(self.frontier_peak))
        self.so.heartbeat("streamlin", iteration=self.checks,
                          chunk_s=time.monotonic() - t0,
                          device_s=self.device_s - d0,
                          frontier=int(self.frontier_size),
                          explored=int(self.fold_cells))
        return {"valid": True, "engine": "streamlin",
                "configs_explored": cells,
                "frontier": int(self.frontier_size)}

    def _confirm(self, r, cancel):
        """A frontier violation is a SUSPICION: the flat engine
        re-checks the materialized prefix and owns the verdict of
        record plus the witness."""
        from . import engine as mengine
        e, init = self.enc.materialize()
        rr = dict(mengine.check_prefix(
            self.spec, e, init, engine=self.confirm_engine,
            engine_opts=self.confirm_opts, cancel=cancel))
        rr["detected_by"] = "streamlin"
        rr["suspect_slot"] = int(r.get("viol_slot", -1))
        if rr.get("valid") is not False:
            self.confirm_mismatches += 1
            self._inc("monitor.stream_confirm_mismatches")
        return rr

    # -- reporting ------------------------------------------------------

    def stream_summary(self):
        """The per-stream counters: the O(window) claim is observable,
        not asserted in wall clock."""
        out = {
            "frontier_size": int(self.frontier_size),
            "frontier_peak": int(self.frontier_peak),
            "frontier_cap": int(self.F or 0),
            "window": int(self.NW),
            "open_slots": len(self._slot_by_row),
            "checks": self.checks,
            "seal_folds": self.seal_folds,
            "probe_folds": self.probe_folds,
            "fold_passes": self.fold_passes,
            "fold_cells": self.fold_cells,
            "frontier_grows": self.frontier_grows,
            "window_grows": self.window_grows,
            "flat_checks": self.flat_checks,
            "probe_overflows": self.probe_overflows,
            "confirm_mismatches": self.confirm_mismatches,
            "coalesced_folds": self.coalesced_folds,
            "solo_folds": self.solo_folds,
            "batch_peak": self.batch_peak,
            "sealed_rows": self.sealed_rows,
            "device_s": self.device_s,
        }
        if self.fallback is not None:
            out["fallback"] = self.fallback
        return out
