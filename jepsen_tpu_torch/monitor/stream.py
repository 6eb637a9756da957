"""Incremental EncodedHistory construction over a live op stream (the
port's copy of ``jepsen_tpu.monitor.stream``).

``history.encode_history`` walks a finished history: it pairs invokes
with completions, drops fails, and encodes one dense row per logical
op. The monitor can't wait for "finished" -- ops arrive one event at a
time -- so `StreamEncoder` maintains the same row set incrementally:

* an ``invoke`` appends an *open* row (return ``INF_TIME``, result
  unknown) -- precisely the info-op encoding the offline checker would
  use if the history were cut right here;
* an ``ok`` completion re-encodes its row in place with the now-known
  result and closes it;
* a ``fail`` completion marks the row dead -- filtered out at
  materialize (knossos semantics: the op definitely did not happen);
* an ``info`` completion leaves the row open forever.

``materialize()`` therefore yields an EncodedHistory whose semantics
match ``spec.encode(prefix)`` for the event prefix consumed so far:
the monitor's chunk checks and the offline checker see the same
history through the same encoding rules. Rows append in invocation
order, which is already the engines' required sort order.

Values are interned through one persistent `models.base.Interner` --
codes are assigned in first-seen order, which is the same order the
offline encoding would see, and verdicts never depend on code values.
"""

from __future__ import annotations

import numpy as np

from ..history import INF_TIME, NIL, EncodedHistory
from ..models import base as mbase

__all__ = ["StreamEncoder"]


class _Row:
    """One logical op row, mutable until its completion lands."""

    __slots__ = ("invoke_idx", "return_idx", "f", "args", "ret", "is_ok",
                 "process", "inv", "comp", "dead")

    def __init__(self, invoke_idx, f, args, ret, process, inv):
        self.invoke_idx = invoke_idx
        self.return_idx = INF_TIME
        self.f = f
        self.args = args
        self.ret = ret
        self.is_ok = False
        self.process = process
        self.inv = inv
        self.comp = None
        #: fail completions mark their row dead instead of removing it
        #: (list.remove is a linear scan -- quadratic on fail-heavy
        #: workloads); materialize() filters
        self.dead = False


class StreamEncoder:
    """Feed indexed client ops in history order; materialize the
    encoded prefix on demand.

    ``offer(op, index)`` must be called with a monotonically increasing
    history ``index`` (the monitor assigns them as ops stream in, so
    they agree with ``history.index`` at analyze time). ``init_ops``
    are prepended as already-completed pairs at negative indices --
    the same synthetic rows ``Linearizable.prepare_history`` builds.
    """

    def __init__(self, spec, init_ops=()):
        self.spec = spec
        self.interner = mbase.Interner()
        self._enc = spec.encode_op or mbase.ModelSpec.default_encode_op
        self.rows = []
        self._open = {}          # process -> open _Row
        #: history index of the newest event consumed (for detection
        #: reporting); -1 until the first op lands
        self.last_index = -1
        #: events that could not be paired/encoded (malformed stream);
        #: counted, never fatal -- histlint owns structural complaints
        self.skipped = 0
        for j, op in enumerate(init_ops or ()):
            base = -2 * (len(init_ops) - j)
            inv = {"type": "invoke", "process": -1, "f": op["f"],
                   "value": op.get("value"), "index": base}
            row = self._encode_row(base, op["f"], op.get("value"), None,
                                   -1, inv)
            row.return_idx = base + 1
            row.is_ok = True
            row.comp = {**inv, "type": "ok", "index": base + 1}
            self.rows.append(row)

    def _pad(self, xs):
        xs = list(xs)[:self.spec.arg_width]
        return xs + [NIL] * (self.spec.arg_width - len(xs))

    def _encode_row(self, invoke_idx, f, value, ret_value, process, inv):
        fcode, args, ret = self._enc(self.spec, self.interner, f, value,
                                     ret_value)
        return _Row(invoke_idx, fcode, self._pad(args), self._pad(ret),
                    process, inv)

    def offer(self, op, index):
        """Consume one history event. Returns True when the event
        completed a logical op (the monitor's chunk counter)."""
        self.last_index = index
        t = op.get("type")
        p = op.get("process")
        if t == "invoke":
            if p in self._open:
                # overlapping invoke on one process: malformed; keep
                # the old op open and skip (histlint HL002 territory)
                self.skipped += 1
                return False
            try:
                row = self._encode_row(index, op.get("f"),
                                       op.get("value"), None, p, op)
            except Exception:  # noqa: BLE001 - unknown f etc.
                self.skipped += 1
                return False
            self._open[p] = row
            self.rows.append(row)
            return False
        if t not in ("ok", "fail", "info"):
            return False
        row = self._open.pop(p, None)
        if row is None:
            # bare completion (nemesis style): not a logical client op
            self.skipped += 1
            return False
        if t == "fail":
            row.dead = True
            return True
        if t == "info":
            row.comp = op
            return True
        try:
            fresh = self._encode_row(row.invoke_idx, row.inv.get("f"),
                                     row.inv.get("value"),
                                     op.get("value"), p, row.inv)
        except Exception:  # noqa: BLE001 - leave the row open (info)
            self.skipped += 1
            row.comp = op
            return True
        row.f, row.args, row.ret = fresh.f, fresh.args, fresh.ret
        row.return_idx = index
        row.is_ok = True
        row.comp = op
        return True

    def __len__(self):
        return sum(1 for r in self.rows if not r.dead)

    def truncate_before(self, cut_invoke_idx, seed_invoke_idx=None):
        """Quiescent-cut carry (analysis/searchplan.py stream_cut):
        drop rows that invoked before ``cut_invoke_idx``, keeping the
        sealing seed row (its completed pair re-establishes the state
        the prefix linearization ended in). Only sound right after a
        prefix check returned True — the monitor enforces that. Rows
        still open (in ``_open``) always invoke at/after a valid cut,
        so the open map stays consistent. Returns the number of rows
        dropped."""
        keep = []
        dropped = 0
        for r in self.rows:
            if r.invoke_idx >= cut_invoke_idx \
                    or r.invoke_idx == seed_invoke_idx:
                keep.append(r)
            else:
                dropped += 1
        if dropped:
            self.rows = keep
        return dropped

    def materialize(self):
        """The encoded prefix: (EncodedHistory, init_state). Open rows
        appear as info ops, exactly like an offline encoding of the
        same cut; failed (dead) rows are filtered out here."""
        rows = [r for r in self.rows if not r.dead]
        A = self.spec.arg_width
        if not rows:
            z = np.zeros(0)
            za = np.zeros((0, A))
            e = EncodedHistory(z, z, z, za, za, np.zeros(0, bool), z,
                               ops=[])
        else:
            e = EncodedHistory(
                [r.invoke_idx for r in rows],
                [r.return_idx for r in rows],
                [r.f for r in rows],
                [r.args for r in rows],
                [r.ret for r in rows],
                [r.is_ok for r in rows],
                [r.process if isinstance(r.process, int) else -1
                 for r in rows],
                ops=[(r.inv, r.comp) for r in rows])
        s = self.spec.state_size(e)
        return e, np.asarray(self.spec.init_state(e, s), np.int32)
