"""Operations and histories.

A *history* is an ordered sequence of operation events. Each logical operation
appears as an ``invoke`` event followed (possibly much later) by a completion
event of type ``ok``, ``fail``, or ``info``:

- ``ok``   -- the operation definitely happened.
- ``fail`` -- the operation definitely did not happen.
- ``info`` -- indeterminate: it may or may not have taken effect, at any time
  after its invocation (e.g. a timed-out network call).

This module reproduces the op/history surface jepsen borrows from knossos
(reference: jepsen/src/jepsen/core.clj:227-228 `history/index`,
jepsen/src/jepsen/checker.clj:157-163 `op/ok?` etc.,
jepsen/src/jepsen/checker/timeline.clj:7 `history/pairs`), plus the dense
tensor encoding the device checker consumes. (A copy of
``jepsen_tpu.history``: the port imports nothing of the JAX package.)

Ops are dict-subclasses so "tests are data" carries over from the reference:
checkers, generators and clients all traffic in plain mappings.
"""

from __future__ import annotations

import numpy as np

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

#: Sentinel for "no / unknown value" in tensor encodings (int32 min).
NIL = -(2**31)

#: Sentinel "return time" for operations that never return (info ops).
INF_TIME = np.iinfo(np.int64).max


class HistoryError(ValueError):
    """A structurally malformed history: the checkers' preconditions do
    not hold, so any verdict computed from it would be meaningless.
    Carries the offending ``process`` and event ``index`` when known;
    ``analysis.histlint`` reports the same defects as diagnostics
    without raising."""

    def __init__(self, message, process=None, index=None):
        super().__init__(message)
        self.process = process
        self.index = index


class Op(dict):
    """An operation event: a dict with attribute access.

    Standard keys: ``type`` (invoke/ok/fail/info), ``process`` (int or
    'nemesis'), ``f`` (operation function, e.g. 'read'), ``value``,
    ``time`` (nanoseconds, relative), ``index`` (position in history).
    """

    __slots__ = ()

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def copy(self):
        return Op(self)

    def assoc(self, **kw):
        o = Op(self)
        o.update(kw)
        return o


def op(type=INVOKE, process=0, f=None, value=None, **kw) -> Op:  # noqa: A002,E501 - mirrors the reference op keys
    """Construct an op event."""
    o = Op(type=type, process=process, f=f, value=value)
    o.update(kw)
    return o


def invoke_op(process, f, value=None, **kw):
    return op(INVOKE, process, f, value, **kw)


def ok_op(process, f, value=None, **kw):
    return op(OK, process, f, value, **kw)


def fail_op(process, f, value=None, **kw):
    return op(FAIL, process, f, value, **kw)


def info_op(process, f, value=None, **kw):
    return op(INFO, process, f, value, **kw)


# -- predicates (knossos.op surface) ----------------------------------------

def invoke(o) -> bool:
    return o["type"] == INVOKE


def ok(o) -> bool:
    return o["type"] == OK


def fail(o) -> bool:
    return o["type"] == FAIL


def info(o) -> bool:
    return o["type"] == INFO


# Aliases matching knossos.op/{invoke? ok? fail? info?}
invoke_ = invoke
ok_ = ok
fail_ = fail
info_ = info


# -- history utilities (knossos.history surface) ----------------------------

class History(list):
    """An indexed event list that memoizes derived passes.

    ``checker.core.check`` used to re-walk the full history per
    analyzer run: every subchecker fanned out by Compose re-ran
    ``ensure_indexed`` (an O(n) rebuild per subchecker). Returning a
    History makes that idempotent — the same object flows to every
    subchecker, histlint, and the search planner. The ``pairs`` memo
    additionally lets passes that receive the SAME History share one
    pairing walk — the search planner's per-part segmentation sweep
    and config estimates do (build_plan History-wraps each part);
    call sites that derive fresh lists (client_ops, complete) still
    pay their own walk. Caches are only attached to History instances
    (created at check time, after which the history no longer
    mutates); plain lists behave as before."""

    __slots__ = ("_pairs",)

    def __init__(self, *args):
        super().__init__(*args)
        self._pairs = None


def index(history):
    """Assign each event a monotone ``index`` (knossos.history/index;
    called from reference core.clj:227-228 before checking). Returns a new
    History of Ops; existing indices are overwritten."""
    out = History()
    for i, o in enumerate(history):
        o = Op(o)
        o["index"] = i
        out.append(o)
    return out


def ensure_indexed(history):
    """Index the history unless every event already carries an index.
    Idempotent: an already-indexed History returns unchanged (with its
    memoized passes intact).

    Raises HistoryError (naming the offending position) on events that
    are not mappings -- Op(non-dict) used to fail later with an opaque
    ValueError from dict()."""
    if isinstance(history, History):
        return history
    for i, o in enumerate(history):
        if not isinstance(o, dict):
            raise HistoryError(
                f"history event #{i} is not a mapping: {o!r}", index=i)
    if all("index" in o for o in history):
        return History(o if isinstance(o, Op) else Op(o)
                       for o in history)
    return index(history)


def pairs(history):
    """Yield (invocation, completion) pairs. Invocations without a completion
    yield (invocation, None); completion may be ok/fail/info.
    (knossos.history/pairs equivalent, used by timeline.clj:7.)

    Events pair by process: a completion matches the most recent open
    invocation on the same process.

    Raises HistoryError on an invoke while the same process already has
    an open invocation: processes are logically single-threaded, and
    silently dropping the earlier invocation (the old behavior) changes
    which ops the checker sees.

    The result is memoized on History instances (ensure_indexed
    returns one): timeline, the search planner, and encoders all share
    one pairing walk per checked history. Callers must treat the
    returned list as read-only.
    """
    if isinstance(history, History) and history._pairs is not None:
        return history._pairs
    open_by_process = {}
    out = []
    order = []
    for o in history:
        t = o["type"]
        p = o["process"]
        if t == INVOKE:
            if p in open_by_process:
                prev = open_by_process[p]
                raise HistoryError(
                    f"process {p!r} invoked {o.get('f')!r} at index "
                    f"{o.get('index', '?')} while its invocation of "
                    f"{prev.get('f')!r} (index {prev.get('index', '?')})"
                    " is still open: processes are logically "
                    "single-threaded",
                    process=p, index=o.get("index"))
            open_by_process[p] = o
            order.append(p)
        elif t in (OK, FAIL, INFO):
            inv = open_by_process.pop(p, None)
            if inv is not None:
                out.append((inv, o))
                order.remove(p)
            else:
                # Completion without invocation (e.g. nemesis info): own pair.
                out.append((None, o))
    for p in order:
        out.append((open_by_process[p], None))
    if isinstance(history, History):
        history._pairs = out
    return out


def complete(history):
    """Fill in missing invocation values from completions (knossos
    history/complete): for ok pairs, the invocation's value is replaced by the
    completion's value (reads learn what they read); invocations whose
    completion failed are marked ``fails?`` so checkers can drop the whole
    pair. Info invocations keep their value. Returns a new event list."""
    history = ensure_indexed(history)
    out = [Op(o) for o in history]
    open_by_process = {}
    for i, o in enumerate(out):
        t = o["type"]
        p = o["process"]
        if t == INVOKE:
            open_by_process[p] = i
        elif t in (OK, FAIL, INFO):
            j = open_by_process.pop(p, None)
            if j is not None and t == OK:
                out[j]["value"] = o["value"]
            elif j is not None and t == FAIL:
                out[j]["fails?"] = True
    return out


def invocations(history):
    return [o for o in history if invoke(o)]


def completions(history):
    return [o for o in history if not invoke(o)]


def client_ops(history):
    """Ops performed by client processes (integer process ids)."""
    return [o for o in history if isinstance(o.get("process"), int)]


def oks(history):
    return [o for o in history if ok(o)]


def infos(history):
    return [o for o in history if info(o)]


def fails(history):
    return [o for o in history if fail(o)]


# -- dense tensor encoding ---------------------------------------------------

class EncodedHistory:
    """A history of paired operations as dense arrays, one row per operation.

    Arrays (n rows, numpy):
      invoke_idx  int64      -- event index of the invocation
      return_idx  int64      -- event index of the completion; INF_TIME for
                                operations that never complete or complete
                                with :info (indeterminate -- they stay
                                concurrent with everything after them)
      f           int32      -- model-specific op-function code
      args        int32[n,A] -- encoded argument vector; NIL where absent
      ret         int32[n,A] -- encoded result vector; NIL where unknown
      is_ok       bool       -- completion was :ok (must be linearized)
      process     int64      -- logical process id

    Failed operations (type fail -- definitely did not happen) are excluded
    at encoding time, matching knossos semantics.
    """

    def __init__(self, invoke_idx, return_idx, f, args, ret, is_ok,
                 process, ops=None):
        self.invoke_idx = np.asarray(invoke_idx, np.int64)
        self.return_idx = np.asarray(return_idx, np.int64)
        self.f = np.asarray(f, np.int32)
        self.args = np.asarray(args, np.int32)
        self.ret = np.asarray(ret, np.int32)
        self.is_ok = np.asarray(is_ok, bool)
        self.process = np.asarray(process, np.int64)
        #: original (invocation, completion) pairs, for witness decoding
        self.ops = ops

    def __len__(self):
        return len(self.invoke_idx)

    @property
    def n_ok(self):
        return int(self.is_ok.sum())

    def sorted_by_invoke(self):
        """Return a copy with rows sorted by invocation index (the order the
        checker requires)."""
        order = np.argsort(self.invoke_idx, kind="stable")
        return EncodedHistory(
            self.invoke_idx[order], self.return_idx[order], self.f[order],
            self.args[order], self.ret[order],
            self.is_ok[order], self.process[order],
            ops=[self.ops[i] for i in order] if self.ops is not None else None)


def encode_history(history, encode_op, arg_width) -> EncodedHistory:
    """Encode an event history into an EncodedHistory.

    ``encode_op(f, value, completion_value) -> (fcode, args_list, ret_list)``
    is the model-specific encoder (see models/*.ModelSpec.encode_op);
    args/ret lists are padded with NIL to ``arg_width``. Completion value is
    None for info ops whose outcome is unknown.

    Rules (knossos semantics):
      * fail ops are dropped (they didn't happen);
      * info ops get return_idx = INF_TIME and an unknown result;
      * invocations with no completion at all are treated as info.
    """
    def pad(xs):
        xs = list(xs)[:arg_width]
        return xs + [NIL] * (arg_width - len(xs))

    history = ensure_indexed(history)
    rows = []
    for inv, comp in pairs(history):
        if inv is None:
            continue  # nemesis-style bare completion; not a client op
        if comp is not None and comp["type"] == FAIL:
            continue
        if comp is not None and comp["type"] == OK:
            fcode, args, ret = encode_op(inv["f"], inv.get("value"),
                                         comp.get("value"))
            rows.append((inv["index"], comp["index"], fcode, pad(args),
                         pad(ret), True, inv["process"], (inv, comp)))
        else:
            # info or missing completion: indeterminate
            fcode, args, ret = encode_op(inv["f"], inv.get("value"), None)
            rows.append((inv["index"], INF_TIME, fcode, pad(args), pad(ret),
                         False, inv["process"], (inv, comp)))
    if not rows:
        z = np.zeros(0)
        za = np.zeros((0, arg_width))
        return EncodedHistory(z, z, z, za, za, np.zeros(0, bool), z, ops=[])
    cols = list(zip(*rows))
    return EncodedHistory(cols[0], cols[1], cols[2], cols[3], cols[4],
                          cols[5], cols[6],
                          ops=list(cols[7])).sorted_by_invoke()


def parse_history_edn_like(rows):
    """Build a history from compact tuples ``(type, process, f, value)`` --
    convenience for tests and golden histories."""
    return index([op(t, p, f, v) for (t, p, f, v) in rows])
