"""histlint: well-formedness analysis over histories and EncodedHistory
tensors (a copy of ``jepsen_tpu/analysis/histlint.py``; host-only).

The linearizability literature this repo reproduces (P-compositionality,
WGL) *assumes* well-formed histories: every completion pairs with an
open invocation on the same process, processes are logically
single-threaded, indices are monotone. A history violating those
preconditions doesn't crash the checker -- it silently corrupts the
verdict (an overlapping invoke drops its predecessor in
``history.pairs``; a non-monotone index breaks the WGL precedence
relation). This analyzer verifies the preconditions statically, before
the expensive search.

Codes (all asserted on by tests -- keep stable):

  HL001 warning  dangling invoke (no completion; legal -- treated as
                 info by the encoder -- but worth surfacing)
  HL002 error    overlapping invocations on one process (a "logically
                 single-threaded" process invoked twice)
  HL003 error    completion without an open invocation on a client
                 process (nemesis-style bare info events are legal)
  HL004 error    unknown event type
  HL005 error    non-monotonic or duplicate :index
  HL006 error    op :f outside the model's supported op set
  HL007 error    event missing a required field (type/process)
  HL010 error    EncodedHistory row returns before it invokes
  HL011 error    EncodedHistory rows not sorted by invocation index
  HL012 error    EncodedHistory ok row with an infinite return index
"""

from __future__ import annotations

import numpy as np

from .. import history as h
from .diagnostics import ERROR, WARNING, diag

__all__ = ["lint_history", "lint_encoded", "lint_test_history",
           "model_op_set"]

_CLIENT_EVENT_TYPES = (h.INVOKE, h.OK, h.FAIL, h.INFO)


def _loc(i, o):
    idx = o.get("index", i) if isinstance(o, dict) else i
    return f"history[{idx}]"


def lint_history(history, model_fs=None):
    """Lint an event history (list of op dicts). ``model_fs`` is the
    model's supported op-:f set (or None to skip HL006); nemesis and
    special interpreter ops are exempt from HL006."""
    diags = []
    open_by_process = {}     # process -> (position, op)
    last_index = None
    for i, o in enumerate(history):
        if not isinstance(o, dict):
            diags.append(diag(
                "HL007", ERROR,
                f"event #{i} is not a mapping: {o!r}",
                f"history[{i}]",
                "histories are sequences of op dicts (see history.op)"))
            continue
        t = o.get("type")
        p = o.get("process")
        if t is None or p is None:
            missing = [k for k in ("type", "process")
                       if o.get(k) is None]
            diags.append(diag(
                "HL007", ERROR,
                f"event missing required field(s) {missing}: {_brief(o)}",
                _loc(i, o),
                "every event needs :type and :process"))
            continue
        if t not in _CLIENT_EVENT_TYPES:
            diags.append(diag(
                "HL004", ERROR,
                f"unknown event type {t!r} (process {p!r})",
                _loc(i, o),
                "valid types: invoke, ok, fail, info"))
            continue
        idx = o.get("index")
        if idx is not None:
            if last_index is not None and idx <= last_index:
                diags.append(diag(
                    "HL005", ERROR,
                    f"non-monotonic :index {idx} after {last_index} "
                    f"(process {p!r})",
                    _loc(i, o),
                    "re-index with history.index before checking"))
            last_index = idx

        # op-type transition legality, per logically-single-threaded
        # process. Only integer processes are clients; the nemesis emits
        # bare :info events that never pair (history.pairs handles them).
        is_client = isinstance(p, (int, np.integer)) \
            and not isinstance(p, bool)
        if t == h.INVOKE:
            if p in open_by_process:
                j, prev = open_by_process[p]
                diags.append(diag(
                    "HL002", ERROR,
                    f"process {p!r} invoked {o.get('f')!r} while its "
                    f"invocation of {prev.get('f')!r} "
                    f"(at {_loc(j, prev)}) is still open",
                    _loc(i, o),
                    "a process is logically single-threaded: complete "
                    "each op before invoking the next"))
            open_by_process[p] = (i, o)
        else:  # completion
            inv = open_by_process.pop(p, None)
            if inv is None and is_client:
                diags.append(diag(
                    "HL003", ERROR,
                    f"{t} completion of {o.get('f')!r} on client process "
                    f"{p!r} without an open invocation",
                    _loc(i, o),
                    "completions must follow an invoke on the same "
                    "process"))
            elif inv is not None and inv[1].get("f") != o.get("f"):
                diags.append(diag(
                    "HL003", ERROR,
                    f"completion :f {o.get('f')!r} does not match the "
                    f"open invocation's :f {inv[1].get('f')!r} "
                    f"(process {p!r})",
                    _loc(i, o),
                    "invoke/complete pairs must share :f"))

        # invokes only: flagging the matching completion too would
        # double-count every bad op
        if model_fs is not None and is_client and t == h.INVOKE \
                and o.get("f") not in model_fs:
            diags.append(diag(
                "HL006", ERROR,
                f"op :f {o.get('f')!r} is not in the model's op set "
                f"{sorted(map(str, model_fs))}",
                _loc(i, o),
                "the model cannot step this op; fix the generator or "
                "pick a model that supports it"))

    for p, (i, o) in sorted(open_by_process.items(), key=lambda kv: kv[1][0]):
        diags.append(diag(
            "HL001", WARNING,
            f"dangling invoke of {o.get('f')!r} on process {p!r} "
            "(no completion; the encoder treats it as indeterminate)",
            _loc(i, o),
            "expected at test cutoff; elsewhere it usually means a lost "
            "completion"))
    return diags


def _brief(o):
    s = repr(dict(o))
    return s if len(s) <= 120 else s[:117] + "..."


def lint_encoded(e):
    """Lint an EncodedHistory's tensor invariants (the device search's
    preconditions)."""
    diags = []
    n = len(e)
    if n == 0:
        return diags
    inv = np.asarray(e.invoke_idx, np.int64)
    ret = np.asarray(e.return_idx, np.int64)
    ok = np.asarray(e.is_ok, bool)
    bad = np.flatnonzero(ret <= inv)
    for i in bad[:8]:
        diags.append(diag(
            "HL010", ERROR,
            f"row {int(i)} returns at {int(ret[i])} <= its invocation "
            f"at {int(inv[i])}",
            f"encoded[{int(i)}]",
            "invoke/return event indices must be strictly ordered"))
    if np.any(inv[1:] < inv[:-1]):
        i = int(np.flatnonzero(inv[1:] < inv[:-1])[0]) + 1
        diags.append(diag(
            "HL011", ERROR,
            f"rows are not sorted by invocation index (row {i} invokes "
            f"at {int(inv[i])} after row {i - 1}'s {int(inv[i - 1])})",
            f"encoded[{i}]",
            "use EncodedHistory.sorted_by_invoke()"))
    bad_ok = np.flatnonzero(ok & (ret >= h.INF_TIME))
    for i in bad_ok[:8]:
        diags.append(diag(
            "HL012", ERROR,
            f"row {int(i)} is :ok but never returns (return_idx is "
            "infinite)",
            f"encoded[{int(i)}]",
            "ok ops must carry their completion's event index"))
    return diags


# ---------------------------------------------------------------------------
# test-map plumbing

#: interpreter ops that never reach the model
_SPECIAL_FS = {None}


def model_op_set(test):
    """Best-effort union of supported op :f values across the model specs
    reachable from the test's checker (and an explicit test["model"]).
    Returns None when no spec is discoverable -- HL006 is then skipped."""
    fs = set()
    found = [False]

    def visit(c, depth=0):
        if c is None or depth > 6:
            return
        spec = getattr(c, "spec", None)
        f_codes = getattr(spec, "f_codes", None)
        if isinstance(f_codes, dict):
            fs.update(f_codes)
            found[0] = True
        cmap = getattr(c, "checker_map", None)
        if isinstance(cmap, dict):
            for sub in cmap.values():
                visit(sub, depth + 1)
        for attr in ("checker", "inner"):
            visit(getattr(c, attr, None), depth + 1)

    if isinstance(test, dict):
        visit(test.get("checker"))
        model = test.get("model")
        f_codes = getattr(model, "f_codes", None)
        if isinstance(f_codes, dict):
            fs.update(f_codes)
            found[0] = True
    return fs if found[0] else None


def lint_test_history(test, history):
    """The checker.core/core.run entry point: lint ``history`` in the
    context of ``test`` (model op set, independent-key unwrapping)."""
    fs = model_op_set(test)
    if fs is not None:
        # independent.tuple_gen wraps values as [k, v]; the op :f set is
        # unchanged, so HL006 still applies. Nothing to unwrap here.
        fs = set(fs) | _SPECIAL_FS
    return lint_history(history or [], model_fs=fs)
