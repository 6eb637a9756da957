"""knossos-parity failure witnesses for the linearizability engines.

knossos.wgl/analysis returns, for an invalid history, ``{:valid? false,
:op, :previous-ok, :configs, :final-paths}`` — a step-by-step path of
``{:op, :model}`` entries to the deepest configuration, the last ok op on
it, and the stuck configurations with their pending candidates. Jepsen
truncates and persists these (reference checker.clj:206-216). The device
engine tracks only the deepest configuration's (linearized-bitset, model
state), so this module reconstructs the rest on host:

* ``final_path`` replays the linearized SET into a legal WGL ORDER
  (depth-first over set members under the real eligibility rule, guided
  by the model's linearization-priority hint) and records the model
  state after every step.
* ``attach`` shapes the knossos-style fields onto a result dict:
  ``final_paths`` (list of paths of ``{"op", "model"}``),
  ``previous_ok`` (last ok op on the first path), and ``configs``
  (``{"model", "last_op", "pending"}`` for the stuck configuration,
  pending = ok/info ops that were WGL-eligible when the search wedged).

Both engines (the sequential oracle and the device search) share this
code, so their failure artifacts are interchangeable. A copy of
``jepsen_tpu.checker.witness``: witnesses of the port and of the JAX
package share schema ``WITNESS_SCHEMA``.
"""

from __future__ import annotations

import numpy as np

from ..history import INF_TIME
from ..xp import NP

#: keep at most this many trailing steps per reported path (a 10k-op
#: history's full path would dominate results.json; the tail is where
#: the search got stuck, which is the part a human reads)
PATH_TAIL = 100

#: step-attempt budget for the replay DFS; the linearized set came from
#: a real search path so the hint-guided replay almost never backtracks,
#: but an adversarial set could force exponential work
REPLAY_BUDGET = 500_000

#: version tag of the NORMALIZED witness dict (``result["witness"]``)
#: every engine emits -- the one schema the verdict certifier
#: (analysis/certify.py) replays. Bump on any field change; the
#: certifier rejects unknown schemas as malformed (VC005).
WITNESS_SCHEMA = 1


class _RetMin:
    """Segment tree over return indices: global min with O(log n)
    activate/deactivate, for the WGL eligibility rule under DFS
    backtracking."""

    def __init__(self, rets):
        n = max(1, len(rets))
        size = 1
        while size < n:
            size *= 2
        self.size = size
        self.t = np.full(2 * size, INF_TIME, np.int64)
        self.t[size:size + len(rets)] = rets
        for i in range(size - 1, 0, -1):
            self.t[i] = min(self.t[2 * i], self.t[2 * i + 1])
        self.rets = np.asarray(rets, np.int64)

    def set_active(self, i, active):
        j = self.size + i
        self.t[j] = self.rets[i] if active else INF_TIME
        j //= 2
        while j:
            self.t[j] = min(self.t[2 * j], self.t[2 * j + 1])
            j //= 2

    def min(self):
        return self.t[1]


def final_path(spec, e, linearized, init_state, budget=REPLAY_BUDGET):
    """Order the linearized op set into a legal WGL step sequence.

    ``linearized``: bool[n] over ``e``'s rows. Returns a list of
    ``(row_index, state_after)`` or None if the replay budget runs out
    (the witness then stays set-only)."""
    n = len(e)
    member = np.asarray(linearized, bool)
    total = int(member.sum())
    if total == 0:
        return []
    invoke = np.asarray(e.invoke_idx, np.int64)
    rets = np.asarray(e.return_idx, np.int64)
    f = np.asarray(e.f)
    args = np.asarray(e.args).reshape(n, -1)
    rvals = np.asarray(e.ret).reshape(n, -1)

    # candidate order: the model's search hint (same priority the engine
    # used), so the replay follows the search's own footsteps
    if spec.hint is not None:
        from .torch_wgl import _encode_arrays
        inv32, ret32, _ = _encode_arrays(e)
        pri = np.asarray(spec.hint(e, inv32, ret32), np.int64)
    else:
        pri = rets
    members = sorted(np.flatnonzero(member).tolist(),
                     key=lambda i: (pri[i], i))

    tree = _RetMin(rets)

    # doubly-linked list over member positions so each DFS level only
    # scans still-undone members (a flat rescan is quadratic in path
    # length); position `total` is the sentinel head/tail
    head = total
    nxt = list(range(1, total + 1)) + [0]      # nxt[head] = 0
    prv = [head] + list(range(total))          # prv[head] = total - 1

    def remove(j):
        nxt[prv[j]] = nxt[j]
        prv[nxt[j]] = prv[j]

    def restore(j):
        nxt[prv[j]] = j
        prv[nxt[j]] = j

    path = []                 # (row, state_after)
    states = [np.asarray(init_state, np.int32)]
    scan = [nxt[head]]        # per-level next list position to try
    work = budget
    while True:
        if len(path) == total:
            return path
        j = scan[-1]
        state = states[-1]
        taken = False
        while j != head:
            work -= 1
            if work < 0:
                return None
            i = members[j]
            if invoke[i] < tree.min():
                st2, ok = spec.step(state, f[i], args[i], rvals[i], NP)
                if bool(ok):
                    st2 = np.asarray(st2, np.int32)
                    tree.set_active(i, False)
                    remove(j)
                    path.append((i, st2))
                    states.append(st2)
                    scan[-1] = j          # resume point on backtrack
                    scan.append(nxt[head])
                    taken = True
                    break
            j = nxt[j]
        if not taken:
            scan.pop()
            states.pop()
            if not path:
                return None
            i, _ = path.pop()
            jprev = scan[-1]
            restore(jprev)
            tree.set_active(i, True)
            scan[-1] = nxt[jprev]


def _decode_op(e, i):
    if e.ops is not None and i < len(e.ops):
        inv, comp = e.ops[i]
        return dict(comp if comp is not None else inv)
    return {"row": int(i)}


def _decode_state(spec, state):
    state = np.asarray(state)
    if spec.decode_state is not None:
        try:
            return spec.decode_state(state)
        except Exception:  # noqa: BLE001 - padding etc: fall through
            pass
    return state.tolist()


def config_entry(spec, e, linearized, state, last_op=None):
    """One knossos-style stuck-config map: the model state plus the ops
    still open under the WGL rule at this configuration (invoked before
    every unlinearized return)."""
    rets = np.asarray(e.return_idx, np.int64)
    invoke = np.asarray(e.invoke_idx, np.int64)
    un = ~np.asarray(linearized, bool)
    rmin = rets[un].min() if un.any() else INF_TIME
    pending = np.flatnonzero(un & (invoke < rmin))
    return {"model": _decode_state(spec, state),
            "last_op": last_op,
            "pending": [_decode_op(e, int(i)) for i in pending[:16]]}


def _witness_dict(spec, e, engine, valid, linearized, path,
                  fallback_state):
    """The normalized witness dict (schema ``WITNESS_SCHEMA``) built
    from an already-computed replay ``path`` (or None when the replay
    budget ran out). This is the ONE shape all engines emit -- the
    device single-key search, the keyshard batch, the mesh-sharded
    search, and the CPU engines -- so one certifier reads all of
    them. Fields:

      schema: WITNESS_SCHEMA
      engine: the producing engine's name (None when the caller sets
        none, e.g. the bare CPU oracle before competition labels it)
      verdict: the verdict this witness supports -- True: ``order`` is
        a claimed legal linearization covering every ok op; False: the
        deepest stuck configuration the search reached
      rows / n_ok: the encoded-history shape the row indices refer to
      linearized_rows: sorted encoded-row indices in the configuration
      order: those rows as a legal WGL step sequence, or None when the
        replay budget ran out (the set is then unordered)
      final_state: decoded model state after the last ordered step
      segment: searchplan provenance {"index", "count", "seed"} filled
        in by the planned batch path, else None
    """
    linearized = np.asarray(linearized, bool)
    state = path[-1][1] if path else fallback_state
    return {"schema": WITNESS_SCHEMA,
            "engine": engine,
            "verdict": bool(valid),
            "rows": int(len(e)),
            "n_ok": int(e.n_ok),
            "linearized_rows": [int(i)
                                for i in np.flatnonzero(linearized)],
            "order": ([int(i) for i, _ in path]
                      if path is not None else None),
            "final_state": _decode_state(spec, state),
            "segment": None}


def build(spec, e, engine, valid, linearized, init_state,
          budget=REPLAY_BUDGET):
    """Build a normalized witness for ``linearized`` from scratch:
    replay the set into a legal order (final_path) and shape the
    schema-``WITNESS_SCHEMA`` dict. Used by the engines' VALID paths,
    where no knossos-style attach ran to compute the path already."""
    linearized = np.asarray(linearized, bool)
    path = final_path(spec, e, linearized, init_state, budget=budget)
    return _witness_dict(spec, e, engine, valid, linearized, path,
                         np.asarray(init_state, np.int32))


def attach(result, spec, e, linearized, best_state, init_state):
    """Shape knossos-style witness fields onto ``result`` (mutates and
    returns it). ``linearized``: bool[n] of the deepest configuration."""
    linearized = np.asarray(linearized, bool)
    is_ok = np.asarray(e.is_ok, bool)
    stuck = np.flatnonzero(is_ok & ~linearized)
    if len(stuck):
        result["op"] = _decode_op(e, int(stuck[0]))
    result["final_state"] = _decode_state(spec, best_state)
    result["linearized_ok_ops"] = int((linearized & is_ok).sum())

    path = final_path(spec, e, linearized, init_state)
    # the machine-checkable counterpart of the knossos fields below:
    # one normalized dict the certifier replays, same path, no extra
    # search work
    result["witness"] = _witness_dict(
        spec, e, result.get("engine"), result.get("valid", False),
        linearized, path, np.asarray(best_state, np.int32))
    if path is not None:
        tail = path[-PATH_TAIL:]
        steps = [{"op": _decode_op(e, i),
                  "model": _decode_state(spec, st)} for i, st in tail]
        result["final_paths"] = [steps]
        if len(path) > len(tail):
            result["final_paths_truncated_steps"] = len(path) - len(tail)
        result["previous_ok"] = next(
            (_decode_op(e, i) for i, _ in reversed(path) if e.is_ok[i]),
            None)

    result["configs"] = [config_entry(
        spec, e, linearized, best_state,
        last_op=_decode_op(e, path[-1][0]) if path else None)]
    return result


def attach_multi(result, spec, e, slots, init_state):
    """Multi-config variant of ``attach``: ``slots`` is a list of
    (linearized bool[n], state) deepest-first. The primary witness
    fields (op / final_paths / previous_ok) decode from slot 0; EVERY
    slot contributes a stuck-config entry with its own pending set
    (knossos returns up to 10 :configs, reference checker.clj:213-216;
    round 3 only ever produced one)."""
    if not slots:
        return result
    linearized, state = slots[0]
    attach(result, spec, e, linearized, state, init_state)
    result["configs"] = result["configs"] + [
        config_entry(spec, e, lin_s, st_s) for lin_s, st_s in slots[1:]]
    return result
