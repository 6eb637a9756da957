"""Sequential Wing-Gong-Lowe linearizability search (CPU oracle).

This is the exact reference implementation the batched device engine
(torch_wgl.py) is differential-tested against. A copy of
``jepsen_tpu.checker.wgl`` whose model steps run on the port's numpy
face (``xp.NP``) and which tests its ``cancel`` event at every config,
not every 4,096th. It reconstructs the algorithm
knossos.wgl implements (knossos is an external dependency of the reference,
jepsen/project.clj:14, dispatched from jepsen/src/jepsen/checker.clj:199-202;
see SURVEY.md section 2.9) from its published description: depth-first search
over linearization orders with memoized (linearized-bitset, model-state)
configurations.

Given operations sorted by invocation index, with return index INF_TIME for
indeterminate (:info) ops:

* a configuration is (bitset of linearized ops, model state);
* op X may be linearized next iff X is unlinearized and
  invoke(X) < min{return(Y) : Y unlinearized} -- i.e. X is concurrent with
  or precedes every other pending op (real-time order is respected);
* the model step must accept X (not Inconsistent);
* the history is linearizable iff some reachable configuration has all
  :ok ops linearized (:info ops may linearize or silently never happen;
  :fail ops were dropped at encoding).

The search runs directly on the dense tensor encoding, using the same
branch-free model step as the device path (models.base.ModelSpec.step with
xp.NP), so the two engines share transition semantics by construction.
"""

from __future__ import annotations

import numpy as np

from ..history import INF_TIME
from ..xp import NP


def check_encoded(spec, e, init_state, max_configs=None, cancel=None):
    """Run the WGL search over an EncodedHistory ``e`` with ``init_state``.

    Returns a result dict:
      valid: True | False
      configs_explored: number of distinct configurations visited
      op / final_paths / previous_ok / configs: on failure, the
        knossos-style witness fields (see checker/witness.py).
    """
    n = len(e)
    invoke = e.invoke_idx
    ret_t = e.return_idx
    is_ok = e.is_ok
    full = (1 << n) - 1
    ok_mask = 0
    for i in range(n):
        if is_ok[i]:
            ok_mask |= 1 << i

    if ok_mask == 0:
        return {"valid": True, "configs_explored": 0}

    step = spec.step
    f = e.f
    args = e.args
    rets = e.ret

    init_key = (0, init_state.tobytes())
    seen = {init_key}
    stack = [(0, init_state)]
    explored = 0
    # Track the deepest stuck frontier for the witness: configs maximizing
    # the number of linearized ok ops.
    best_depth = -1
    best_configs = []

    while stack:
        lin, state = stack.pop()
        explored += 1
        if max_configs is not None and explored > max_configs:
            return {"valid": "unknown", "configs_explored": explored,
                    "error": "max-configs-exceeded"}
        # every config: on a 10k-op history one config's sweep over its
        # unlinearized ops is ~10k Python steps, and a cancelled search
        # tested every 4,096 configs (the JAX package's cadence) ran 49 s
        # past its cancel on the card's host (PERF.md)
        if cancel is not None and cancel.is_set():
            return {"valid": "unknown", "configs_explored": explored,
                    "error": "cancelled"}
        unlin = full & ~lin
        # minimum return among unlinearized ops
        r_min = INF_TIME
        m = unlin
        while m:
            i = (m & -m).bit_length() - 1
            m &= m - 1
            if ret_t[i] < r_min:
                r_min = ret_t[i]
        depth = (lin & ok_mask).bit_count()
        if depth > best_depth:
            best_depth = depth
            best_configs = []
        progressed = False
        m = unlin
        while m:
            i = (m & -m).bit_length() - 1
            m &= m - 1
            if invoke[i] >= r_min:
                break  # rows sorted by invoke: nothing further qualifies
            state2, ok = step(state, f[i], args[i], rets[i], NP)
            if not bool(ok):
                continue
            state2 = np.asarray(state2, np.int32)
            lin2 = lin | (1 << i)
            if (lin2 & ok_mask) == ok_mask:
                return {"valid": True, "configs_explored": explored}
            key = (lin2, state2.tobytes())
            if key not in seen:
                seen.add(key)
                stack.append((lin2, state2))
                progressed = True
        if not progressed and depth == best_depth and len(best_configs) < 8:
            best_configs.append((lin, state))

    # exhausted: not linearizable; decode knossos-style witnesses
    # (op / final_paths / previous_ok / configs -- see checker/witness.py)
    result = {"valid": False, "configs_explored": explored}
    if best_configs:
        # the oracle tracks several distinct deepest configs; decode them
        # through the same multi-config path as the device engine's TOPK
        # slots so the two witness shapes can never drift
        from . import witness
        slots = []
        for lin_x, state in best_configs:
            lx = np.zeros(n, bool)
            for i in range(n):
                lx[i] = bool((lin_x >> i) & 1)
            slots.append((lx, state))
        witness.attach_multi(result, spec, e, slots, init_state)
    return result


def check_history(spec, history, **kw):
    """Encode ``history`` (event dicts) for ``spec`` and run the search."""
    e, init_state = spec.encode(history)
    return check_encoded(spec, e, init_state, **kw)
