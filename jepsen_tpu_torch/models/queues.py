"""Queue models (knossos.model fifo-queue / unordered-queue).

The tensor face uses *canonical* fixed-capacity buffers so that equal queue
contents always produce byte-equal state vectors -- this is what makes the
checker's configuration dedup effective (SURVEY.md section 7 "unbounded model
state under vmap"):

* fifo-queue: left-aligned ring -- the front is always slot 0; dequeue
  shifts the whole buffer left (one vectorized roll, no head pointer).
* unordered-queue: a multiset kept sorted ascending with empties (NIL,
  int32 min) first.

Capacity is chosen from the history: the number of enqueue operations
(worst case all enqueued before any dequeue). Overflow cannot occur under
that choice, but the ok-flag still guards it.

A copy of ``jepsen_tpu.models.queues``: the oracles and the host analyses
(encode, hint, fast checks, plan, prune) are the same code; the two steps
are written for the component-first array faces of ``xp`` (the state's
slots down axis 0, every other operand broadcast against the rest), so
the same function runs one configuration at a time under ``xp.NP`` and
batched under ``xp.TORCH``.
"""

from __future__ import annotations

import numpy as np

from ..history import NIL
from .base import Model, ModelSpec, inconsistent, register_model

F_ENQUEUE, F_DEQUEUE = 0, 1


class FIFOQueue(Model):
    def __init__(self, items=()):
        self.items = tuple(items)

    def step(self, op):
        f, v = op["f"], op.get("value")
        if f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if f == "dequeue":
            if not self.items:
                return inconsistent("dequeue from empty queue")
            head, rest = self.items[0], self.items[1:]
            if v is not None and v != head:
                return inconsistent(f"dequeued {v!r}, expected {head!r}")
            return FIFOQueue(rest)
        raise ValueError(f"fifo-queue: unknown f {f!r}")

    def __eq__(self, other):
        return isinstance(other, FIFOQueue) and self.items == other.items

    def __hash__(self):
        return hash(("fifo-queue", self.items))

    def __repr__(self):
        return f"FIFOQueue({list(self.items)!r})"


class UnorderedQueue(Model):
    """A multiset: dequeue may return any enqueued element
    (knossos.model/unordered-queue). A dequeue of unknown value cannot be
    linearized (mirrors knossos, whose step sees a nil value)."""

    def __init__(self, items=()):
        self.items = tuple(sorted(items))

    def step(self, op):
        f, v = op["f"], op.get("value")
        if f == "enqueue":
            return UnorderedQueue(self.items + (v,))
        if f == "dequeue":
            if v is None:
                return inconsistent("dequeue of unknown value")
            if v not in self.items:
                return inconsistent(f"dequeued {v!r}, not in queue")
            items = list(self.items)
            items.remove(v)
            return UnorderedQueue(items)
        raise ValueError(f"unordered-queue: unknown f {f!r}")

    def __eq__(self, other):
        return isinstance(other, UnorderedQueue) and self.items == other.items

    def __hash__(self):
        return hash(("unordered-queue", self.items))

    def __repr__(self):
        return f"UnorderedQueue({list(self.items)!r})"


# -- tensor specs ------------------------------------------------------------

def _queue_capacity(e):
    return max(1, int((e.f == F_ENQUEUE).sum()))


def _pad_nil(state, s_pad):
    """Grow a queue state by appending empty (NIL) slots: for the left-
    aligned FIFO this is extra tail capacity; for the all-NIL initial
    unordered multiset it stays canonical (sorted)."""
    return np.concatenate(
        [state, np.full(s_pad - len(state), NIL, np.int32)])


def _fifo_step(state, f, args, ret, xp):
    # state = [count, buf[0..C-1]] down axis 0; front at buf[0]
    C = state.shape[0] - 1
    count = state[0]
    buf = state[1:]
    idxs = xp.arange(C, buf)
    is_enq = f == F_ENQUEUE
    # enqueue appends at index `count`
    enq_buf = xp.where(idxs == count, args[0], buf)
    enq_ok = count < C
    # dequeue pops buf[0], shifting left; last slot becomes empty
    front = buf[0]
    nonempty = count > 0
    deq_ok = nonempty & ((ret[0] == NIL) | (ret[0] == front))
    deq_buf = xp.where(idxs == C - 1, NIL, xp.roll(buf, -1))
    new_count = xp.astype(xp.where(is_enq, count + 1, count - 1),
                          state.dtype)
    new_buf = xp.where(is_enq, enq_buf, deq_buf)
    ok = xp.where(is_enq, enq_ok, deq_ok)
    return xp.concatenate([new_count[None], new_buf]), ok


def _queue_encode(spec, intern, f, value, ret_value):
    if f == "enqueue":
        return F_ENQUEUE, [intern.encode(value)], []
    if f == "dequeue":
        rv = ret_value if ret_value is not None else value
        return F_DEQUEUE, [], [intern.encode(rv)]
    raise ValueError(f"queue: unknown f {f!r}")


def _fifo_hint(e, inv32, ret32):
    """Search priority from the aspect plan: when the polynomial analysis
    can schedule the history (a full pop order including which crashed
    dequeue consumes which stuck value), an explicit witness
    linearization is constructed host-side and its positions become the
    priorities -- the device's greedy rollout then walks the witness end
    to end (depth += R per iteration) instead of reaching for info
    dequeues as a blind last resort, which pops values later ok dequeues
    still need: a mistake hundreds of levels beyond DFS backtracking
    range. Priorities are pure heuristics: soundness and completeness
    never depend on them, and the search still verifies every step
    through the model, so the verdict comes with a genuine linearization
    the aspect's existence proof alone does not provide."""
    verdict, plan = _fifo_plan(e, inv32, ret32, want_plan=True)
    if plan is None:
        return _fifo_hint_legacy(e, inv32, ret32)
    n = len(e)
    K = len(plan["pop"])
    # slot priorities: pop k's enqueue at 4k, its dequeue at 4k+2;
    # everything outside the pop schedule (never-consumed enqueues,
    # unmatched info dequeues) sorts after it, in original order
    pri = 4 * np.int64(K) + 8 + np.arange(n, dtype=np.int64)
    deq_val = np.full(n, NIL, np.int64)
    planned = np.zeros(n, bool)
    for k, (enq_i, deq_i) in enumerate(plan["pop"]):
        pri[enq_i] = 4 * k
        planned[enq_i] = True
        if deq_i is not None:
            pri[deq_i] = 4 * k + 2
            planned[deq_i] = True
            deq_val[deq_i] = int(e.args[enq_i][0])
    order = _witness_order(e, inv32, ret32, pri, deq_val, planned)
    if order is not None:
        pri = np.full(n, np.int64(n) + 8, np.int64) \
            + np.arange(n, dtype=np.int64)
        pri[order] = np.arange(len(order), dtype=np.int64)
    return np.clip(pri, -(2 ** 31), 2 ** 31 - 1).astype(np.int32)


def _witness_order(e, inv32, ret32, pri, deq_val, planned):
    """Simulate the plan schedule into an explicit witness linearization
    (list of op indices) or None when the simulation wedges (priorities
    then stay slot-based). The simulation respects the WGL eligibility
    rule, takes ops in slot-priority order, and -- unlike the device
    step, whose info dequeues accept any front -- only lets a matched
    info dequeue pop its ASSIGNED value, which stops it firing a slot
    early when an eligibility stall reorders neighbors."""
    import collections

    n = len(e)
    f = np.asarray(e.f)
    is_ok = np.asarray(e.is_ok, bool)
    args = np.asarray(e.args)[:, 0]
    rets = np.asarray(e.ret)[:, 0]
    srt = np.argsort(pri, kind="stable")
    # takeable: every ok op plus everything in the pop schedule (which
    # adds observed/forced info enqueues and matched info dequeues);
    # other info ops take no effect in the planned completion
    takeable = is_ok | planned
    ret_sorted = np.argsort(ret32, kind="stable")
    linearized = np.zeros(n, bool)
    q = collections.deque()
    order = []
    remaining_ok = int(is_ok.sum())
    start = rp = 0
    budget = 50 * n + 1000
    while remaining_ok:
        while start < n and (linearized[srt[start]]
                             or not takeable[srt[start]]):
            start += 1
        while rp < n and linearized[ret_sorted[rp]]:
            rp += 1
        rmin = int(ret32[ret_sorted[rp]]) if rp < n else 2 ** 31 - 1
        took = False
        j = start
        while j < n:
            budget -= 1
            if budget < 0:
                return None
            i = int(srt[j])
            j += 1
            if linearized[i] or not takeable[i] or \
                    int(inv32[i]) >= rmin:
                continue
            if f[i] == F_ENQUEUE:
                q.append(int(args[i]))
            else:
                want = int(deq_val[i]) if deq_val[i] != NIL \
                    else int(rets[i])
                if not q or q[0] != want:
                    continue
                q.popleft()
            linearized[i] = True
            order.append(i)
            remaining_ok -= bool(is_ok[i])
            took = True
            break
        if not took:
            return None
    return np.asarray(order, np.int64)


def _fifo_hint_legacy(e, inv32, ret32):
    """Fallback priority when no plan exists (NIL-valued ok dequeues or
    duplicate enqueue values): an enqueue must linearize before the
    dequeue returning its value, so cap each enqueue's priority at its
    dequeuer's deadline. This orders enqueues by dequeue order."""
    pri = ret32.astype(np.int64)
    enq_idx = {}
    for i in range(len(e)):
        if int(e.f[i]) == F_ENQUEUE:
            enq_idx[int(e.args[i][0])] = i
    for i in range(len(e)):
        if int(e.f[i]) == F_DEQUEUE and bool(e.is_ok[i]):
            j = enq_idx.get(int(e.ret[i][0]))
            if j is not None:
                # NOT min(own return, ...): an enqueue that completes
                # early but whose value is dequeued late must still sort
                # by its dequeuer, or concurrent enqueues linearize in
                # completion order instead of pop order. The WGL
                # eligibility rule (not priority) is what guarantees the
                # enqueue still linearizes before its return barrier.
                pri[j] = pri[i] - 1
    return np.clip(pri, -(2 ** 31), 2 ** 31 - 1).astype(np.int32)


def _per_value_scan(e, inv32, ret32):
    """Shared queue/bag pattern scan. Returns (enq_of, deq_of, verdict):
    verdict is None when the scan passes, a (False, witness) pair when a
    per-value bad pattern fires, or "skip" when the history is out of
    scope (unknown dequeue values, duplicate enqueue values)."""
    f = np.asarray(e.f)
    is_ok = np.asarray(e.is_ok, bool)
    ok_deq = (f == F_DEQUEUE) & is_ok
    if np.any(np.asarray(e.ret)[ok_deq, 0] == NIL):
        return None, None, "skip"
    enq_of = {}
    for i in np.flatnonzero(f == F_ENQUEUE):
        v = int(e.args[i][0])
        if v in enq_of:
            return None, None, "skip"
        enq_of[v] = i
    deq_of = {}
    for i in np.flatnonzero(ok_deq):
        v = int(e.ret[i][0])
        if v in deq_of:
            return None, None, (False, {"op_index": int(i),
                                        "pattern": "double-dequeue"})
        deq_of[v] = i
        j = enq_of.get(v)
        if j is None:
            return None, None, (
                False, {"op_index": int(i),
                        "pattern": "dequeue-of-unknown-value"})
        if ret32[i] < inv32[j]:
            return None, None, (
                False, {"op_index": int(i),
                        "pattern": "dequeue-before-enqueue"})
    return enq_of, deq_of, None


_FAR = np.int64(2) ** 62


def _fifo_fast_check(e, inv32, ret32):
    """Aspect-style polynomial decision for FIFO histories (after
    Henzinger/Sezgin/Vafeiadis-style bad patterns; values are unique and
    dequeues always return a value in this model).

    Certain-invalidity patterns (sound even with info ops):
      i.  an ok dequeue of a value nobody enqueued, or dequeued twice
      ii. a dequeue completing before its value's enqueue was invoked
      iii. FIFO order violation: enq(a) really-before enq(b), yet
           deq(b) really-before deq(a) (both dequeues ok)
      iv. enq(a) really-before enq(b), b ok-dequeued, a (ok-enqueued)
          never dequeued and not assignable to any crashed dequeue
          (the matching below).

    Crashed (info) ops are handled EXACTLY, not punted to the search:

    * A crashed enqueue either committed (observed by an ok dequeue: it
      is forced, with window [invoke, inf) -- infinite return already
      flows through the patterns) or is unobserved, in which case
      dropping it wholesale preserves linearizability both ways
      (removing a value and its dequeue from any valid FIFO run keeps
      the run valid, and it is never *needed* since every ok dequeue
      returns a known value here).
    * A crashed dequeue, if it took effect, consumed exactly one stuck
      value. Completing each info dequeue with a chosen stuck value (or
      dropping it) turns the history into a complete one, to which the
      bad-pattern theorem applies. Since a completed info dequeue never
      returns (window [invoke, inf)), the ONLY patterns it can enter are
      (a) membership: every stuck value really-enqueued-before a
      dequeued value must itself be consumed (the overtaken set is
      already closed under this relation, see _fifo_plan) -- and (b) a
      deadline: consuming value a is
      futile if the info dequeue was invoked after some ok dequeue of a
      later-enqueued value completed (pattern iii with the info dequeue
      as the late party). So validity reduces to a threshold matching:
      values (sorted by deadline) against info-dequeue invocation times,
      feasible iff the j-th smallest invocation is <= the j-th smallest
      deadline (Hall's condition; greedy smallest-first is exact).

    The only remaining out-of-scope histories ("skip" -> search):
    ok dequeues returning an unknown (NIL) value, and duplicate enqueue
    values.

    Returns True, None, or (False, {"op_index", "pattern"}) -- the
    offending op becomes the failure witness."""
    verdict, _ = _fifo_plan(e, inv32, ret32)
    return verdict


def _fifo_plan(e, inv32, ret32, want_plan=False):
    """The shared FIFO aspect analysis (see _fifo_fast_check for the
    theory). Returns (verdict, plan): verdict as _fifo_fast_check;
    plan (only built when ``want_plan``, on valid histories in scope)
    is a dict with "pop": [(enqueue_idx, dequeue_idx | None)] in a
    witness-consistent pop order (matched info dequeues included),
    consumed by the search hint."""
    n = len(e)
    if n == 0:
        return True, {"pop": []}
    f = np.asarray(e.f)
    is_ok = np.asarray(e.is_ok, bool)
    deq_mask = (f == F_DEQUEUE)
    enq_of, deq_of, status = _per_value_scan(e, inv32, ret32)
    if status == "skip":
        return None, None
    if status is not None:
        return status, None
    # (iii): order violations among dequeued values. A violating pair
    # (a, b) has enq(a) really-before enq(b) and deq(b) really-before
    # deq(a): for each a that is "is the earliest dequeue-completion,
    # among values whose enqueue began after a's enqueue returned,
    # before a's dequeue was invoked?" -- a suffix-min sweep over the
    # enqueue-invocation order, O(V log V) (the naive V x V boolean
    # matrices melt past ~50k dequeued values).
    vals = sorted(deq_of)
    ei_sorted = dr_sorted = dj_sorted = None
    if vals:
        ej = np.asarray([enq_of[v] for v in vals])
        dj = np.asarray([deq_of[v] for v in vals])
        enq_ret = ret32[ej].astype(np.int64)
        enq_inv = inv32[ej].astype(np.int64)
        deq_ret = ret32[dj].astype(np.int64)
        deq_inv = inv32[dj].astype(np.int64)
        order = np.argsort(enq_inv)
        ei_sorted = enq_inv[order]
        dr_sorted = deq_ret[order]
        dj_sorted = dj[order]
        suffix_min = np.minimum.accumulate(dr_sorted[::-1])[::-1]
        pos3 = np.searchsorted(ei_sorted, enq_ret, side="right")
        smin = np.where(pos3 < len(ei_sorted),
                        suffix_min[np.minimum(pos3, len(ei_sorted) - 1)],
                        _FAR)
        bad_a = smin < deq_inv
        if np.any(bad_a):
            ai = int(np.argmax(bad_a))
            k = int(pos3[ai])
            bi = int(np.argmin(dr_sorted[k:])) + k
            return (False, {"op_index": int(dj[ai]),
                            "pattern": "fifo-order-violation",
                            "own-enqueue": int(ej[ai]),
                            "overtaking-dequeue": int(dj_sorted[bi])}), \
                None
    # (iv) generalized: stuck values (ok-enqueued, never ok-dequeued)
    stuck_idx = np.asarray(
        sorted(enq_of[v] for v in enq_of
               if v not in deq_of and is_ok[enq_of[v]]), np.int64)
    assigned = []          # (stuck enqueue idx, info dequeue idx, eff_dl)
    if stuck_idx.size:
        sret = ret32[stuck_idx].astype(np.int64)   # enqueue completions
        sinv = inv32[stuck_idx].astype(np.int64)   # enqueue invocations
        if vals:
            # deadline(a) = earliest completion among ok dequeues of
            # values whose enqueue began after a's enqueue returned
            pos = np.searchsorted(ei_sorted, sret, side="right")
            in_range = pos < len(ei_sorted)
            deadline = np.where(
                in_range,
                suffix_min[np.minimum(pos, len(ei_sorted) - 1)], _FAR)
        else:
            deadline = np.full(stuck_idx.size, _FAR)
        # Must-consume membership: a stuck value overtaken by an ok
        # dequeue (finite deadline). This set is already closed under
        # "really-enqueued-before a consumed value": if c's enqueue
        # returned before member m's enqueue was invoked, then m's
        # deadline witness b (enq(m) returned before enq(b) began) also
        # overtakes c -- ret_c < inv_m <= ret_m < inv_b -- so c has a
        # finite deadline of its own. (Consumption through info
        # dequeues adds no further members: their pops never return, so
        # they real-time-precede nothing.)
        member = deadline < _FAR
        if member.any():
            info_idx = np.flatnonzero(deq_mask & ~is_ok)
            info_idx = info_idx[np.argsort(
                inv32[info_idx].astype(np.int64), kind="stable")]
            info_inv = inv32[info_idx].astype(np.int64)
            D_order = np.argsort(deadline[member], kind="stable")
            D = deadline[member][D_order]
            bad_j = None
            if len(D) > len(info_inv):
                bad_j = len(info_inv)
            else:
                over = np.flatnonzero(info_inv[:len(D)] > D)
                if over.size:
                    bad_j = int(over[0])
            if bad_j is not None:
                jj = min(bad_j, len(D) - 1)
                a = int(stuck_idx[member][D_order[jj]])
                wit = {"pattern": "dequeue-past-stuck-value",
                       "stuck-enqueue": a}
                # point at the overtaking dequeue when one exists
                if vals and D[jj] < _FAR:
                    k = int(np.searchsorted(
                        ei_sorted, sret[member][D_order[jj]],
                        side="right"))
                    sm = int(np.argmin(dr_sorted[k:])) + k
                    wit["op_index"] = int(dj_sorted[sm])
                else:
                    wit["op_index"] = a
                return (False, wit), None
            if want_plan:
                m_idx = stuck_idx[member]
                assigned = [(int(m_idx[D_order[j]]), int(info_idx[j]),
                             int(D[j]))
                            for j in range(len(D))]
    if not want_plan:        # fast-path verdicts skip plan construction
        return True, None
    # Valid. Build a witness-consistent pop order for the search hint:
    # a topological order of consumed values under the precedence union
    #   enq(u) really-before enq(v)   -> u pops before v  (queue order)
    #   deq(u) really-before deq(v)   -> u pops before v
    #   deq(u) really-before enq(v)   -> u pops before v
    # which the bad-pattern checks above prove acyclic (any cycle
    # reduces to a 2-cycle through interval-order transitivity, and
    # 2-cycles are exactly patterns ii/iii + the matching deadlines).
    pop = []
    rows = []          # (enq_idx, deq_idx, einv, eret, dinv, dret, edf)
    if vals:
        for v in vals:
            ei, di = int(enq_of[v]), int(deq_of[v])
            rows.append((ei, di, int(inv32[ei]), int(ret32[ei]),
                         int(inv32[di]), int(ret32[di]),
                         (int(ret32[di]), 1)))
    for enq_i, deq_i, dl in assigned:
        # a matched stuck value pops through its info dequeue: the pop
        # never returns (window [invoke, inf)), and should schedule just
        # before the ok dequeue that forces it out (its deadline)
        rows.append((enq_i, deq_i, int(inv32[enq_i]),
                     int(ret32[enq_i]), int(inv32[deq_i]), int(_FAR),
                     (dl, 0)))
    order = _value_topo_order(rows)
    if order is None:        # safety net: EDF-ish slot order
        order = sorted(range(len(rows)), key=lambda r: rows[r][6])
    pop = [(rows[r][0], rows[r][1]) for r in order]
    return True, {"pop": pop}


def _value_topo_order(rows):
    """Topological order of consumed values under the pop-precedence
    union (see _fifo_plan). Availability of a value is two monotone
    threshold tests (u-before-v edges all have the form ret_u < inv_v,
    and the mins only rise as values are emitted), so two pointers over
    inv-sorted lists feed an earliest-deadline heap; ties broken toward
    stuck values so they pop before the ok dequeue that forces them.
    Returns row indices, or None if the heap ever runs dry (a cycle --
    impossible after the pattern checks, kept as a safety net)."""
    import heapq

    V = len(rows)
    if V == 0:
        return []
    einv = [r[2] for r in rows]
    eret = [r[3] for r in rows]
    dinv = [r[4] for r in rows]
    dret = [r[5] for r in rows]
    edf = [r[6] for r in rows]
    eret_heap = [(eret[v], v) for v in range(V)]
    dret_heap = [(dret[v], v) for v in range(V)]
    heapq.heapify(eret_heap)
    heapq.heapify(dret_heap)
    by_einv = sorted(range(V), key=lambda v: einv[v])
    by_dinv = sorted(range(V), key=lambda v: dinv[v])
    emitted = [False] * V
    passed = [0] * V
    avail = []
    pe = pd = 0
    out = []
    for _ in range(V):
        while eret_heap and emitted[eret_heap[0][1]]:
            heapq.heappop(eret_heap)
        while dret_heap and emitted[dret_heap[0][1]]:
            heapq.heappop(dret_heap)
        m_e = eret_heap[0][0] if eret_heap else _FAR
        m_d = dret_heap[0][0] if dret_heap else _FAR
        # condition 1: no remaining enqueue or dequeue returned before
        # this value's enqueue was invoked; condition 2: no remaining
        # dequeue returned before this value's dequeue was invoked
        t1 = min(m_e, m_d)
        while pe < V and einv[by_einv[pe]] <= t1:
            v = by_einv[pe]
            pe += 1
            passed[v] += 1
            if passed[v] == 2 and not emitted[v]:
                heapq.heappush(avail, (edf[v], v))
        while pd < V and dinv[by_dinv[pd]] <= m_d:
            v = by_dinv[pd]
            pd += 1
            passed[v] += 1
            if passed[v] == 2 and not emitted[v]:
                heapq.heappush(avail, (edf[v], v))
        while avail and emitted[avail[0][1]]:
            heapq.heappop(avail)
        if not avail:
            return None
        _, v = heapq.heappop(avail)
        emitted[v] = True
        out.append(v)
    return out


def _queue_prune(e, inv32, ret32):
    """Sound+complete candidate prune for the search path: a crashed
    enqueue whose value no ok dequeue returned can be dropped wholesale
    (with it, any dequeue consuming it -- removing a value end to end
    from a valid queue run keeps the run valid, and the value is never
    *required* when every ok dequeue returns a known value). Without the
    prune, the greedy rollout linearizes these junk enqueues the moment
    a desired op fails once, wedging stuck values into the queue and
    forcing exponential backtracking (measured: the raw search ceiling
    on info-bearing FIFO histories roughly triples with the prune).
    Inapplicable (None) when an ok dequeue returns NIL -- it could be
    the one that consumed the junk value -- or when enqueue values
    repeat."""
    f = np.asarray(e.f)
    is_ok = np.asarray(e.is_ok, bool)
    rets = np.asarray(e.ret)[:, 0]
    args = np.asarray(e.args)[:, 0]
    ok_deq = (f == F_DEQUEUE) & is_ok
    if np.any(rets[ok_deq] == NIL):
        return None
    enq = f == F_ENQUEUE
    enq_vals = args[enq]
    if len(np.unique(enq_vals)) != len(enq_vals):
        return None
    observed = set(rets[ok_deq].tolist())
    keep = np.ones(len(e), bool)
    for i in np.flatnonzero(enq & ~is_ok):
        if int(args[i]) not in observed:
            keep[i] = False
    return keep


fifo_queue_spec = register_model(ModelSpec(
    name="fifo-queue",
    f_codes={"enqueue": F_ENQUEUE, "dequeue": F_DEQUEUE},
    arg_width=1,
    state_size=lambda e: _queue_capacity(e) + 1,
    init_state=lambda e, s: np.concatenate(
        [np.zeros(1, np.int32), np.full(s - 1, NIL, np.int32)]),
    step=_fifo_step,
    make_oracle=FIFOQueue,
    encode_op=_queue_encode,
    pad_state=_pad_nil,
    hint=_fifo_hint,
    fast_check=_fifo_fast_check,
    prune=_queue_prune,
    decode_state=lambda st: {
        "queue": [int(v) for v in st[1:1 + int(st[0])]]},
))


def _unordered_step(state, f, args, ret, xp):
    # state = sorted multiset down axis 0; NIL (int32 min) slots sort
    # first = empty
    C = state.shape[0]
    idxs = xp.arange(C, state)
    is_enq = f == F_ENQUEUE
    # enqueue: overwrite the first empty slot
    empty = state == NIL
    first_empty = xp.argmax(empty)
    enq_buf = xp.where(idxs == first_empty, args[0], state)
    enq_ok = xp.any(empty)
    # dequeue: clear the first slot equal to ret (value must be known)
    known = ret[0] != NIL
    match = state == ret[0]
    exists = xp.any(match)
    first_match = xp.argmax(match)
    deq_buf = xp.where(idxs == first_match, NIL, state)
    deq_ok = known & exists
    new_buf = xp.where(is_enq, enq_buf, deq_buf)
    ok = xp.where(is_enq, enq_ok, deq_ok)
    return xp.sort(new_buf), ok


def _unordered_fast_check(e, inv32, ret32):
    """Bag (unordered queue) polynomial decision. Without FIFO order,
    the only constraints are per-value: a dequeue of v needs an
    enqueue of v that STARTED before the dequeue finished, each value
    dequeued at most once, and nothing dequeued that was never
    enqueued. That's exact for complete histories; crashed ops change
    nothing: a crashed enqueue is forced iff observed (open window flows
    through the scan), a crashed dequeue can always be completed as
    taking no effect (a bag has no order, so an extra resident value
    never blocks any other dequeue -- unlike FIFO there is no
    overtaking pattern to repair). Witness: place each surviving
    enqueue at its invocation and each dequeue of v just after
    max(its invocation, v's enqueue invocation), which the per-value
    scan guarantees is within its interval."""
    n = len(e)
    if n == 0:
        return True
    _, _, status = _per_value_scan(e, inv32, ret32)
    if status == "skip":
        return None
    if status is not None:
        return status
    return True


unordered_queue_spec = register_model(ModelSpec(
    name="unordered-queue",
    f_codes={"enqueue": F_ENQUEUE, "dequeue": F_DEQUEUE},
    arg_width=1,
    state_size=_queue_capacity,
    init_state=lambda e, s: np.full(s, NIL, np.int32),
    step=_unordered_step,
    make_oracle=UnorderedQueue,
    encode_op=_queue_encode,
    pad_state=_pad_nil,
    fast_check=_unordered_fast_check,
    prune=_queue_prune,
    decode_state=lambda st: {
        "items": sorted(int(v) for v in st if int(v) != NIL)},
))
