"""EXPERIMENTAL membership nemesis: standardized join/leave/grow/shrink
support (reference jepsen/src/jepsen/nemesis/membership.clj, 266 LoC +
membership/state.clj, 40 LoC).

Cluster state is a `State` object the user implements; per-node views
are polled in background threads, merged into an authoritative view, and
pending operations are resolved toward a fixed point. The generator asks
the state machine for the next legal op."""

from __future__ import annotations

import contextvars
import logging
import threading

from . import Nemesis as NemesisProto
from .. import control as c
from .. import generator as gen

logger = logging.getLogger(__name__)

#: seconds between node-view refreshes (membership.clj:59-61)
NODE_VIEW_INTERVAL = 5


class State:
    """The membership state machine protocol (membership/state.clj:7-40).

    Implementations are *immutable*: every transition returns a new
    State. Cluster bookkeeping lives in three attributes maintained by
    the nemesis: ``node_views`` (node -> that node's view), ``view``
    (merged authoritative view), ``pending`` (set of in-flight
    (op, op') pairs)."""

    node_views: dict
    view = None
    pending: frozenset

    def node_view(self, test, node):
        """This node's view of the cluster (None = unknown, ignored)."""
        raise NotImplementedError

    def merge_views(self, test):
        """Derive an authoritative view from self.node_views."""
        raise NotImplementedError

    def fs(self):
        """All op f's this state machine may generate."""
        raise NotImplementedError

    def op(self, test):
        """Next op to perform, "pending" if none ready now, None if done
        forever."""
        raise NotImplementedError

    def invoke(self, test, op):
        """Apply a generated op; returns the completed op.

        Called with the nemesis lock HELD (so the view read, the
        cluster operation, and the pending-set record are atomic with
        respect to poller swaps): implementations must not block
        indefinitely -- node-view polling stalls for the duration. The
        lock is reentrant, so calling back into the nemesis is safe."""
        raise NotImplementedError

    def resolve(self, test):
        """Evolve toward a fixed point; returns a State."""
        return self

    def resolve_op(self, test, op_pair):
        """Returns a State with the pending (op, op') resolved, or None
        if it isn't resolvable yet."""
        return None

    # -- immutable update helper ---------------------------------------

    def assoc(self, **kw) -> "State":
        import copy
        new = copy.copy(self)
        for k, v in kw.items():
            setattr(new, k, v)
        return new


def initial_fields(state: State) -> State:
    """Blank bookkeeping fields (membership.clj:68-77)."""
    return state.assoc(node_views={}, view=None, pending=frozenset())


def resolve_ops(state: State, test, opts) -> State:
    """Resolve any resolvable pending ops (membership.clj:79-93)."""
    for pair in state.pending:
        st = state.resolve_op(test, pair)
        if st is not None:
            if opts.get("log_resolve_op"):
                logger.info("Resolved pending membership operation: %r",
                            pair)
            state = st.assoc(pending=state.pending - {pair})
    return state


def resolve(state: State, test, opts) -> State:
    """resolve + resolve_ops to a fixed point (membership.clj:95-107)."""
    while True:
        state2 = resolve_ops(state.resolve(test), test, opts)
        if state2 is state or _state_eq(state2, state):
            return state2
        state = state2


def _state_eq(a, b):
    return (a.__class__ is b.__class__
            and a.__dict__ == b.__dict__)


class Nemesis(NemesisProto):
    """Wraps a State in background node-view pollers and an invoke path
    (membership.clj:159-206). The state box is shared with the package's
    generator."""

    def __init__(self, box, opts=None):
        self.box = box                 # {"state": State}
        self.opts = opts or {}
        self._running = threading.Event()
        self._stop = threading.Event()
        self._threads = []
        # RLock: State.invoke implementations may call back into this
        # nemesis (e.g. via _swap) without deadlocking themselves
        # (advisor finding r3). NOTE the lock is still held for the
        # whole duration of State.invoke -- pollers wait it out -- so
        # invoke implementations must not block indefinitely.
        self._lock = threading.RLock()

    def _swap(self, f):
        with self._lock:
            self.box["state"] = f(self.box["state"])
            return self.box["state"]

    def _update_node_view(self, test, node):
        """Poll one node's view and merge it in (membership.clj:109-140)."""
        nv = self.box["state"].node_view(test, node)
        if nv is None:
            return

        def merge(state):
            state = state.assoc(
                node_views={**state.node_views, node: nv})
            state = state.assoc(view=state.merge_views(test))
            return resolve(state, test, self.opts)

        before = self.box["state"].view
        after = self._swap(merge)
        if self.opts.get("log_view") and after.view != before:
            logger.info("New membership view from %s:\n%r", node,
                        after.view)

    def _poller(self, test, node):
        interval = self.opts.get("node_view_interval", NODE_VIEW_INTERVAL)
        while self._running.is_set():
            try:
                with c.on(node):
                    self._update_node_view(test, node)
            except Exception:  # noqa: BLE001 - keep polling
                logger.warning("Node view updater caught error; will "
                               "retry", exc_info=True)
            # interruptible sleep: wakes immediately on teardown
            if self._stop.wait(interval):
                return

    def setup(self, test):
        self._threads = []
        self._swap(initial_fields)
        self._running.set()
        self._stop.clear()
        ctx = contextvars.copy_context()
        for node in test.get("nodes", []):
            t = threading.Thread(
                target=ctx.copy().run,
                args=(self._poller, test, node),
                daemon=True, name=f"membership view {node}")
            t.start()
            self._threads.append(t)
        return self

    def invoke(self, test, op):
        # read + invoke + record under one lock hold: a poller swap
        # between the read and the pending-set update would make the
        # invoke run against a stale view (the lock is reentrant, so
        # the nested _swap is fine)
        with self._lock:
            done = self.box["state"].invoke(test, op)
            self._swap(lambda s: resolve(
                s.assoc(pending=s.pending
                        | {(_freeze(op), _freeze(done))}),
                test, self.opts))
        return done

    def teardown(self, test):
        self._running.clear()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)

    def fs(self):
        return self.box["state"].fs()


def _freeze(op):
    if isinstance(op, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in op.items()))
    if isinstance(op, (list, set)):
        return tuple(_freeze(x) for x in op)
    return op


class Generator(gen.Generator):
    """Asks the shared state machine for ops (membership.clj:208-218)."""

    def __init__(self, box):
        self.box = box

    def update(self, test, ctx, event):
        return self

    def op(self, test, ctx):
        op = self.box["state"].op(test)
        if op is None:
            return None
        if op == "pending":
            return gen.PENDING, self
        return gen.fill_in_op(dict(op), ctx), self


def package(opts):
    """{"nemesis", "generator"} when faults includes "membership"
    (membership.clj:220-266). opts["membership"] holds {"state": State,
    "log_*": bools, "node_view_interval": s}."""
    if "membership" not in set(opts.get("faults", ())):
        return None
    mopts = dict(opts.get("membership") or {})
    state = mopts.pop("state")
    box = {"state": state}
    nem = Nemesis(box, mopts)
    g = gen.stagger(opts.get("interval", 10), Generator(box))
    return {"nemesis": nem, "generator": g,
            "final_generator": None, "perf": set()}
