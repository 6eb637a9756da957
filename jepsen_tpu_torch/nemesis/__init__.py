"""Fault injection: nemeses break clusters on command (reference
jepsen/src/jepsen/nemesis.clj, 539 LoC).

A nemesis is driven like a client by the generator/interpreter, but its ops
run with process "nemesis" and type info. Grudge computations (who can't
talk to whom) are pure functions over the node list; the partitioner
nemesis applies them through the test's Net."""

from __future__ import annotations

import random
import threading

from . import _grudges as grudges  # noqa: F401  (re-export module)
from ._grudges import (bisect, bridge, complete_grudge,  # noqa: F401
                       invert_grudge, majorities_ring,
                       majorities_ring_perfect, majorities_ring_stochastic,
                       split_one)
from .. import control as c
from .. import net as net_
from .. import obs
from ..util import timeout_call


class Nemesis:
    """setup/invoke/teardown (nemesis.clj:11-16) + fs reflection
    (:18-21)."""

    def setup(self, test):
        return self

    def invoke(self, test, op):
        raise NotImplementedError

    def teardown(self, test):
        pass

    def fs(self):
        """Which :f values this nemesis handles (Reflection)."""
        return set()


class _Noop(Nemesis):
    def invoke(self, test, op):
        return op


noop = _Noop()


class InvalidNemesisCompletion(Exception):
    pass


class Validate(Nemesis):
    """Asserts invoke returns info ops with unchanged process/f
    (nemesis.clj:49-90)."""

    def __init__(self, nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        res = self.nemesis.setup(test)
        if not isinstance(res, Nemesis):
            raise InvalidNemesisCompletion(
                f"expected setup to return a Nemesis, got {res!r}")
        return Validate(res)

    def invoke(self, test, op):
        t0 = obs.now_ns()
        out = self.nemesis.invoke(test, op)
        _record_fault(op, out, t0)
        problems = []
        if not isinstance(out, dict):
            problems.append("should be a dict")
        else:
            if out.get("type") != "info":
                problems.append("type should be info")
            if out.get("process") != op.get("process"):
                problems.append("process should be the same")
            if out.get("f") != op.get("f"):
                problems.append("f should be the same")
        if problems:
            raise InvalidNemesisCompletion(
                f"invalid nemesis completion {out!r} for {op!r}: "
                + "; ".join(problems))
        return out

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()


def validate(nemesis):
    return Validate(nemesis)


def _record_fault(op, out, t0):
    """Trace one nemesis invocation (every nemesis in a run is wrapped
    by Validate, so this sees them all): an ``X`` span on the nemesis
    track for the invocation itself, plus an async fault *window* —
    ``start*`` fs open it, the matching ``stop*`` f closes it — so the
    whole disruption interval is visible in Perfetto even though the
    start and stop run as separate ops."""
    if not obs.enabled():
        return
    f = str(op.get("f"))
    obs.complete(f"nemesis.{f}", t0, obs.now_ns() - t0, cat="nemesis",
                 tid=-1, value=repr(out.get("value"))[:200]
                 if isinstance(out, dict) else None)
    obs.inc("nemesis.ops", f=f)
    if f.startswith("start"):
        obs.window_start("fault", f[len("start"):].strip("-_") or "fault",
                         f=f)
        obs.inc("nemesis.faults_started")
    elif f.startswith("stop"):
        obs.window_end("fault", f[len("stop"):].strip("-_") or "fault",
                       f=f)


class Timeout(Nemesis):
    """Bounds invoke wall time; timed-out ops get value "timeout"
    (nemesis.clj:92-106)."""

    def __init__(self, timeout_ms, nemesis):
        self.timeout_ms = timeout_ms
        self.nemesis = nemesis

    def setup(self, test):
        return Timeout(self.timeout_ms, self.nemesis.setup(test))

    def invoke(self, test, op):
        fallback = dict(op)
        fallback["value"] = "timeout"
        out = timeout_call(self.timeout_ms, fallback,
                           self.nemesis.invoke, test, op)
        if out is fallback:
            # the abandoned invoke thread is already counted by
            # timeout_call; this separates nemesis timeouts in metrics
            obs.inc("nemesis.timeouts", f=str(op.get("f")))
        return out

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()


def timeout(timeout_ms, nemesis):
    return Timeout(timeout_ms, nemesis)


# ---------------------------------------------------------------------------
# partitioners (nemesis.clj:157-281)

class Partitioner(Nemesis):
    """start: cut links per (grudge nodes) or the op's value; stop: heal
    (nemesis.clj:157-183)."""

    def __init__(self, grudge_fn=None):
        self.grudge_fn = grudge_fn

    def setup(self, test):
        net_.heal(test)
        return self

    def invoke(self, test, op):
        out = dict(op)
        out["type"] = "info"
        if op["f"] == "start":
            grudge = op.get("value")
            if grudge is None:
                if self.grudge_fn is None:
                    raise ValueError(
                        f"op {op!r} needs a grudge value, and this "
                        "partitioner has no grudge function")
                grudge = self.grudge_fn(test["nodes"])
            net_.drop_all(test, grudge)
            out["value"] = ["isolated", {k: sorted(v) for k, v
                                         in grudge.items()}]
        elif op["f"] == "stop":
            net_.heal(test)
            out["value"] = "network-healed"
        else:
            raise ValueError(f"partitioner: unknown f {op['f']!r}")
        return out

    def teardown(self, test):
        net_.heal(test)

    def fs(self):
        return {"start", "stop"}


def partitioner(grudge_fn=None):
    return Partitioner(grudge_fn)


def partition_halves():
    """First half vs second half (nemesis.clj:185-190)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves():
    """Random halves (nemesis.clj:192-195)."""
    def g(nodes):
        nodes = list(nodes)
        random.shuffle(nodes)
        return complete_grudge(bisect(nodes))
    return Partitioner(g)


def partition_random_node():
    """Isolate one random node (nemesis.clj:197-200)."""
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring():
    """Every node sees a majority; no two see the same one
    (nemesis.clj:277-281)."""
    return Partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# composition (nemesis.clj:285-428)

class FMap(Nemesis):
    """Remaps the :f values a nemesis accepts (nemesis.clj:285-327);
    symmetric with generator.f_map so packages compose."""

    def __init__(self, lift, nemesis, unlift=None):
        self.lift = lift
        self.nemesis = nemesis
        self.unlift = unlift or {lift(f): f for f in nemesis.fs()}

    def setup(self, test):
        return FMap(self.lift, self.nemesis.setup(test), self.unlift)

    def invoke(self, test, op):
        inner = dict(op)
        inner["f"] = self.unlift[op["f"]]
        out = dict(self.nemesis.invoke(test, inner))
        out["f"] = op["f"]
        return out

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return {self.lift(f) for f in self.nemesis.fs()}


def f_map(lift, nemesis):
    if isinstance(lift, dict):
        d = dict(lift)
        return FMap(lambda f: d[f], nemesis)
    return FMap(lift, nemesis)


class Compose(Nemesis):
    """Routes ops to child nemeses by :f -- via explicit f-maps/sets (dict
    form) or Reflection (collection form) (nemesis.clj:334-428)."""

    def __init__(self, nemeses):
        self.nemeses = nemeses    # dict: fs-spec -> nemesis, or list

    def setup(self, test):
        if isinstance(self.nemeses, dict):
            return Compose({k: n.setup(test)
                            for k, n in self.nemeses.items()})
        return Compose([n.setup(test) for n in self.nemeses])

    def _route(self, f):
        """Returns (inner_f, nemesis) or raises. Dict-form specs may be
        frozensets (f passes through), tuples of (outer, inner) pairs
        (f is renamed -- the hashable stand-in for the reference's
        map-as-key idiom), or callables returning the inner f or None."""
        if isinstance(self.nemeses, dict):
            for spec, nem in self.nemeses.items():
                if isinstance(spec, (set, frozenset)):
                    if f in spec:
                        return f, nem
                elif isinstance(spec, tuple):
                    m = dict(spec)
                    if f in m:
                        return m[f], nem
                elif callable(spec):
                    f2 = spec(f)
                    if f2 is not None:
                        return f2, nem
            raise ValueError(f"no nemesis can handle {f!r}")
        for nem in self.nemeses:
            if f in nem.fs():
                return f, nem
        raise ValueError(
            f"no nemesis can handle {f!r} "
            f"(known: {sorted(self.fs(), key=str)})")

    def invoke(self, test, op):
        f2, nem = self._route(op["f"])
        inner = dict(op)
        inner["f"] = f2
        out = dict(nem.invoke(test, inner))
        out["f"] = op["f"]
        return out

    def teardown(self, test):
        nems = (self.nemeses.values() if isinstance(self.nemeses, dict)
                else self.nemeses)
        for n in nems:
            n.teardown(test)

    def fs(self):
        out = set()
        if isinstance(self.nemeses, dict):
            for spec, nem in self.nemeses.items():
                if isinstance(spec, (set, frozenset)):
                    out |= set(spec)
                elif isinstance(spec, tuple):
                    out |= {outer for outer, _ in spec}
                else:
                    raise ValueError(
                        "can only infer fs from set/pair-tuple specs")
        else:
            for nem in self.nemeses:
                dup = out & nem.fs()
                assert not dup, f"nemeses both use fs {dup}"
                out |= nem.fs()
        return out


def compose(nemeses):
    return Compose(nemeses)


# ---------------------------------------------------------------------------
# process / file / clock faults (nemesis.clj:435-539)

class NodeStartStopper(Nemesis):
    """start: run start_fn on targeted nodes; stop: run stop_fn on them
    (nemesis.clj:452-495)."""

    def __init__(self, targeter, start_fn, stop_fn):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self.nodes = None
        self.lock = threading.Lock()

    def invoke(self, test, op):
        out = dict(op)
        out["type"] = "info"
        with self.lock:
            if op["f"] == "start":
                # dispatch on declared arity (catching TypeError would
                # misread a TypeError raised *inside* a 2-arg targeter as
                # an arity mismatch and re-invoke it, duplicating effects)
                from ..generator import _arity2
                if _arity2(self.targeter):
                    ns = self.targeter(test, test["nodes"])
                else:
                    ns = self.targeter(test["nodes"])
                if ns is None:
                    out["value"] = "no-target"
                elif self.nodes is not None:
                    out["value"] = f"nemesis already disrupting {self.nodes}"
                else:
                    ns = [ns] if isinstance(ns, str) else list(ns)
                    self.nodes = ns
                    out["value"] = c.on_nodes(
                        test, lambda t, n: self.start_fn(t, n), ns)
            elif op["f"] == "stop":
                if self.nodes is None:
                    out["value"] = "not-started"
                else:
                    out["value"] = c.on_nodes(
                        test, lambda t, n: self.stop_fn(t, n), self.nodes)
                    self.nodes = None
        return out

    def fs(self):
        return {"start", "stop"}


def node_start_stopper(targeter, start_fn, stop_fn):
    return NodeStartStopper(targeter, start_fn, stop_fn)


def hammer_time(process_name, targeter=None):
    """SIGSTOP/SIGCONT a process (nemesis.clj:497-511)."""
    targeter = targeter or (lambda nodes: random.choice(list(nodes)))

    def start(test, node):
        with c.su():
            c.exec_("killall", "-s", "STOP", process_name)
        return ["paused", process_name]

    def stop(test, node):
        with c.su():
            c.exec_("killall", "-s", "CONT", process_name)
        return ["resumed", process_name]

    return NodeStartStopper(targeter, start, stop)


class TruncateFile(Nemesis):
    """Drops the last :drop bytes of :file per node (nemesis.clj:513-539)."""

    def invoke(self, test, op):
        assert op["f"] == "truncate"
        plan = op["value"]

        def go(t, node):
            spec = plan[node]
            with c.su():
                c.exec_("truncate", "-c", "-s", f"-{spec['drop']}",
                        spec["file"])
        c.on_nodes(test, go, list(plan.keys()))
        out = dict(op)
        out["type"] = "info"
        return out

    def fs(self):
        return {"truncate"}


def truncate_file():
    return TruncateFile()


class ClockScrambler(Nemesis):
    """Randomizes node clocks within a +/- dt-second window
    (nemesis.clj:435-450)."""

    def __init__(self, dt_s):
        self.dt_s = dt_s

    def invoke(self, test, op):
        import time as _time

        def go(t, node):
            offset = random.randint(-self.dt_s, self.dt_s)
            target = int(_time.time()) + offset
            with c.su():
                c.exec_("date", "+%s", "-s", f"@{target}")
            return offset
        out = dict(op)
        out["type"] = "info"
        out["value"] = c.on_nodes(test, go)
        return out

    def teardown(self, test):
        import time as _time

        def go(t, node):
            with c.su():
                c.exec_("date", "+%s", "-s", f"@{int(_time.time())}")
        c.on_nodes(test, go)

    def fs(self):
        return {"scramble-clock"}


def clock_scrambler(dt_s):
    return ClockScrambler(dt_s)
