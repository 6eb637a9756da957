"""Causal-consistency workload: a causally-ordered chain of reads and
writes against a register, with explicit position/link metadata
(reference jepsen/src/jepsen/tests/causal.clj, 131 LoC; the port's copy
of ``jepsen_tpu/tests/causal.py``). Host-only.

Ops carry ``position`` (this op's place in the causal order) and
``link`` (the position it causally follows — "init" for the first)."""

from __future__ import annotations

import itertools

from .. import generator as gen
from .. import independent
from ..checker.core import Checker
from ..history import ok as is_ok


class Inconsistent:
    """Invalid model termination (causal.clj:15-31)."""

    def __init__(self, msg):
        self.msg = msg

    def step(self, op):
        return self

    def __str__(self):
        return self.msg


def inconsistent(msg):
    return Inconsistent(msg)


def is_inconsistent(model) -> bool:
    return isinstance(model, Inconsistent)


class CausalRegister:
    """Register whose writes must follow the causal chain: each op links
    to the last-seen position, writes must produce the next counter value
    (causal.clj:34-86)."""

    def __init__(self, value=0, counter=0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op):
        c = self.counter + 1
        v = op.get("value")
        pos = op.get("position")
        link = op.get("link")
        if link != "init" and link != self.last_pos:
            return inconsistent(
                f"Cannot link {link!r} to last-seen position "
                f"{self.last_pos!r}")
        f = op.get("f")
        if f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return inconsistent(
                f"expected value {c} attempting to write {v} instead")
        if f == "read-init":
            if self.counter == 0 and v not in (0, None):
                return inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        if f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        return inconsistent(f"unknown f {f!r}")

    def __str__(self):
        return repr(self.value)


def causal_register():
    return CausalRegister()


class _CausalChecker(Checker):
    """Folds the model over ok ops in history order
    (causal.clj:88-112)."""

    def __init__(self, model):
        self.model = model

    def check(self, test, history, opts=None):
        s = self.model
        for op in history:
            if not is_ok(op):
                continue
            s = s.step(op)
            if is_inconsistent(s):
                return {"valid": False, "valid?": False, "error": s.msg}
        return {"valid": True, "valid?": True, "model": str(s)}


def check(model):
    return _CausalChecker(model)


# generators (causal.clj:114-118)

def r(test, ctx):
    return {"type": "invoke", "f": "read"}


def ri(test, ctx):
    return {"type": "invoke", "f": "read-init"}


def cw1(test, ctx):
    return {"type": "invoke", "f": "write", "value": 1}


def cw2(test, ctx):
    return {"type": "invoke", "f": "write", "value": 2}


def test(opts):
    """Independent causal chains (ri w1 r w2 r) per key, staggered, with
    a start/stop nemesis cycle (causal.clj:120-133)."""
    return {
        "checker": independent.checker(check(causal_register())),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.nemesis(
                gen.cycle(gen.sleep(10),
                          {"type": "info", "f": "start"},
                          gen.sleep(10),
                          {"type": "info", "f": "stop"}),
                gen.stagger(
                    1, independent.concurrent_generator(
                        1, itertools.count(),
                        lambda k: [gen.once(ri), gen.once(cw1),
                                   gen.once(r), gen.once(cw2),
                                   gen.once(r)])))),
    }
