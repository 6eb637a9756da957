"""Clock-skew nemesis: compile-on-node C shims + fault ops + generators
(reference jepsen/src/jepsen/nemesis/time.clj, 205 LoC, plus
resources/bump-time.c and strobe-time.c).

The two C programs live in ``jepsen_tpu_torch/resources/`` (the port's
own copies, byte for byte the JAX package's) and are uploaded and
compiled with gcc on each db node at setup time, exactly like the
reference (time.clj:20-61). Ops:

    {"f": "reset",         "value": [node, ...]}
    {"f": "bump",          "value": {node: delta_ms, ...}}
    {"f": "strobe",        "value": {node: {"delta": ms, "period": ms,
                                            "duration": s}, ...}}
    {"f": "check-offsets"}

Every completion carries ``clock_offsets``: node -> offset from the
control node's wall clock in seconds (time.clj:120-143)."""

from __future__ import annotations

import math
import os
import random
import time as _time

from . import Nemesis
from .. import control as c
from ..control import util as cu
from ..util import rand_nth, random_nonempty_subset

DIR = "/opt/jepsen"

_RESOURCE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "resources")


def compile_c(source_path, bin_name):
    """Uploads a C source file and gcc-compiles it to DIR/<bin_name> on
    the current node, if not already present (time.clj:20-39)."""
    with c.su():
        if cu.exists(f"{DIR}/{bin_name}"):
            return bin_name
        c.exec_("mkdir", "-p", DIR)
        c.exec_("chmod", "a+rwx", DIR)
        c.upload([source_path], f"{DIR}/{bin_name}.c")
        with c.cd(DIR):
            c.exec_("gcc", "-O2", "-o", bin_name, f"{bin_name}.c")
    return bin_name


def compile_tools():
    compile_c(os.path.join(_RESOURCE_DIR, "strobe-time.c"), "strobe-time")
    compile_c(os.path.join(_RESOURCE_DIR, "bump-time.c"), "bump-time")


def install():
    """Uploads + compiles the clock shims, installing gcc via the node's
    package manager if the first attempt fails (time.clj:52-61)."""
    try:
        compile_tools()
    except Exception:  # noqa: BLE001 - mirror the reference's retry
        try:
            from ..os import debian
            debian.install(["build-essential"])
        except Exception:  # noqa: BLE001
            from ..os import centos
            centos.install(["gcc"])
        compile_tools()


def parse_time(s) -> float:
    """Decimal unix-epoch seconds, as printed by `date +%s.%N` or the
    bump-time shim."""
    return float(str(s).strip())


def clock_offset(remote_time: float) -> float:
    """Offset of a remote wall-clock reading from the control node's
    clock, in seconds (time.clj:69-73)."""
    return remote_time - _time.time()


def current_offset() -> float:
    """Clock offset of the current node, in seconds."""
    return clock_offset(parse_time(c.exec_("date", "+%s.%N")))


def reset_time(test=None):
    """ntpdate the local node back to true time; with a test, resets every
    node (time.clj:80-84)."""
    if test is None:
        with c.su():
            c.exec_("ntpdate", "-p", "1", "-b", "time.google.com")
    else:
        c.with_test_nodes(test, reset_time)


def bump_time(delta_ms) -> float:
    """One-shot clock jump by delta_ms; returns the node's resulting
    offset in seconds (time.clj:86-90)."""
    with c.su():
        return clock_offset(parse_time(
            c.exec_(f"{DIR}/bump-time", str(delta_ms))))


def strobe_time(delta_ms, period_ms, duration_s):
    """Oscillate the clock +/- delta_ms every period_ms for duration_s
    (time.clj:92-96)."""
    with c.su():
        c.exec_(f"{DIR}/strobe-time", str(delta_ms), str(period_ms),
                str(duration_s))


class ClockNemesis(Nemesis):
    """Clock manipulation nemesis (time.clj:98-146)."""

    def setup(self, test):
        def prep():
            install()
            try:
                with c.su():
                    c.exec_("service", "ntpd", "stop")
            except Exception:  # noqa: BLE001 - ntpd may not exist
                pass
            reset_time()
        c.with_test_nodes(test, prep)
        return self

    def invoke(self, test, op):
        f, v = op.get("f"), op.get("value")
        if f == "reset":
            res = c.on_nodes(
                test, lambda t, n: (reset_time(), current_offset())[1], v)
        elif f == "check-offsets":
            res = c.on_nodes(test, lambda t, n: current_offset())
        elif f == "strobe":
            def go(t, node):
                spec = v[node]
                strobe_time(spec["delta"], spec["period"], spec["duration"])
                return current_offset()
            res = c.on_nodes(test, go, list(v))
        elif f == "bump":
            res = c.on_nodes(test, lambda t, n: bump_time(v[n]), list(v))
        else:
            raise ValueError(f"unknown clock op {f!r}")
        out = dict(op)
        out["clock_offsets"] = res
        return out

    def teardown(self, test):
        reset_time(test)

    def fs(self):
        return {"reset", "bump", "strobe", "check-offsets"}


def clock_nemesis():
    return ClockNemesis()


def reset_gen_select(select):
    """Reset generator over a node subset chosen by select(test)
    (time.clj:148-154)."""
    def gen(test, ctx):
        return {"type": "info", "f": "reset", "value": select(test)}
    return gen


def _random_nodes(test):
    return random_nonempty_subset(test["nodes"])


reset_gen = reset_gen_select(_random_nodes)


def _exp_delta_ms(rng=random):
    """+/- 2^2..2^18 ms, exponentially distributed (time.clj:161-173)."""
    return int(rand_nth([-1, 1], rng) * math.pow(2, 2 + rng.random() * 16))


def bump_gen_select(select, rng=random):
    def gen(test, ctx):
        return {"type": "info", "f": "bump",
                "value": {n: _exp_delta_ms(rng) for n in select(test)}}
    return gen


bump_gen = bump_gen_select(_random_nodes)


def strobe_gen_select(select, rng=random):
    """Strobes of 4 ms..262 s delta, 1 ms..1 s period, 0-32 s duration
    (time.clj:179-192). ``rng`` is injectable like the other clock
    generators, so strobe schedules seed consistently."""
    def gen(test, ctx):
        return {"type": "info", "f": "strobe",
                "value": {n: {"delta": int(math.pow(2,
                                                    2 + rng.random() * 16)),
                              "period": int(math.pow(2,
                                                     rng.random() * 10)),
                              "duration": rng.random() * 32}
                          for n in select(test)}}
    return gen


strobe_gen = strobe_gen_select(_random_nodes)


def clock_gen():
    """Random schedule of clock faults, starting with a check-offsets to
    establish an initial bound (time.clj:199-205)."""
    from .. import generator as gen
    return gen.phases({"type": "info", "f": "check-offsets"},
                      gen.mix([reset_gen, bump_gen, strobe_gen]))
