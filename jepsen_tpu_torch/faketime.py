"""libfaketime wrappers: run DB binaries under divergent clock *rates*
(reference jepsen/src/jepsen/faketime.clj, 66 LoC)."""

from __future__ import annotations

import random

from . import control as c
from .control import util as cu


def install():
    """Builds the jepsen libfaketime fork on the node (faketime.clj:8-22;
    pinned to the 0.9.6-jepsen1 branch that restores jemalloc compat and
    adds COARSE clock support)."""
    with c.su():
        c.exec_("mkdir", "-p", "/tmp/jepsen")
        with c.cd("/tmp/jepsen"):
            if not cu.exists("libfaketime-jepsen"):
                c.exec_("git", "clone",
                        "https://github.com/jepsen-io/libfaketime.git",
                        "libfaketime-jepsen")
            with c.cd("libfaketime-jepsen"):
                c.exec_("git", "checkout", "0.9.6-jepsen1")
                c.exec_("make")
                c.exec_("make", "install")


def script(cmd: str, init_offset: float, rate: float) -> str:
    """A shell wrapper invoking cmd under faketime with an initial offset
    (seconds) and a clock rate (faketime.clj:24-34)."""
    off = int(init_offset)
    sign = "-" if off < 0 else "+"
    return ("#!/bin/bash\n"
            f'faketime -m -f "{sign}{abs(off)}s x{float(rate)}" '
            f'{cmd} "$@"')


def wrap(cmd: str, init_offset: float, rate: float):
    """Replace an executable with a faketime wrapper, keeping the
    original at cmd.no-faketime; idempotent (faketime.clj:36-47)."""
    orig = f"{cmd}.no-faketime"
    wrapper = script(orig, init_offset, rate)
    if not cu.exists(orig):
        c.exec_("mv", cmd, orig)
    c.upload_string(wrapper, cmd)
    c.exec_("chmod", "a+x", cmd)


def unwrap(cmd: str):
    """Restore the original binary if a wrapper is installed
    (faketime.clj:49-55)."""
    orig = f"{cmd}.no-faketime"
    if cu.exists(orig):
        c.exec_("mv", orig, cmd)


def rand_factor(factor: float, rng=random) -> float:
    """A clock rate near 1 such that max/min across draws <= factor
    (faketime.clj:57-65)."""
    mx = 2 / (1 + 1 / factor)
    mn = mx / factor
    return mn + rng.random() * (mx - mn)
