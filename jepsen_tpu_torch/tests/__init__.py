"""Utilities for writing tests: the noop test scaffold and in-memory
DB/clients used by the integration tests (reference
jepsen/src/jepsen/tests.clj).

Workload submodules live alongside, mirroring the reference's
jepsen.tests.* namespaces: `.linearizable_register`, `.bank`,
`.long_fork`, `.causal`, `.causal_reverse`, `.adya` and `.cycle`.
"""

from __future__ import annotations

import threading
import time

from .. import checker as jchecker
from .. import client as jclient
from .. import db as jdb
from .. import nemesis as jnemesis
from .. import net as jnet
from ..os import noop as os_noop


def noop_test():
    """Boring test stub, a basis for more complex tests (tests.clj:12-25)."""
    return {
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "name": "noop",
        "os": os_noop,
        "db": jdb.noop,
        "net": jnet.iptables,
        "client": jclient.noop,
        "nemesis": jnemesis.noop,
        "generator": None,
        "checker": jchecker.unbridled_optimism(),
    }


class AtomDB(jdb.DB):
    """Wraps a shared boxed value as a database (tests.clj:27-32)."""

    def __init__(self, state):
        self.state = state

    def setup(self, test, node):
        self.state.reset(0)

    def teardown(self, test, node):
        self.state.reset("done")


def atom_db(state):
    return AtomDB(state)


class Atom:
    """A thread-safe mutable box with compare-and-swap (clojure atom)."""

    def __init__(self, value=None):
        self._value = value
        self._lock = threading.Lock()

    def deref(self):
        with self._lock:
            return self._value

    def reset(self, value):
        with self._lock:
            self._value = value
            return value

    def swap(self, f, *args):
        with self._lock:
            self._value = f(self._value, *args)
            return self._value

    def compare_and_set(self, old, new):
        with self._lock:
            if self._value == old:
                self._value = new
                return True
            return False

    def conj(self, item):
        return self.swap(lambda v: (v or []) + [item])


class AtomClient(jclient.Client):
    """A CAS register client over a shared Atom (tests.clj:34-67); the
    meta_log records lifecycle calls for integration assertions."""

    def __init__(self, state, meta_log=None):
        self.state = state
        self.meta_log = meta_log if meta_log is not None else Atom([])

    def open(self, test, node):
        self.meta_log.conj("open")
        return AtomClient(self.state, self.meta_log)

    def setup(self, test):
        self.meta_log.conj("setup")

    def teardown(self, test):
        self.meta_log.conj("teardown")

    def close(self, test):
        self.meta_log.conj("close")

    def invoke(self, test, op):
        # sleep to make sure we actually have some concurrency
        # (tests.clj:50-51)
        time.sleep(0.001)
        out = dict(op)
        f = op["f"]
        if f == "write":
            self.state.reset(op["value"])
            out["type"] = "ok"
        elif f == "cas":
            cur, new = op["value"]
            out["type"] = "ok" if self.state.compare_and_set(cur, new) \
                else "fail"
        elif f == "read":
            out["type"] = "ok"
            out["value"] = self.state.deref()
        else:
            raise ValueError(f"unknown f {f!r}")
        return out


def atom_client(state, meta_log=None):
    return AtomClient(state, meta_log)
