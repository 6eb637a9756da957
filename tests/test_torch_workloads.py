"""The register workload (``tests/linearizable_register.py``) end to end
through the port's ``core.run``: the keyed atom client, the independent
generator and checker, the key batch on the CPU
(``engine_opts={"device": "cpu"}``), the timeline and the per-key store
files. The sizes are at or below the JAX package's
``tests/test_workloads.py`` (2 nodes, per-key-limit 12, 3 s): the
valid run takes 1.5 s of ops, whose keys the CPU search checks."""

import os
import threading
import time

import pytest

from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch import store
from jepsen_tpu_torch import tests as tst
from jepsen_tpu_torch.tests import linearizable_register

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))


class KeyedRegisterClient(jclient.Client):
    """A per-key CAS register over a shared dict: the client the register
    workload expects (linearizable_register.clj:1-12)."""

    def __init__(self, registers=None, lock=None):
        self.registers = registers if registers is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return type(self)(self.registers, self.lock)

    def apply(self, op, k, v):
        out = dict(op)
        with self.lock:
            if op["f"] == "write":
                self.registers[k] = v
                out["type"] = "ok"
            elif op["f"] == "read":
                out["type"] = "ok"
                out["value"] = independent.tuple_(k, self.registers.get(k))
            elif op["f"] == "cas":
                cur, new = v
                if self.registers.get(k) == cur:
                    self.registers[k] = new
                    out["type"] = "ok"
                else:
                    out["type"] = "fail"
        return out

    def invoke(self, test, op):
        k, v = op["value"]
        return self.apply(op, k, v)


class LostWriteClient(KeyedRegisterClient):
    """Drops every write after a key's first yet answers ok, and reads
    only after a 1 ms pause: a read that starts after a dropped write has
    completed still returns the key's first value."""

    def invoke(self, test, op):
        k, v = op["value"]
        if op["f"] == "read":
            time.sleep(0.001)
        elif op["f"] == "write" and k in self.registers:
            return dict(op, type="ok")
        return self.apply(op, k, v)


def _run(name, client, nodes, limit_s, per_key):
    workload = linearizable_register.test({
        "nodes": nodes, "algorithm": "jax-wgl", "per-key-limit": per_key,
        "engine_opts": CPU})
    t = tst.noop_test()
    t.update({
        "name": name,
        "ssh": {"dummy?": True},
        "client": client,
        "nodes": nodes,
        "concurrency": 2 * len(nodes),   # 2n per key: one group
        "generator": gen.time_limit(limit_s, workload["generator"]),
        "checker": workload["checker"],
    })
    return core.run(t)


def test_linearizable_register_end_to_end():
    """Every key valid; the per-key results and history land in the
    store under independent/<key>/."""
    test = _run("lin-register", KeyedRegisterClient(), ["n1", "n2"], 1.5,
                12)
    r = test["results"]
    assert r["valid"] is True, r
    assert "error" not in r
    assert len(r["results"]) >= 2
    for k, kr in r["results"].items():
        assert kr["valid"] is True, (k, kr)
        assert kr["linearizable"]["valid"] is True
        assert kr["timeline"]["valid"] is True
    d = store.path(test, independent.DIR)
    assert sorted(os.listdir(d)) == sorted(str(k) for k in r["results"])
    for k in r["results"]:
        for f in ("results.json", "history.txt"):
            assert os.path.exists(os.path.join(d, str(k), f)), (k, f)
    assert os.path.exists(store.path(test, "results.json"))


def test_linearizable_register_catches_lost_writes():
    """A client that drops writes yet answers ok: the run is invalid."""
    test = _run("lin-register-lost", LostWriteClient(), ["n1"], 1.0, 8)
    r = test["results"]
    assert r["valid"] is False
    assert r["failures"]
    assert "error" not in r
