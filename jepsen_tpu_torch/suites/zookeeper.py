"""ZooKeeper test suite: the minimal single-file consumer (reference
zookeeper/src/jepsen/zookeeper.clj, 137 LoC — the tutorial's target).

A single compare-and-set register held in a znode, driven over the
actual client wire protocol (suites/zk_proto.py -- no Python client
dependency and no shell scraping), a random-halves partitioner, and the
device linearizability checker (the port's copy of
``jepsen_tpu/suites/zookeeper.py``)::

    python -m jepsen_tpu_torch.suites.zookeeper test \\
        --node n1 --node n2 --node n3 --time-limit 15

``--stub`` runs the whole pipeline against an in-memory register. The
linearizability checker searches on ``--device`` (default: CUDA; a run
without a card fails before it starts)."""

from __future__ import annotations

import random
import threading

from .. import checker as cc
from .. import cli
from .. import resolve_device
from .. import client as jclient
from .. import control as c
from .. import db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import os as jos
from .. import tests as tst
from ..checker import checkers as cks
from ..checker import perf as cperf
from ..checker import timeline
from ..os import debian
from . import zk_proto

VERSION = "3.6.3"


def zk_node_ids(test) -> dict:
    """node name -> myid (zookeeper.clj:19-30)."""
    return {node: i for i, node in enumerate(test["nodes"])}


def zoo_cfg_servers(test) -> str:
    """server.N lines for zoo.cfg (zookeeper.clj:32-38)."""
    return "\n".join(f"server.{i}={node}:2888:3888"
                     for node, i in zk_node_ids(test).items())


ZOO_CFG = """tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
"""


DIR = "/opt/zookeeper"


class ZkDB(jdb.DB, jdb.LogFiles):
    """Installs ZooKeeper from the release tarball and (re)configures
    the ensemble (zookeeper.clj:40-72 uses the 3.4 distro package)."""

    def __init__(self, version=VERSION):
        self.version = version

    def setup(self, test, node):
        from ..control import util as cu
        with c.su():
            debian.install(["default-jre-headless"])
            cu.install_archive(
                f"https://archive.apache.org/dist/zookeeper/"
                f"zookeeper-{self.version}/"
                f"apache-zookeeper-{self.version}-bin.tar.gz", DIR)
            c.exec_("mkdir", "-p", "/var/lib/zookeeper")
            c.upload_string(str(zk_node_ids(test)[node]),
                            "/var/lib/zookeeper/myid")
            c.upload_string(ZOO_CFG + "\n" + zoo_cfg_servers(test),
                            f"{DIR}/conf/zoo.cfg")
            c.exec_(f"{DIR}/bin/zkServer.sh", "restart")

    def teardown(self, test, node):
        with c.su():
            c.exec_star(f"{DIR}/bin/zkServer.sh", "stop")
            c.exec_star("rm", "-rf", "/var/lib/zookeeper/version-2",
                        f"{DIR}/logs")

    def log_files(self, test, node):
        return [f"{DIR}/logs/zookeeper.log"]


# generators (zookeeper.clj:74-76)

def r(test, ctx):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, ctx):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def cas(test, ctx):
    return {"type": "invoke", "f": "cas",
            "value": [random.randint(0, 4), random.randint(0, 4)]}


class ZkClient(jclient.Client):
    """CAS register in the /jepsen znode over the actual client wire
    protocol (suites/zk_proto.py): getData/setData with real version
    numbers, CAS = SetData-with-expected-version answered by BadVersion
    (-103). Replaces round 2's zkCli.sh screen-scraping, which depended
    on one zkCli version's output grammar (zookeeper.clj:78-104 uses
    avout; the wire client keeps this suite dependency-free without
    parsing shell output)."""

    PATH = "/jepsen"

    def __init__(self, node=None, port=2181):
        self.node = node
        self.port = port
        self.conn = None

    def open(self, test, node):
        return ZkClient(node, test.get("zk-port", 2181))

    def _session(self):
        if self.conn is None:
            self.conn = zk_proto.ZkWireClient(self.node, self.port,
                                              timeout_s=5.0)
        return self.conn

    def close(self, test):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def setup(self, test):
        try:
            self._session().create(self.PATH, b"0")
        except zk_proto.ZkError as e:
            if e.code != zk_proto.NODE_EXISTS:
                raise

    def _get(self):
        data, stat = self._session().get_data(self.PATH)
        return int(data.decode()), stat["version"]

    def invoke(self, test, op):
        out_op = dict(op)
        try:
            if op["f"] == "read":
                value, _ = self._get()
                out_op.update(type="ok", value=value)
            elif op["f"] == "write":
                self._session().set_data(self.PATH,
                                         str(op["value"]).encode())
                out_op["type"] = "ok"
            else:
                old, new = op["value"]
                value, version = self._get()
                if value != old:
                    out_op["type"] = "fail"
                else:
                    try:
                        self._session().set_data(
                            self.PATH, str(new).encode(),
                            version=version)
                        out_op["type"] = "ok"
                    except zk_proto.ZkError as e:
                        if e.code != zk_proto.BAD_VERSION:
                            raise
                        # another writer interleaved: a clean loss
                        out_op["type"] = "fail"
        except (zk_proto.ZkError, OSError) as e:
            # drop the session: reconnect on the next op
            self.close(test)
            out_op.update(
                type=("fail" if op["f"] == "read" else "info"),
                error=repr(e))
        return out_op


class StubClient(jclient.Client):
    """Shared in-memory register for --stub runs."""

    def __init__(self, box=None, lock=None):
        self.box = box if box is not None else {"v": 0}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return StubClient(self.box, self.lock)

    def invoke(self, test, op):
        out = dict(op)
        with self.lock:
            if op["f"] == "read":
                out.update(type="ok", value=self.box["v"])
            elif op["f"] == "write":
                self.box["v"] = op["value"]
                out["type"] = "ok"
            else:
                old, new = op["value"]
                if self.box["v"] == old:
                    self.box["v"] = new
                    out["type"] = "ok"
                else:
                    out["type"] = "fail"
        return out


def zk_test(opts):
    """Options map -> test map (zookeeper.clj:106-129)."""
    # no card, no run: fail here, not in the contained checker
    resolve_device(opts.get("device"))
    stub = opts.get("stub")
    test = dict(tst.noop_test())
    test.update(opts)
    test.update({
        "name": "zookeeper",
        "os": jos.noop if stub else debian.os,
        "db": jdb.noop if stub else ZkDB(opts.get("version", VERSION)),
        "client": StubClient() if stub else ZkClient(),
        "nemesis": jnemesis.partition_random_halves(),
        "generator": gen.time_limit(
            opts.get("time-limit", 15),
            gen.nemesis(
                gen.cycle(gen.sleep(5),
                          {"type": "info", "f": "start"},
                          gen.sleep(5),
                          {"type": "info", "f": "stop"}),
                gen.stagger(1, gen.mix([r, w, cas])))),
        # perf + linearizable, like the reference (zookeeper.clj:127-129;
        # no stats: sparse histories legitimately have zero ok cas ops)
        "checker": cc.compose({
            # the register starts at 0 (the znode is created with "0"):
            # the reference's (model/cas-register 0)
            "linear": cks.linearizable(
                {"model": "cas-register",
                 "algorithm": opts.get("algorithm", "competition"),
                 "init-ops": [{"f": "write", "value": 0}],
                 "engine_opts": {"device": opts.get("device")}}),
            "perf": cperf.perf(),
            "timeline": timeline.html(),
        }),
    })
    if stub:
        test["ssh"] = {"dummy?": True}
    return test


def _opt_spec(parser):
    parser.add_argument("--version", default=VERSION)
    parser.add_argument("--algorithm", default="competition")
    parser.add_argument("--stub", action="store_true",
                        help="in-memory register + dummy remote")


def main(argv=None):
    cmds = {}
    cmds.update(cli.single_test_cmd({"test-fn": zk_test,
                                     "opt-spec": _opt_spec}))
    cmds.update(cli.serve_cmd())
    cli.run(cmds, argv)


if __name__ == "__main__":
    cli.hard_main(main)
