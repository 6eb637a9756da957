"""Toystore: a real, live distributed register the integration rig can
kill (the port's copy of ``jepsen_tpu/suites/toystore.py``).

The reference proves its control plane against a 5-node docker cluster
(reference docker/README.md:1-27, core_test.clj:122-177 ssh-test). This
environment has no containers and no SSH stack, so the rig runs the
control==node topology instead ({"ssh": {"local?": True}} -> commands
execute on the control host): N "nodes" are N live server processes with
per-node ports/data dirs, deployed, daemonized, killed, paused, and
log-snarfed through the REAL control path (upload, start-stop-daemon,
grepkill, SIGSTOP/SIGCONT) -- the same code an SSH cluster would use,
minus only the wire.

The server (written to ``SERVER_SRC`` and deployed by the DB) is a
primary/follower replicated key-value register over TCP:

* all writes/cas forward to the primary (lowest node id), which
  serializes them under a lock and appends to a recovery log;
* reads forward to the primary too -- linearizable by construction --
  UNLESS the server runs with ``--stale``, where reads return the local
  asynchronously-replicated copy: a REAL consistency bug the checker
  must catch end to end.

Run it yourself::

    python -m jepsen_tpu_torch.suites.toystore test --node n1 --node n2 \\
        --node n3 --time-limit 8
    python -m jepsen_tpu_torch.suites.toystore test --stale ... # must FAIL

The register workloads' linearizability checkers search on ``--device``
(default: CUDA; a run without a card fails before any daemon starts).
The port keeps its own copy of ``SERVER_SRC`` and its own default base
port. ``setup`` clears only a daemon its own node left behind (matched by
the node's scratch path) and refuses a port that another run's process
holds, where the JAX package's rig kills whatever serves the port.
"""

from __future__ import annotations

import os
import random
import socket
import tempfile
import time

import itertools

from .. import checker as cc
from .. import cli
from .. import resolve_device
from .. import client as jclient
from .. import control as c
from .. import db as jdb
from .. import generator as gen
from .. import independent
from .. import nemesis as jnemesis
from .. import os as jos
from .. import tests as tst
from ..checker import checkers as cks
from ..checker import timeline

#: the first node's port (the JAX package's rig starts at 36950)
BASE_PORT = 36980

#: ports bound by fixed numbers beside this rig: the JAX package's
#: default rig (36950 up) and its tests' rigs (37110-37444);
#: ``free_base_port`` keeps clear of them
FIXED_PORTS = range(36950, 37450)

#: stdlib-only server source, deployed to each node by the DB
SERVER_SRC = r'''
import argparse, os, socket, socketserver, threading, time

ap = argparse.ArgumentParser()
ap.add_argument("--port", type=int, required=True)
ap.add_argument("--node-id", type=int, required=True)
ap.add_argument("--peers", default="")   # host:port,... (all nodes, id order)
ap.add_argument("--data-dir", required=True)
ap.add_argument("--stale", action="store_true")
ap.add_argument("--repl-delay", type=float, default=0.0)
args = ap.parse_args()

peers = [p for p in args.peers.split(",") if p]
store, lock = {}, threading.Lock()
log_path = os.path.join(args.data_dir, "toystore.log")
wal_path = os.path.join(args.data_dir, "wal.txt")
is_primary = args.node_id == 0
primary = peers[0] if peers else None

def log(msg):
    with open(log_path, "a") as f:
        f.write(msg + "\n")

# recover from the write-ahead log
if os.path.exists(wal_path):
    with open(wal_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                store[parts[0]] = parts[1]
log("boot node=%d primary=%s stale=%s recovered=%d"
    % (args.node_id, is_primary, args.stale, len(store)))

def wal(k, v):
    with open(wal_path, "a") as f:
        f.write("%s %s\n" % (k, v))
        f.flush()
        os.fsync(f.fileno())

def replicate(k, v):
    for i, hp in enumerate(peers):
        if i == args.node_id:
            continue
        def push(hp=hp):
            try:
                if args.repl_delay:
                    time.sleep(args.repl_delay)
                h, p = hp.rsplit(":", 1)
                with socket.create_connection((h, int(p)), 1) as s:
                    s.sendall(("REPL %s %s\n" % (k, v)).encode())
                    s.recv(16)
            except OSError:
                pass
        threading.Thread(target=push, daemon=True).start()

def forward(line):
    h, p = primary.rsplit(":", 1)
    with socket.create_connection((h, int(p)), 2) as s:
        s.sendall((line + "\n").encode())
        return s.makefile().readline().strip()

def apply_op(parts):
    op = parts[0]
    with lock:
        if op == "W":
            store[parts[1]] = parts[2]
            wal(parts[1], parts[2])
            replicate(parts[1], parts[2])
            return "OK"
        if op == "R":
            return "VAL %s" % store.get(parts[1], "nil")
        if op == "CAS":
            cur = store.get(parts[1], "nil")
            if cur != parts[2]:
                return "FAIL %s" % cur
            store[parts[1]] = parts[3]
            wal(parts[1], parts[3])
            replicate(parts[1], parts[3])
            return "OK"
    return "ERR bad-op"

class H(socketserver.StreamRequestHandler):
    def handle(self):
        line = self.rfile.readline().decode().strip()
        if not line:
            return
        parts = line.split()
        try:
            if parts[0] == "REPL":
                with lock:
                    store[parts[1]] = parts[2]
                out = "OK"
            elif parts[0] == "R" and args.stale and not is_primary:
                # the consistency bug: serve the async local copy
                with lock:
                    out = "VAL %s" % store.get(parts[1], "nil")
            elif is_primary:
                out = apply_op(parts)
            else:
                out = forward(line)
        except OSError as e:
            out = "ERR %s" % e
        self.wfile.write((out + "\n").encode())

class Srv(socketserver.ThreadingTCPServer):
    allow_reuse_address = True

Srv(("127.0.0.1", args.port), H).serve_forever()
'''


def node_id(test, node):
    return test["nodes"].index(node)


def node_port(test, node):
    return test.get("base-port", BASE_PORT) + node_id(test, node)


def free_base_port(count):
    """A base port from which ``count`` consecutive ports are free on
    127.0.0.1 now, for a rig that may share its host with other runs
    (tests, the chip smoke): the kernel picks a free port (a bind to port
    0) and the ports after it are checked by binding them too. The
    command line's ``--base-port`` default stays ``BASE_PORT``."""
    def bindable(port):
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                return False
        return True
    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        ports = range(base, base + count)
        if ports[-1] < 65536 and not set(ports) & set(FIXED_PORTS) \
                and all(bindable(p) for p in ports):
            return base
    raise RuntimeError(f"no {count} consecutive free ports found in 64 "
                       "attempts")


def _port_answers(port):
    """Whether anything accepts a TCP connection on 127.0.0.1:``port``,
    asked on the node as ``await_tcp_port`` asks."""
    res = c.exec_star("bash", "-c", f"exec 3<>/dev/tcp/127.0.0.1/{port}")
    return res.get("exit") == 0


def node_dir(test, node):
    """A node's data directory: under ``scratch-dir``, by default
    ``jepsen-toystore`` in the temporary directory the process was
    given (the JAX package's is /tmp/jepsen-toystore)."""
    scratch = test.get("scratch-dir") or os.path.join(
        tempfile.gettempdir(), "jepsen-toystore")
    return f"{scratch}/{node}"


def peers(test):
    return ",".join(f"127.0.0.1:{node_port(test, n)}"
                    for n in test["nodes"])


class ToystoreDB(jdb.DB, jdb.Process, jdb.Pause, jdb.Primary,
                 jdb.LogFiles):
    """Deploys the server source and manages it with the real daemon
    helpers (start-stop-daemon, grepkill, SIGSTOP/SIGCONT) -- every
    protocol the combined nemesis packages drive (db.clj:11-41)."""

    def _marker(self, test, node):
        # unique argv marker (grepkill takes a quoted extended regex):
        # the deployed script's full path appears in this node's argv
        # and nobody else's
        return f"{node_dir(test, node)}/toystore.py"

    def setup(self, test, node):
        from ..control import util as cu
        # A predecessor run of this scratch dir that died without
        # teardown (crashed test worker, kill -9) can leak a daemon
        # still bound to this node's port, serving stale state: clear
        # this node's own daemon by its path marker, as ``kill`` does.
        # Whatever else still answers on the port belongs to another
        # run (another scratch dir, another checkout) and is not this
        # rig's to kill: refuse to start beside it, since the new
        # daemon would fail to bind and the clients would talk to it.
        cu.grepkill(self._marker(test, node))
        port = node_port(test, node)
        deadline = time.monotonic() + 5
        while _port_answers(port):
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"toystore {node}: port {port} is taken by a process "
                    f"of another run; choose another --base-port")
            time.sleep(0.1)
        d = node_dir(test, node)
        c.exec_("mkdir", "-p", d)
        c.upload_string(SERVER_SRC, f"{d}/toystore.py")
        self.start(test, node)
        cu.await_tcp_port(node_port(test, node), timeout_s=10,
                          host="127.0.0.1")

    def teardown(self, test, node):
        self.kill(test, node)
        c.exec_star("rm", "-rf", node_dir(test, node))

    def start(self, test, node):
        from ..control import util as cu
        d = node_dir(test, node)
        argv = ["--port", str(node_port(test, node)),
                "--node-id", str(node_id(test, node)),
                "--peers", peers(test), "--data-dir", d]
        if test.get("stale"):
            # lag replication so follower reads observably trail the
            # primary (localhost replication is otherwise sub-ms and
            # the staleness rarely lands inside an op window)
            argv += ["--stale", "--repl-delay",
                     str(test.get("repl-delay", 0.3))]
        cu.start_daemon("/usr/bin/env", "python3", f"{d}/toystore.py",
                        *argv, logfile=f"{d}/daemon.out",
                        pidfile=f"{d}/toystore.pid")

    def kill(self, test, node):
        from ..control import util as cu
        cu.stop_daemon(pidfile=f"{node_dir(test, node)}/toystore.pid")
        cu.grepkill(self._marker(test, node))

    def pause(self, test, node):
        from ..control import util as cu
        cu.grepkill(self._marker(test, node), signal="STOP")

    def resume(self, test, node):
        from ..control import util as cu
        cu.grepkill(self._marker(test, node), signal="CONT")

    def primaries(self, test):
        return [test["nodes"][0]]

    def setup_primary(self, test, node):
        pass

    def log_files(self, test, node):
        d = node_dir(test, node)
        return [f"{d}/toystore.log", f"{d}/daemon.out"]


class ToystoreClient(jclient.Client):
    """Line-protocol TCP client against this process's node."""

    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        return ToystoreClient(node)

    def _call(self, test, line, timeout=2.0):
        with socket.create_connection(
                ("127.0.0.1", node_port(test, self.node)),
                timeout) as s:
            s.sendall((line + "\n").encode())
            s.settimeout(timeout)
            return s.makefile().readline().strip()

    def invoke(self, test, op):
        out = dict(op)
        f = op["f"]
        # independent-keys support (tutorial ch 6): a [k v] tuple value
        # addresses key k; plain values use the classic single key "x"
        v = op.get("value")
        if independent.is_tuple(v):
            key, payload = v.key, v.value
        else:
            key, payload = "x", v
        try:
            if f == "read":
                resp = self._call(test, f"R {key}")
                if resp.startswith("VAL"):
                    rv = resp.split()[1]
                    rv = None if rv == "nil" else int(rv)
                    out.update(type="ok",
                               value=independent.tuple_(key, rv)
                               if independent.is_tuple(v) else rv)
                else:
                    out.update(type="fail", error=resp)
            elif f == "write":
                resp = self._call(test, f"W {key} {payload}")
                out["type"] = "ok" if resp == "OK" else "info"
                if resp != "OK":
                    out["error"] = resp
            else:
                old, new = payload
                resp = self._call(
                    test,
                    f"CAS {key} {'nil' if old is None else old} {new}")
                if resp == "OK":
                    out["type"] = "ok"
                elif resp.startswith("FAIL"):
                    out["type"] = "fail"
                else:
                    out.update(type="info", error=resp)
        except OSError as e:
            # connection refused/timeout: reads definitely didn't
            # happen (idempotent -> safe to FAIL, keeping checker
            # concurrency down -- tutorial ch 6); writes are
            # indeterminate and must crash as info
            out.update(type="fail" if f == "read" else "info",
                       error=repr(e))
        return out


class ToystoreSetClient(ToystoreClient):
    """A grow-only set stored as a comma-joined string under one key,
    added to with a read/CAS read-modify-write loop (the reference
    tutorial's ``swap!`` pattern, doc/tutorial/08-set.md:209-228)."""

    KEY = "s"

    def open(self, test, node):
        return ToystoreSetClient(node)

    def invoke(self, test, op):
        out = dict(op)
        try:
            if op["f"] == "read":
                resp = self._call(test, f"R {self.KEY}")
                if not resp.startswith("VAL"):
                    out.update(type="fail", error=resp)
                    return out
                tok = resp.split()[1]
                out.update(type="ok",
                           value=[] if tok == "nil"
                           else [int(x) for x in tok.split(",")])
                return out
            # add: read-modify-CAS until this writer wins the race; a
            # spent contention budget is a clean FAIL (nothing acked)
            v = op["value"]
            for _ in range(16):
                resp = self._call(test, f"R {self.KEY}")
                if not resp.startswith("VAL"):
                    out.update(type="fail", error=resp)
                    return out
                cur = resp.split()[1]
                new = str(v) if cur == "nil" else f"{cur},{v}"
                resp = self._call(test, f"CAS {self.KEY} {cur} {new}")
                if resp == "OK":
                    out["type"] = "ok"
                    return out
                if not resp.startswith("FAIL"):
                    out.update(type="info", error=resp)
                    return out
            out.update(type="fail", error="cas-contention")
        except OSError as e:
            out.update(type="fail" if op["f"] == "read" else "info",
                       error=repr(e))
        return out


def r(test, ctx):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, ctx):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def cas(test, ctx):
    return {"type": "invoke", "f": "cas",
            "value": [random.randint(0, 4), random.randint(0, 4)]}


# -- workloads (tutorial chapters 6-8; reference doc/tutorial/08-set.md
# workload maps + etcdemo's register rewrite) --------------------------------

def _register_checker(opts):
    """The composed per-register checker both register workloads
    share (linearizable gate + timeline)."""
    return cc.compose({
        "linear": cks.linearizable(
            {"model": "cas-register",
             "algorithm": opts.get("algorithm", "competition"),
             "engine_opts": {"device": opts.get("device")}}),
        "timeline": timeline.html(),
    })


def register_workload(opts):
    """Single linearizable register on key "x": the tutorial's chapters
    1-5 workload, as a {client, checker, generator, final_generator}
    map."""
    rate = float(opts.get("rate", 20))
    return {
        "client": ToystoreClient(),
        "checker": _register_checker(opts),
        "generator": gen.stagger(1.0 / rate, gen.mix([r, w, cas])),
        "final_generator": None,
    }


#: threads per key for the independent-keys register workload; the
#: test's concurrency must be a multiple of this
INDEP_GROUP = 2


def register_indep_workload(opts):
    """The chapter-6 lift: the same register test over MANY independent
    keys via concurrent_generator; per-key subhistories are decided as
    one batched device call when the algorithm is jax-wgl (or batch)."""
    rate = float(opts.get("rate", 20))
    per_key = int(opts.get("ops-per-key", 30))
    return {
        "client": ToystoreClient(),
        "checker": independent.checker(_register_checker(opts)),
        "generator": independent.concurrent_generator(
            INDEP_GROUP, itertools.count(),
            lambda k: gen.limit(per_key, gen.stagger(
                1.0 / rate, gen.mix([r, w, cas])))),
        "final_generator": None,
    }


def set_workload(opts):
    """Grow-only set: unique adds during faults, then heal and read
    everything back once per thread (reference doc/tutorial/08-set.md;
    checker.clj:240-291)."""
    rate = float(opts.get("rate", 20))
    counter = itertools.count(1)

    def add(test, ctx):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    return {
        "client": ToystoreSetClient(),
        "checker": cks.set_checker(),
        "generator": gen.stagger(1.0 / rate, add),
        "final_generator": gen.each_thread(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


WORKLOADS = {
    "register": register_workload,
    "register-indep": register_indep_workload,
    "set": set_workload,
}


def toystore_test(opts):
    test = dict(tst.noop_test())
    test.update(opts)
    nemesis_mode = opts.get("nemesis-mode", "kill")
    if nemesis_mode == "kill":
        nem = jnemesis.node_start_stopper(
            lambda test_, nodes: [random.choice(nodes)],
            lambda test_, node: ToystoreDB().kill(test_, node),
            lambda test_, node: ToystoreDB().start(test_, node))
    elif nemesis_mode == "pause":
        nem = jnemesis.node_start_stopper(
            lambda test_, nodes: [random.choice(nodes)],
            lambda test_, node: ToystoreDB().pause(test_, node),
            lambda test_, node: ToystoreDB().resume(test_, node))
    else:
        nem = jnemesis.noop
    wname = opts.get("workload", "register")
    if wname != "set":
        # no card, no run: fail here, before any daemon starts, not in
        # the contained checker
        resolve_device(opts.get("device"))
    if wname == "register-indep":
        # concurrent_generator groups INDEP_GROUP threads per key and
        # asserts the thread count divides evenly; the generic "1n"
        # default (3 nodes -> 3 threads) would crash it out of the
        # box, so round up to the next multiple
        conc = int(opts.get("concurrency") or 2 * INDEP_GROUP)
        conc += -conc % INDEP_GROUP
        test["concurrency"] = max(conc, INDEP_GROUP)
    workload = WORKLOADS[wname](opts)
    nem_gen = (None if nemesis_mode == "none" else
               gen.cycle(gen.sleep(2),
                         {"type": "info", "f": "start"},
                         gen.sleep(2),
                         {"type": "info", "f": "stop"}))
    main = gen.time_limit(
        opts.get("time-limit", 8),
        gen.nemesis(nem_gen, workload["generator"]))
    if workload.get("final_generator") is not None:
        # the chapter-8 shape: run the workload under faults, heal,
        # wait for recovery, THEN run the final reads -- a final read
        # racing the last adds (or a dead node) would misclassify
        # in-flight elements as lost
        generator = gen.phases(
            main,
            gen.log("healing cluster"),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.log("waiting for recovery"),
            gen.sleep(float(opts.get("recovery-time", 1))),
            gen.clients(workload["final_generator"]))
    else:
        generator = main
    test.update({
        # the parameters that change the test's MEANING go in its name
        # (reference doc/tutorial/07-parameters.md: "etcd q=true set")
        "name": ("toystore" if wname == "register"
                 else f"toystore-{wname}")
                + (" stale" if opts.get("stale") else ""),
        "ssh": {"local?": True},
        "os": jos.noop,
        "db": ToystoreDB(),
        "client": workload["client"],
        "nemesis": nem,
        "generator": generator,
        "checker": workload["checker"],
    })
    return test


def _opt_spec(parser):
    parser.add_argument("--workload", default="register",
                        choices=sorted(WORKLOADS))
    parser.add_argument("--algorithm", default="competition")
    parser.add_argument("--stale", action="store_true",
                        help="serve follower reads from the async local "
                             "copy (a real linearizability bug)")
    parser.add_argument("--nemesis-mode", default="kill",
                        choices=["kill", "pause", "none"])
    parser.add_argument("--rate", type=float, default=20,
                        help="approximate requests per second per "
                             "thread")
    parser.add_argument("--ops-per-key", type=int, default=30,
                        help="per-key op budget for register-indep")
    parser.add_argument("--recovery-time", type=float, default=1)
    parser.add_argument("--base-port", type=int, default=BASE_PORT)


def main(argv=None):
    cmds = {}
    cmds.update(cli.single_test_cmd({"test-fn": toystore_test,
                                     "opt-spec": _opt_spec}))
    cmds.update(cli.serve_cmd())
    cli.run(cmds, argv)


if __name__ == "__main__":
    cli.hard_main(main)
