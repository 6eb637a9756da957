"""Control DSL: run commands on db nodes within a dynamic scope (reference
jepsen/src/jepsen/control.clj).

The reference binds *host*/*session*/*sudo*/*dir* dynamic vars
(control.clj:40-53); here a contextvars-based scope plays that role (safe
across the thread-per-node fan-out of on_nodes). Usage:

    with ssh_scope(test):                 # opens pooled sessions
        def setup(test, node):
            with su():
                exec_("apt-get", "install", "-y", "foo")
        on_nodes(test, setup)
"""

from __future__ import annotations

import contextlib
import contextvars
import logging

from .. import obs
from ..util import real_pmap
from .core import (Lit, Remote, RemoteExecError, escape, lit,  # noqa: F401
                   throw_on_nonzero_exit)
from .remotes import (DockerRemote, DummyRemote, K8sRemote,  # noqa: F401
                      LocalRemote, RetryRemote, SSHRemote)

logger = logging.getLogger(__name__)

_host = contextvars.ContextVar("host", default=None)
_session = contextvars.ContextVar("session", default=None)
_sudo = contextvars.ContextVar("sudo", default=None)
_dir = contextvars.ContextVar("dir", default=None)
_env = contextvars.ContextVar("env", default=None)
_trace = contextvars.ContextVar("trace", default=False)
_conn_specs = contextvars.ContextVar("conn_specs", default=None)
_sessions = contextvars.ContextVar("sessions", default=None)


def host():
    return _host.get()


def session():
    return _session.get()


@contextlib.contextmanager
def _bind(var, value):
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


def su(user="root"):
    """Sudo scope (control.clj su)."""
    return _bind(_sudo, user)


def cd(path):
    """Working-directory scope (control.clj cd)."""
    return _bind(_dir, path)


def with_env(env):
    return _bind(_env, env)


def with_trace():
    """Log every remote command (control.clj:220-224)."""
    return _bind(_trace, True)


def _ctx():
    return {"dir": _dir.get(), "sudo": _sudo.get(), "env": _env.get()}


def exec_star(*args, stdin=""):
    """Run a command, returning the raw action result (control.clj exec*):
    no exit-code check."""
    cmd = " ".join(escape(a) for a in args)
    sess = _session.get()
    if sess is None:
        raise RuntimeError("no session bound: use on(host) inside "
                           "ssh_scope(test)")
    if _trace.get():
        logger.info("[%s] %s", _host.get(), cmd)
    t0 = obs.now_ns()
    try:
        return sess.execute(_ctx(), {"cmd": cmd, "in": stdin})
    finally:
        _record_remote("control.exec", t0, cmd=cmd)


def exec_(*args, stdin=""):
    """Run a command; returns trimmed stdout; raises on nonzero exit
    (control.clj exec)."""
    res = exec_star(*args, stdin=stdin)
    throw_on_nonzero_exit(_host.get(), res)
    return res.get("out", "").strip()


def _record_remote(kind, t0, **args):
    """One span + latency observation per remote call, on the issuing
    host's track (every transport goes through these three chokepoints,
    so SSH, Docker, k8s, and local runs all trace identically)."""
    if not obs.enabled():
        return
    host = _host.get()
    dur = obs.now_ns() - t0
    obs.complete(kind, t0, dur, cat="control", host=str(host),
                 **{k: str(v)[:200] for k, v in args.items()})
    obs.observe("control.remote_s", dur / 1e9, op=kind.split(".")[-1])
    obs.inc("control.remote_calls", op=kind.split(".")[-1])


def upload(local_paths, remote_path):
    sess = _session.get()
    t0 = obs.now_ns()
    try:
        return sess.upload(_ctx(), local_paths, remote_path)
    finally:
        _record_remote("control.upload", t0, remote_path=remote_path)


def download(remote_paths, local_path):
    sess = _session.get()
    t0 = obs.now_ns()
    try:
        return sess.download(_ctx(), remote_paths, local_path)
    finally:
        _record_remote("control.download", t0, local_path=local_path)


def upload_string(content, remote_path):
    """Write a string to a remote file (helper; reference uses tmp files)."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp()
    try:
        with os.fdopen(fd, "w") as f:
            f.write(content)
        return upload([path], remote_path)
    finally:
        os.unlink(path)


def base_remote(test):
    """Pick the remote transport for a test map (control.clj:35-40 +
    {:dummy? true}; {"local?": True} runs commands on the control host
    itself -- the integration rig's control==node topology)."""
    ssh = test.get("ssh", {})
    if ssh.get("dummy?"):
        return DummyRemote(log=test.setdefault("dummy-log", []))
    if ssh.get("local?"):
        return LocalRemote()
    remote = test.get("remote")
    if remote is not None:
        return remote
    return RetryRemote(SSHRemote())


def conn_spec(test, node):
    ssh = test.get("ssh", {})
    return {"host": node,
            "port": ssh.get("port", 22),
            "username": ssh.get("username", "root"),
            "password": ssh.get("password"),
            "private-key-path": ssh.get("private-key-path"),
            "strict-host-key-checking":
                ssh.get("strict-host-key-checking", False)}


@contextlib.contextmanager
def ssh_scope(test):
    """Open one pooled session per node for the duration (reference
    with-ssh + core.clj:274-294 with-sessions)."""
    base = base_remote(test)
    sessions = {}
    for node in test.get("nodes", []):
        sessions[node] = base.connect(conn_spec(test, node))
    tok = _sessions.set(sessions)
    try:
        yield sessions
    finally:
        _sessions.reset(tok)
        for s in sessions.values():
            try:
                s.disconnect()
            except Exception:  # noqa: BLE001
                pass


@contextlib.contextmanager
def on(node):
    """Bind the scope to one node's session (control.clj on)."""
    sessions = _sessions.get()
    if sessions is None or node not in sessions:
        raise RuntimeError(f"no session for node {node!r}; "
                           "use ssh_scope(test) first")
    with _bind(_host, node), _bind(_session, sessions[node]):
        yield


def on_nodes(test, f, nodes=None):
    """Run (f test node) on each node in parallel, one thread per node;
    returns {node: result} (control.clj:272-311 on-nodes)."""
    nodes = list(nodes if nodes is not None else test.get("nodes", []))
    ctx = contextvars.copy_context()

    def run_one(node):
        def inner():
            with on(node):
                return f(test, node)
        return node, ctx.copy().run(inner)

    return dict(real_pmap(run_one, nodes))


def with_test_nodes(test, f):
    """Evaluate f on all nodes (control.clj with-test-nodes)."""
    return on_nodes(test, lambda t, n: f())
