"""Remote implementations: ssh subprocess, docker exec, kubectl exec, and
the dummy remote used for no-cluster integration tests (reference
jepsen/src/jepsen/control/{clj_ssh,sshj,docker,k8s}.clj and the
{:dummy? true} path in control.clj:40).

The default SSH transport shells out to the system ``ssh``/``scp``
binaries: unlike the JVM's clj-ssh/sshj libraries there is no in-process
SSH stack baked into this image, and subprocess ssh composes with
ControlMaster connection pooling just as well."""

from __future__ import annotations

import logging
import os
import subprocess

from ..robust import RetryPolicy
from .core import Remote, env_string, wrap_cd, wrap_sudo

logger = logging.getLogger(__name__)


def _run(argv, action, timeout=None):
    try:
        proc = subprocess.run(
            argv, input=action.get("in", ""), capture_output=True,
            text=True, timeout=timeout)
        out = dict(action)
        out.update(out=proc.stdout, err=proc.stderr, exit=proc.returncode)
        return out
    except subprocess.TimeoutExpired:
        out = dict(action)
        out.update(out="", err="timeout", exit=-1)
        return out


def _full_cmd(ctx, action):
    action = dict(action)
    action["cmd"] = wrap_cd(ctx, action["cmd"])
    env = ctx.get("env")
    if env:
        action["cmd"] = f"{env_string(env)} {action['cmd']}"
    return wrap_sudo(ctx, action)


class SSHRemote(Remote):
    """Runs commands through the system ssh binary; files move via scp.
    Conn specs mirror the reference's ssh options (control.clj:40-53):
    {"host", "port", "username", "private-key-path",
    "strict-host-key-checking"}."""

    def __init__(self, conn_spec=None):
        self.spec = conn_spec or {}

    def connect(self, conn_spec):
        return SSHRemote(conn_spec)

    def _ssh_args(self):
        s = self.spec
        args = ["ssh", "-o", "BatchMode=yes"]
        if not s.get("strict-host-key-checking", False):
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null"]
        if s.get("port"):
            args += ["-p", str(s["port"])]
        if s.get("private-key-path"):
            args += ["-i", s["private-key-path"]]
        user = s.get("username", "root")
        return args, f"{user}@{s['host']}"

    def execute(self, ctx, action):
        args, target = self._ssh_args()
        full = _full_cmd(ctx, action)
        return _run(args + [target, full["cmd"]], full,
                    timeout=ctx.get("timeout"))

    def _scp_args(self):
        s = self.spec
        args = ["scp", "-rp", "-o", "BatchMode=yes",
                "-o", "StrictHostKeyChecking=no",
                "-o", "UserKnownHostsFile=/dev/null"]
        if s.get("port"):
            args += ["-P", str(s["port"])]
        if s.get("private-key-path"):
            args += ["-i", s["private-key-path"]]
        user = s.get("username", "root")
        return args, f"{user}@{s['host']}"

    def upload(self, ctx, local_paths, remote_path):
        if isinstance(local_paths, str):
            local_paths = [local_paths]
        args, target = self._scp_args()
        return _run(args + list(local_paths) + [f"{target}:{remote_path}"],
                    {"cmd": "scp upload"}, timeout=ctx.get("timeout"))

    def download(self, ctx, remote_paths, local_path):
        if isinstance(remote_paths, str):
            remote_paths = [remote_paths]
        args, target = self._scp_args()
        return _run(args + [f"{target}:{p}" for p in remote_paths]
                    + [local_path], {"cmd": "scp download"},
                    timeout=ctx.get("timeout"))


class DockerRemote(Remote):
    """docker exec / docker cp transport (control/docker.clj)."""

    def __init__(self, container=None):
        self.container = container

    def connect(self, conn_spec):
        return DockerRemote(conn_spec.get("container",
                                          conn_spec.get("host")))

    def execute(self, ctx, action):
        full = _full_cmd(ctx, action)
        return _run(["docker", "exec", "-i", self.container,
                     "bash", "-c", full["cmd"]], full,
                    timeout=ctx.get("timeout"))

    def upload(self, ctx, local_paths, remote_path):
        if isinstance(local_paths, str):
            local_paths = [local_paths]
        res = None
        for p in local_paths:
            res = _run(["docker", "cp", p,
                        f"{self.container}:{remote_path}"],
                       {"cmd": "docker cp"},
                       timeout=ctx.get("timeout"))
        return res

    def download(self, ctx, remote_paths, local_path):
        if isinstance(remote_paths, str):
            remote_paths = [remote_paths]
        res = None
        for p in remote_paths:
            res = _run(["docker", "cp", f"{self.container}:{p}",
                        local_path], {"cmd": "docker cp"},
                       timeout=ctx.get("timeout"))
        return res


class K8sRemote(Remote):
    """kubectl exec / cp transport (control/k8s.clj)."""

    def __init__(self, pod=None, namespace="default"):
        self.pod = pod
        self.namespace = namespace

    def connect(self, conn_spec):
        return K8sRemote(conn_spec.get("pod", conn_spec.get("host")),
                         conn_spec.get("namespace", "default"))

    def execute(self, ctx, action):
        full = _full_cmd(ctx, action)
        return _run(["kubectl", "exec", "-i", "-n", self.namespace,
                     self.pod, "--", "bash", "-c", full["cmd"]], full,
                    timeout=ctx.get("timeout"))

    def upload(self, ctx, local_paths, remote_path):
        if isinstance(local_paths, str):
            local_paths = [local_paths]
        res = None
        for p in local_paths:
            res = _run(["kubectl", "cp", "-n", self.namespace, p,
                        f"{self.pod}:{remote_path}"],
                       {"cmd": "kubectl cp"},
                       timeout=ctx.get("timeout"))
        return res

    def download(self, ctx, remote_paths, local_path):
        if isinstance(remote_paths, str):
            remote_paths = [remote_paths]
        res = None
        for p in remote_paths:
            res = _run(["kubectl", "cp", "-n", self.namespace,
                        f"{self.pod}:{p}", local_path],
                       {"cmd": "kubectl cp"},
                       timeout=ctx.get("timeout"))
        return res


class LocalRemote(Remote):
    """Runs commands on the control host itself via ``bash -c`` -- the
    control==node single-machine topology (the reference supports the
    same shape by pointing SSH at localhost; this transport skips the
    wire). Node isolation is by convention: suites derive per-node
    ports/directories from the node name, so N "nodes" are N live
    daemon processes on one machine. This is the default rig for the
    integration tests: everything above the transport (daemon helpers,
    process nemeses, log snarfing, gcc shim compiles) runs for real."""

    def __init__(self, host=None):
        self.host = host

    def connect(self, conn_spec):
        return LocalRemote(conn_spec.get("host"))

    def execute(self, ctx, action):
        import os
        sudo = ctx.get("sudo")
        if sudo and os.geteuid() == 0 and sudo == "root":
            # already root on the control host: the sudo wrapper is a
            # no-op, and minimal images often lack the binary entirely
            ctx = {k: v for k, v in ctx.items() if k != "sudo"}
        full = _full_cmd(ctx, action)
        return _run(["bash", "-c", full["cmd"]], full,
                    timeout=ctx.get("timeout"))

    def upload(self, ctx, local_paths, remote_path):
        if isinstance(local_paths, str):
            local_paths = [local_paths]
        return _run(["cp", "-rp", *local_paths, remote_path],
                    {"cmd": "local cp upload"},
                    timeout=ctx.get("timeout"))

    def download(self, ctx, remote_paths, local_path):
        if isinstance(remote_paths, str):
            remote_paths = [remote_paths]
        return _run(["cp", "-rp", *remote_paths, local_path],
                    {"cmd": "local cp download"},
                    timeout=ctx.get("timeout"))


class DummyRemote(Remote):
    """No-op remote for logical-only tests ({:ssh {:dummy? true}},
    control.clj:40): every command succeeds with empty output. Records
    commands for test assertions."""

    def __init__(self, host=None, log=None):
        self.host = host
        self.log = log if log is not None else []

    def connect(self, conn_spec):
        return DummyRemote(conn_spec.get("host"), self.log)

    def execute(self, ctx, action):
        out = _full_cmd(ctx, action)   # log what a real remote would run
        self.log.append((self.host, out.get("cmd")))
        out.update(out="", err="", exit=0)
        return out

    def upload(self, ctx, local_paths, remote_path):
        self.log.append((self.host, f"upload {local_paths} {remote_path}"))
        return {"exit": 0}

    def download(self, ctx, remote_paths, local_path):
        self.log.append((self.host,
                         f"download {remote_paths} {local_path}"))
        return {"exit": 0}


class FaultyRemote(Remote):
    """Deterministic fault-injecting wrapper over any Remote: the
    control plane's OWN nemesis. Jepsen's premise -- systems must be
    tested under faults -- applies to the harness too: the fleet layer
    claims to survive flaky transports, and this wrapper is how that
    claim gets exercised without real broken networks.

    ``faults`` is a callable ``faults(kind) -> fault | None`` where
    ``kind`` is ``"execute"`` / ``"upload"`` / ``"download"`` and the
    fault is one of:

    * ``"exit-255"`` -- the action is NOT performed; an ssh-style
      transport failure result is returned (what `transport_failed`
      recognizes, so retry/lease machinery sees a real signal);
    * ``"timeout"`` -- the action is NOT performed; a subprocess
      timeout result is returned;
    * ``("hang", seconds)`` -- sleep (a wedged transport), then return
      the timeout result; the sleep is capped by the ctx timeout so an
      injected hang can't outlive the caller's own bound;
    * ``"partial"`` (download only) -- the real download runs, then
      the largest transferred file is truncated to half: a torn copy
      that LOOKS successful, which is exactly the fault manifest
      verification (fleet.sync) must catch.

    The callable owns all randomness/scheduling (seeded upstream, see
    fleet.chaos), so a given seed replays the same fault pattern."""

    def __init__(self, inner, faults):
        self.inner = inner
        self.faults = faults

    def connect(self, conn_spec):
        return FaultyRemote(self.inner.connect(conn_spec), self.faults)

    def disconnect(self):
        if hasattr(self.inner, "disconnect"):
            self.inner.disconnect()

    def _note(self, kind, fault):
        """A chaos injection is a first-class trace instant: the soak's
        fault schedule must be readable off the merged campaign trace,
        not reverse-engineered from log lines. No-op while obs is
        unbound (the dispatcher binds its pair around worker loops)."""
        from .. import obs
        obs.instant("chaos.fault", cat="chaos", kind=str(kind),
                    fault=str(fault))
        obs.inc("chaos.faults", kind=str(kind), fault=str(fault))

    def _fault_result(self, fault, ctx, action):
        import time as _t
        out = dict(action if isinstance(action, dict) else
                   {"cmd": str(action)})
        if isinstance(fault, (tuple, list)) and fault and \
                fault[0] == "hang":
            hang_s = float(fault[1]) if len(fault) > 1 else 5.0
            t = (ctx or {}).get("timeout")
            if t:
                hang_s = min(hang_s, float(t))
            logger.warning("chaos: injected %.1fs transport hang",
                           hang_s)
            _t.sleep(hang_s)
            out.update(out="", err="timeout", exit=-1)
            return out
        if fault == "timeout":
            logger.warning("chaos: injected transport timeout")
            out.update(out="", err="timeout", exit=-1)
            return out
        logger.warning("chaos: injected transport exit-255")
        out.update(out="", err="chaos: injected transport failure",
                   exit=255)
        return out

    def _maim(self, local_path):
        """Truncate the largest file under ``local_path`` to half its
        size (deterministic victim: size, then name): a partial
        download that still reports success."""
        victim, size = None, -1
        if os.path.isfile(local_path):
            victim, size = local_path, os.path.getsize(local_path)
        for root, _dirs, files in os.walk(local_path):
            for f in sorted(files):
                p = os.path.join(root, f)
                try:
                    s = os.path.getsize(p)
                except OSError:
                    continue
                if s > size:
                    victim, size = p, s
        if victim is None or size <= 0:
            return
        logger.warning("chaos: truncating partial download %s "
                       "(%d -> %d bytes)", victim, size, size // 2)
        with open(victim, "ab") as f:
            f.truncate(size // 2)

    def execute(self, ctx, action):
        fault = self.faults("execute")
        if fault is not None:
            self._note("execute", fault)
            return self._fault_result(fault, ctx, action)
        return self.inner.execute(ctx, action)

    def upload(self, ctx, local_paths, remote_path):
        fault = self.faults("upload")
        if fault is not None:
            self._note("upload", fault)
            return self._fault_result(fault, ctx, {"cmd": "upload"})
        return self.inner.upload(ctx, local_paths, remote_path)

    def download(self, ctx, remote_paths, local_path):
        fault = self.faults("download")
        if fault is not None and fault != "partial":
            self._note("download", fault)
            return self._fault_result(fault, ctx, {"cmd": "download"})
        res = self.inner.download(ctx, remote_paths, local_path)
        if fault == "partial" and isinstance(res, dict) \
                and res.get("exit") == 0:
            self._note("download", fault)
            try:
                self._maim(local_path)
            except OSError:  # pragma: no cover - fs hiccup
                logger.warning("chaos: couldn't maim download",
                               exc_info=True)
        return res


def transport_failed(result):
    """Did a subprocess transport fail at the *transport* layer?

    ``_run`` reports failure as a result dict, not an exception -- ssh
    exits 255 for its own errors (vs the remote command's exit code),
    and a subprocess timeout becomes ``{"exit": -1, "err": "timeout"}``
    -- so an exception-only retry loop never sees these. This is the
    retry predicate `RetryRemote` feeds to `robust.RetryPolicy`."""
    return isinstance(result, dict) and (
        result.get("exit") == 255
        or (result.get("exit") == -1 and result.get("err") == "timeout"))


class RetryRemote(Remote):
    """Wraps a remote with bounded retry + reconnect: "SSH client libraries
    appear to be near universally-flaky" (control/retry.clj:1-22).

    Retries both raised exceptions AND failed-transport result dicts
    (see `transport_failed`) on the unified `robust.RetryPolicy`
    backoff; after each failed attempt the underlying connection is
    re-established. On exhaustion the last result dict is returned (or
    the last exception re-raised) so callers see the real failure."""

    POLICY = RetryPolicy(tries=5, base_s=0.1, multiplier=2.0,
                         jitter=0.1, max_backoff_s=2.0,
                         max_elapsed_s=60.0)

    def __init__(self, remote, conn_spec=None, policy=None):
        self.remote = remote
        self.conn_spec = conn_spec
        self.conn = None
        self.policy = policy or self.POLICY

    def connect(self, conn_spec):
        r = RetryRemote(self.remote, conn_spec, policy=self.policy)
        r.conn = self.remote.connect(conn_spec)
        return r

    def disconnect(self):
        if self.conn is not None:
            self.conn.disconnect()

    def _reconnect(self, attempt, exc):
        # loud on purpose: a remote command whose OWN exit status is 255
        # is indistinguishable from an ssh transport error here, and the
        # retry RE-EXECUTES the command -- non-idempotent actions should
        # not exit 255 (or should bypass RetryRemote)
        logger.warning(
            "remote attempt %d failed (%s); reconnecting and "
            "RE-EXECUTING the command", attempt + 1,
            exc if exc is not None else "transport-failure result")
        try:
            self.conn = self.remote.connect(self.conn_spec)
        except Exception:  # noqa: BLE001 - retry loop handles it
            pass

    def _with_retry(self, f):
        return self.policy.call(
            f, retry_on_exception=Exception,
            retry_on_result=transport_failed,
            on_retry=self._reconnect, site="control.retry_remote")

    def execute(self, ctx, action):
        return self._with_retry(lambda: self.conn.execute(ctx, action))

    def upload(self, ctx, local_paths, remote_path):
        return self._with_retry(
            lambda: self.conn.upload(ctx, local_paths, remote_path))

    def download(self, ctx, remote_paths, local_path):
        return self._with_retry(
            lambda: self.conn.download(ctx, remote_paths, local_path))
