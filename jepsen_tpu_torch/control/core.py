"""Remote protocol: abstract transport for running commands and moving
files on a db node (reference jepsen/src/jepsen/control/core.clj).

An *action* is {"cmd": str, "in": optional stdin}. Remotes return the
action augmented with {"out", "err", "exit"}. Nonzero exits raise
RemoteExecError unless the caller opts out (core.clj:155-171)."""

from __future__ import annotations

import shlex


class RemoteExecError(RuntimeError):
    def __init__(self, action, host=None):
        self.action = action
        self.host = host
        cmd = action.get("cmd")
        super().__init__(
            f"command {cmd!r} on {host!r} returned exit status "
            f"{action.get('exit')}\nstdout: {action.get('out', '')!r}\n"
            f"stderr: {action.get('err', '')!r}")


class Remote:
    """Abstract transport (control/core.clj:7-58)."""

    def connect(self, conn_spec):
        """Connect to conn_spec {"host", "port", "username", ...}; returns a
        connected remote."""
        return self

    def disconnect(self):
        pass

    def execute(self, ctx, action):
        """Run an action; returns action + {"out","err","exit"}. ctx may
        carry {"dir", "sudo", "env", ...}."""
        raise NotImplementedError

    def upload(self, ctx, local_paths, remote_path):
        raise NotImplementedError

    def download(self, ctx, remote_paths, local_path):
        raise NotImplementedError


def escape(arg):
    """Shell-escape one argument (control/core.clj:67-110). Sequences are
    space-joined after escaping; None vanishes."""
    if arg is None:
        return ""
    if isinstance(arg, (list, tuple)):
        return " ".join(escape(a) for a in arg)
    if isinstance(arg, Lit):
        return arg.s
    s = str(arg)
    if s == "":
        return "''"
    return shlex.quote(s)


class Lit:
    """A literal string that bypasses shell escaping (control.clj lit)."""

    def __init__(self, s):
        self.s = s

    def __repr__(self):
        return f"Lit({self.s!r})"


def lit(s):
    return Lit(s)


def env_string(env):
    """Turn {"K": "v"} into `K=v K2=v2` prefix (control/core.clj:112-140)."""
    if not env:
        return ""
    return " ".join(f"{k}={escape(v)}" for k, v in env.items())


def wrap_cd(ctx, cmd):
    d = ctx.get("dir")
    if d:
        return f"cd {escape(d)}; {cmd}"
    return cmd


def wrap_sudo(ctx, action):
    """Wrap an action in sudo (control/core.clj:142-153)."""
    sudo = ctx.get("sudo")
    if not sudo:
        return action
    out = dict(action)
    password = ctx.get("sudo_password", "")
    out["cmd"] = f"sudo -S -u {escape(sudo)} bash -c {escape(action['cmd'])}"
    out["in"] = password + "\n" + action.get("in", "")
    return out


def throw_on_nonzero_exit(host, action):
    if action.get("exit", 0) != 0:
        raise RemoteExecError(action, host)
    return action
