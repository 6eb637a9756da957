"""Node-side helpers: daemons, packages, files (reference
jepsen/src/jepsen/control/util.clj, 379 LoC). All of these run inside an
``on(node)`` scope."""

from __future__ import annotations

import time

from . import cd, exec_, exec_star, su
from .core import lit


def exists(path) -> bool:
    """Does a file exist? (control/util.clj:38)"""
    return exec_star("test", "-e", path).get("exit") == 0


def file_contents(path):
    return exec_("cat", path)


def tmp_dir():
    """Make a fresh temp dir (control/util.clj:78)."""
    return exec_("mktemp", "-d")


def await_tcp_port(port, host="localhost", timeout_s=60, interval_s=0.5):
    """Block until a TCP port is open (control/util.clj:14)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        res = exec_star("bash", "-c",
                        f"exec 3<>/dev/tcp/{host}/{port}")
        if res.get("exit") == 0:
            return True
        time.sleep(interval_s)
    raise TimeoutError(f"port {port} on {host} not open "
                       f"after {timeout_s}s")


def wget(url, dest=None, force=False):
    """Download a URL on the node (control/util.clj:133)."""
    args = ["wget", "-q"]
    if dest:
        args += ["-O", dest]
    if force:
        args += [lit("--no-cache")]
    args.append(url)
    return exec_(*args)


def cached_wget(url, cache_dir="/tmp/jepsen/wget-cache"):
    """Download with a per-node cache (control/util.clj:167)."""
    import hashlib
    name = hashlib.sha1(url.encode()).hexdigest()
    path = f"{cache_dir}/{name}"
    exec_("mkdir", "-p", cache_dir)
    if not exists(path):
        wget(url, dest=path)
    return path


def install_archive(url, dest, user=None):
    """Download and extract an archive to dest (control/util.clj:199):
    handles .tar.gz/.tgz/.zip, strips a single top-level directory."""
    archive = cached_wget(url)
    exec_("rm", "-rf", dest)
    tmp = str(tmp_dir()).strip()
    if not tmp or tmp == "/":
        # NEVER proceed with a degenerate tmp path: the mv below would
        # otherwise operate on / as root
        raise RuntimeError(f"mktemp returned {tmp!r}")
    try:
        if url.endswith(".zip"):
            exec_("unzip", "-qq", archive, "-d", tmp)
        else:
            exec_("tar", "-xf", archive, "-C", tmp)
        entries = [x for x in exec_("ls", "-A", tmp).splitlines()
                   if x.strip()]
        if not entries:
            raise RuntimeError(f"archive extracted nothing: {url}")
        src = f"{tmp}/{entries[0]}" if len(entries) == 1 else tmp
        exec_("mkdir", "-p", dest)
        exec_("bash", "-c", f"mv {src}/* {dest}/")
        if user:
            exec_("chown", "-R", user, dest)
    finally:
        exec_("rm", "-rf", tmp)
    return dest


def ensure_user(username):
    """Create a user if absent (control/util.clj:277)."""
    res = exec_star("id", username)
    if res.get("exit") != 0:
        exec_("useradd", "--create-home", username)
    return username


def grepkill(pattern, signal="KILL"):
    """Kill processes matching a pattern (control/util.clj:286).

    ``ps axww`` (unlimited width), NOT ``ps aux``: when any inherited
    fd looks like a terminal (pytest, CI shells), ps truncates each
    line at the screen width, so patterns matching argv past ~80
    columns -- e.g. a daemon's long scratch-dir path or its ``--port``
    flag -- silently match nothing and the kill becomes a no-op
    (observed live: leaked toystore daemons surviving every teardown
    under pytest while the same pipeline killed them standalone).

    ``pattern`` is an extended regex (grep -E), passed single-quoted
    so it may contain spaces and alternations; it must not contain
    single quotes."""
    if "'" in pattern:   # not assert: must survive python -O
        raise ValueError("grepkill pattern must be single-quote-free")
    return exec_star("bash", "-c",
                     f"ps axww -o pid=,args= | grep -E -- '{pattern}' "
                     f"| grep -v grep | awk '{{print $1}}' "
                     f"| xargs -r kill -{signal}")


def signal(process_name, sig):
    """Send a signal to processes by name (control/util.clj:375)."""
    return exec_star("killall", "-s", str(sig), process_name)


def start_daemon(bin_path, *args, logfile=None, pidfile=None, chdir=None,
                 make_pidfile=True, env=None):
    """Start a daemonized process (control/util.clj:310, start-stop-daemon
    based). Returns True if started, False if already running."""
    opts = ["start-stop-daemon", "--start", "--background",
            "--no-close", "--oknodo"]
    if make_pidfile:
        opts += ["--make-pidfile"]
    if pidfile:
        opts += ["--pidfile", pidfile]
    if chdir:
        opts += ["--chdir", chdir]
    opts += ["--exec", bin_path, "--"]
    opts += list(args)
    cmd = " ".join(str(o) for o in opts)
    if env:
        exports = " ".join(f"{k}={v}" for k, v in env.items())
        cmd = f"env {exports} {cmd}"
    if logfile:
        cmd = f"{cmd} >> {logfile} 2>&1"
    res = exec_star("bash", "-c", cmd)
    return res.get("exit") == 0


def stop_daemon(pidfile=None, process_name=None):
    """Stop a daemon by pidfile or name (control/util.clj:347)."""
    if pidfile:
        exec_star("bash", "-c",
                  f"test -f {pidfile} && kill -9 $(cat {pidfile}); "
                  f"rm -f {pidfile}")
    elif process_name:
        grepkill(process_name)
    else:
        raise ValueError("need pidfile or process_name")


def daemon_running(pidfile) -> bool:
    """Is the daemon alive? (control/util.clj:362)"""
    res = exec_star("bash", "-c",
                    f"test -f {pidfile} && kill -0 $(cat {pidfile})")
    return res.get("exit") == 0


__all__ = ["exists", "file_contents", "tmp_dir", "await_tcp_port", "wget",
           "cached_wget", "install_archive", "ensure_user", "grepkill",
           "signal", "start_daemon", "stop_daemon", "daemon_running",
           "cd", "su", "exec_", "exec_star"]
