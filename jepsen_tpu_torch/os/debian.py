"""Common tasks for Debian boxes (reference
jepsen/src/jepsen/os/debian.clj)."""

from __future__ import annotations

import logging
import re

from .. import control as c
from ..control import util as cu
from . import OS

logger = logging.getLogger(__name__)


def setup_hostfile():
    """Make sure the hostfile has a loopback entry for the local hostname
    (debian.clj:13-26)."""
    hosts = c.exec_("cat", "/etc/hosts")
    lines = ["127.0.0.1\tlocalhost"
             if re.match(r"^127\.0\.0\.1\t", line) else line
             for line in hosts.splitlines()]
    hosts2 = "\n".join(lines)
    if hosts != hosts2:
        with c.su():
            c.exec_("echo", hosts2, c.lit(">"), "/etc/hosts")


def time_since_last_update():
    """Seconds since the last apt-get update (debian.clj:28-32)."""
    now = int(c.exec_("date", "+%s"))
    then = c.exec_("stat", "-c", "%Y", "/var/cache/apt/pkgcache.bin",
                   c.lit("||"), "echo", "0")
    return now - int(then or 0)


def update():
    with c.su():
        c.exec_("apt-get", "update")


def maybe_update():
    """apt-get update if we haven't in 24h (debian.clj:39-43)."""
    if time_since_last_update() > 86400:
        update()


def installed(pkgs):
    """The subset of pkgs that are installed, as a set of strings
    (debian.clj:45-56)."""
    pkgs = {str(p) for p in pkgs}
    out = c.exec_("dpkg", "--get-selections", *sorted(pkgs))
    got = set()
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[1] == "install":
            got.add(re.sub(r":amd64|:i386", "", parts[0]))
    return got


def installed_p(pkg_or_pkgs):
    pkgs = ([pkg_or_pkgs] if isinstance(pkg_or_pkgs, str)
            else list(pkg_or_pkgs))
    return set(map(str, pkgs)) <= installed(pkgs)


def installed_version(pkg):
    """Installed version of a package, or None (debian.clj:72-78)."""
    out = c.exec_("apt-cache", "policy", str(pkg))
    m = re.search(r"Installed: ([^\s]+)", out)
    return m.group(1) if m else None


def uninstall(pkg_or_pkgs):
    pkgs = ([pkg_or_pkgs] if isinstance(pkg_or_pkgs, str)
            else list(pkg_or_pkgs))
    pkgs = installed(pkgs)
    if pkgs:
        with c.su():
            c.exec_("apt-get", "remove", "--purge", "-y", *sorted(pkgs))


def install(pkgs, apt_opts=()):
    """Ensure packages are installed: a collection (any version) or a
    {pkg: version} map (exact versions) (debian.clj:80-113)."""
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if installed_version(pkg) != version:
                logger.info("Installing %s %s", pkg, version)
                c.exec_("env", "DEBIAN_FRONTEND=noninteractive",
                        "apt-get", "install", "-y", "--allow-downgrades",
                        "--allow-change-held-packages", *apt_opts,
                        f"{pkg}={version}")
    else:
        pkgs = {str(p) for p in pkgs}
        missing = pkgs - installed(pkgs)
        if missing:
            with c.su():
                logger.info("Installing %s", sorted(missing))
                c.exec_("env", "DEBIAN_FRONTEND=noninteractive",
                        "apt-get", "install", "-y", "--allow-downgrades",
                        "--allow-change-held-packages", *apt_opts,
                        *sorted(missing))


def add_key(keyserver, key):
    """Receive an apt key from a keyserver (debian.clj:115-121)."""
    with c.su():
        c.exec_("apt-key", "adv", "--keyserver", keyserver, "--recv", key)


def add_repo(repo_name, apt_line, keyserver=None, key=None):
    """Add an apt repo + optional key (debian.clj:123-134)."""
    list_file = f"/etc/apt/sources.list.d/{repo_name}.list"
    if not cu.exists(list_file):
        logger.info("setting up %s apt repo", repo_name)
        if keyserver or key:
            add_key(keyserver, key)
        c.exec_("echo", apt_line, c.lit(">"), list_file)
        update()


def install_jdk11():
    """openjdk 11 via stretch-backports (debian.clj:152-159)."""
    with c.su():
        add_repo("stretch-backports",
                 "deb http://deb.debian.org/debian stretch-backports main")
        install(["openjdk-11-jdk"])


#: baseline packages every jepsen debian node gets (debian.clj:168-188)
BASE_PACKAGES = [
    "apt-transport-https", "libzip4", "wget", "curl", "vim", "man-db",
    "faketime", "netcat", "ntpdate", "unzip", "iptables", "psmisc", "tar",
    "bzip2", "iputils-ping", "iproute2", "rsyslog", "logrotate", "dirmngr",
    "tcpdump",
]


class Debian(OS):
    def setup(self, test, node):
        logger.info("%s setting up debian", node)
        setup_hostfile()
        maybe_update()
        with c.su():
            install(BASE_PACKAGES)
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception:  # noqa: BLE001 - meh (debian.clj:190)
            pass

    def teardown(self, test, node):
        pass


os = Debian()
