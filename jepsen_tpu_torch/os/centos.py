"""Common tasks for CentOS boxes (reference
jepsen/src/jepsen/os/centos.clj)."""

from __future__ import annotations

import logging
import re

from .. import control as c
from . import OS

logger = logging.getLogger(__name__)


def setup_hostfile():
    """Loopback entry for the local hostname (centos.clj:12-25)."""
    name = c.exec_("hostname")
    hosts = c.exec_("cat", "/etc/hosts")
    lines = [line + " " + name
             if re.match(r"^127\.0\.0\.1", line) and name not in line
             else line
             for line in hosts.splitlines()]
    with c.su():
        c.exec_("echo", "\n".join(lines), c.lit(">"), "/etc/hosts")


def time_since_last_update():
    now = int(c.exec_("date", "+%s"))
    then = c.exec_("stat", "-c", "%Y", "/var/log/yum.log")
    return now - int(then)


def update():
    with c.su():
        c.exec_("yum", "-y", "update")


def maybe_update():
    """yum update if we haven't in 24h (centos.clj:38-43)."""
    try:
        if time_since_last_update() > 86400:
            update()
    except Exception:  # noqa: BLE001 - mirrors reference catch-all
        update()


def installed(pkgs):
    """Subset of pkgs installed, as strings (centos.clj:45-57)."""
    pkgs = {str(p) for p in pkgs}
    out = c.exec_("yum", "list", "installed")
    got = set()
    for line in out.splitlines():
        first = line.split()[0] if line.split() else ""
        m = re.match(r"(.*)\.[^\-]+", first)
        if m:
            got.add(m.group(1))
    return got & pkgs


def installed_p(pkg_or_pkgs):
    pkgs = ([pkg_or_pkgs] if isinstance(pkg_or_pkgs, str)
            else list(pkg_or_pkgs))
    return set(map(str, pkgs)) <= installed(pkgs)


def installed_version(pkg):
    out = c.exec_("yum", "list", "installed")
    for line in out.splitlines():
        first = line.split(";")[0]
        m = re.match(r"(.*)\.[^\-]+", first)
        if m and m.group(1) == str(pkg):
            v = re.match(r".*-([^\-]+)", first)
            return v.group(1) if v else None
    return None


def uninstall(pkg_or_pkgs):
    pkgs = ([pkg_or_pkgs] if isinstance(pkg_or_pkgs, str)
            else list(pkg_or_pkgs))
    pkgs = installed(pkgs)
    if pkgs:
        logger.info("Uninstalling %s", sorted(pkgs))
        with c.su():
            c.exec_("yum", "-y", "remove", *sorted(pkgs))


def install(pkgs):
    """Collection (any version) or {pkg: version} map (centos.clj:89-108)."""
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if installed_version(pkg) != version:
                logger.info("Installing %s %s", pkg, version)
                c.exec_("yum", "-y", "install", f"{pkg}-{version}")
    else:
        pkgs = {str(p) for p in pkgs}
        missing = pkgs - installed(pkgs)
        if missing:
            with c.su():
                logger.info("Installing %s", sorted(missing))
                c.exec_("yum", "-y", "install", *sorted(missing))


def installed_start_stop_daemon_p():
    out = c.exec_("ls", "/usr/bin")
    return any("start-stop-daemon" in line for line in out.splitlines())


def install_start_stop_daemon():
    """Builds start-stop-daemon from the dpkg source tarball
    (centos.clj:110-120) — centos has no native package for it, and
    control.util's daemon helpers depend on it."""
    logger.info("Installing start-stop-daemon")
    with c.su():
        c.exec_("wget", "http://ftp.de.debian.org/debian/pool/main/d/dpkg/"
                "dpkg_1.17.27.tar.xz")
        c.exec_("tar", "-xf", "dpkg_1.17.27.tar.xz")
        c.exec_("bash", "-c", "cd dpkg-1.17.27 && ./configure")
        c.exec_("bash", "-c", "cd dpkg-1.17.27 && make")
        c.exec_("bash", "-c", "cp /dpkg-1.17.27/utils/start-stop-daemon "
                "/usr/bin/start-stop-daemon")
        c.exec_("bash", "-c", "rm -f dpkg_1.17.27.tar.xz")


BASE_PACKAGES = [
    "wget", "gcc", "gcc-c++", "curl", "vim-common", "unzip", "rsyslog",
    "iptables", "ncurses-devel", "iproute", "logrotate",
]


class CentOS(OS):
    def setup(self, test, node):
        logger.info("%s setting up centos", node)
        setup_hostfile()
        maybe_update()
        with c.su():
            install(BASE_PACKAGES)
        if not installed_start_stop_daemon_p():
            install_start_stop_daemon()
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception:  # noqa: BLE001
            pass

    def teardown(self, test, node):
        pass


os = CentOS()
