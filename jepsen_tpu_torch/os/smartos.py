"""Common tasks for SmartOS boxes (pkgin) (reference
jepsen/src/jepsen/os/smartos.clj)."""

from __future__ import annotations

import logging
import re

from .. import control as c
from . import OS

logger = logging.getLogger(__name__)


def setup_hostfile():
    name = c.exec_("hostname")
    hosts = c.exec_("cat", "/etc/hosts")
    lines = [line + " " + name
             if re.match(r"^127\.0\.0\.1\t", line) and name not in line
             else line
             for line in hosts.splitlines()]
    with c.su():
        c.exec_("echo", "\n".join(lines), c.lit(">"), "/etc/hosts")


def time_since_last_update():
    now = int(c.exec_("date", "+%s"))
    then = c.exec_("stat", "-c", "%Y", "/var/db/pkgin/sql.log")
    return now - int(then)


def update():
    with c.su():
        c.exec_("pkgin", "update")


def maybe_update():
    try:
        if time_since_last_update() > 86400:
            update()
    except Exception:  # noqa: BLE001
        update()


def installed(pkgs):
    pkgs = {str(p) for p in pkgs}
    out = c.exec_("pkgin", "-p", "list")
    got = set()
    for line in out.splitlines():
        first = line.split(";")[0]
        m = re.match(r"(.*)-[^\-]+", first)
        if m:
            got.add(m.group(1))
    return got & pkgs


def installed_p(pkg_or_pkgs):
    pkgs = ([pkg_or_pkgs] if isinstance(pkg_or_pkgs, str)
            else list(pkg_or_pkgs))
    return set(map(str, pkgs)) <= installed(pkgs)


def installed_version(pkg):
    out = c.exec_("pkgin", "-p", "list")
    for line in out.splitlines():
        first = line.split(";")[0]
        m = re.match(r"(.*)-[^\-]+", first)
        if m and m.group(1) == str(pkg):
            v = re.match(r".*-([^\-]+)", first)
            return v.group(1) if v else None
    return None


def uninstall(pkg_or_pkgs):
    pkgs = ([pkg_or_pkgs] if isinstance(pkg_or_pkgs, str)
            else list(pkg_or_pkgs))
    pkgs = installed(pkgs)
    if pkgs:
        with c.su():
            c.exec_("pkgin", "-y", "remove", *sorted(pkgs))


def install(pkgs):
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if installed_version(pkg) != version:
                logger.info("Installing %s %s", pkg, version)
                c.exec_("pkgin", "-y", "install", f"{pkg}-{version}")
    else:
        pkgs = {str(p) for p in pkgs}
        missing = pkgs - installed(pkgs)
        if missing:
            with c.su():
                logger.info("Installing %s", sorted(missing))
                c.exec_("pkgin", "-y", "install", *sorted(missing))


BASE_PACKAGES = ["wget", "curl", "vim", "unzip", "rsyslog", "logrotate"]


class SmartOS(OS):
    def setup(self, test, node):
        logger.info("%s setting up smartos", node)
        setup_hostfile()
        maybe_update()
        with c.su():
            install(BASE_PACKAGES)
            c.exec_("svcadm", "enable", "-r", "ipfilter")
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception:  # noqa: BLE001
            pass

    def teardown(self, test, node):
        pass


os = SmartOS()
