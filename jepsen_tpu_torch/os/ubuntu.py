"""Common tasks for Ubuntu boxes; reuses the debian helpers (reference
jepsen/src/jepsen/os/ubuntu.clj)."""

from __future__ import annotations

import logging

from .. import control as c
from . import OS, debian

logger = logging.getLogger(__name__)

BASE_PACKAGES = [
    "apt-transport-https", "wget", "curl", "vim", "man-db", "faketime",
    "ntpdate", "unzip", "iptables", "psmisc", "tar", "bzip2",
    "iputils-ping", "iproute2", "rsyslog", "sudo", "logrotate",
]


class Ubuntu(OS):
    def setup(self, test, node):
        logger.info("%s setting up ubuntu", node)
        debian.setup_hostfile()
        debian.maybe_update()
        with c.su():
            debian.install(BASE_PACKAGES)
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception:  # noqa: BLE001
            pass

    def teardown(self, test, node):
        pass


os = Ubuntu()
