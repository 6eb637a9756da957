"""CharybdeFS wrapper: filesystem fault injection via scylladb's FUSE
passthrough filesystem, built from source on db nodes (reference
charybdefs/src/jepsen/charybdefs.clj, 85 LoC).

After install(), /faulty mirrors /real through the fault layer; point
the DB's data dir at /faulty and use break_all / break_one_percent /
clear to inject EIO faults."""

from __future__ import annotations

import logging

from . import control as c
from .control import util as cu
from .os import debian

logger = logging.getLogger(__name__)

THRIFT_URL = ("http://www-eu.apache.org/dist/thrift/0.10.0/"
              "thrift-0.10.0.tar.gz")
THRIFT_DIR = "/opt/thrift"
CHARYBDEFS_DIR = "/opt/charybdefs"


def install_thrift():
    """Build thrift 0.10 (compiler + C++ + python libs) from source;
    distro packages ship mismatched halves (charybdefs.clj:7-37)."""
    if cu.exists("/usr/bin/thrift"):
        return
    with c.su():
        debian.install(["automake", "bison", "flex", "g++", "git",
                        "libboost-all-dev", "libevent-dev", "libssl-dev",
                        "libtool", "make", "pkg-config",
                        "python-setuptools", "libglib2.0-dev"])
    logger.info("Building thrift (this takes several minutes)")
    cu.install_archive(THRIFT_URL, THRIFT_DIR)
    with c.cd(THRIFT_DIR):
        c.exec_("./configure", "--prefix=/usr")
        c.exec_("make", "-j4")
        c.exec_("make", "install")
    with c.cd(f"{THRIFT_DIR}/lib/py"):
        c.exec_("python", "setup.py", "install")


def install():
    """Ensure CharybdeFS is built and mounted at /faulty over /real
    (charybdefs.clj:39-66)."""
    install_thrift()
    bin_path = f"{CHARYBDEFS_DIR}/charybdefs"
    if not cu.exists(bin_path):
        with c.su():
            debian.install(["build-essential", "cmake", "libfuse-dev",
                            "fuse"])
            c.exec_("mkdir", "-p", CHARYBDEFS_DIR)
            c.exec_("chmod", "777", CHARYBDEFS_DIR)
        c.exec_("git", "clone", "--depth", "1",
                "https://github.com/scylladb/charybdefs.git",
                CHARYBDEFS_DIR)
        with c.cd(CHARYBDEFS_DIR):
            c.exec_("thrift", "-r", "--gen", "cpp", "server.thrift")
            c.exec_("cmake", "CMakeLists.txt")
            c.exec_("make")
    with c.su():
        c.exec_("modprobe", "fuse")
        c.exec_star("umount", "/faulty")   # may not be mounted; ignore
        c.exec_("mkdir", "-p", "/real", "/faulty")
        c.exec_(bin_path, "/faulty",
                "-oallow_other,modules=subdir,subdir=/real")
        c.exec_("chmod", "777", "/real", "/faulty")


def _cookbook(flag):
    with c.cd(f"{CHARYBDEFS_DIR}/cookbook"):
        c.exec_("./recipes", flag)


def break_all():
    """All operations fail with EIO (charybdefs.clj:72-75)."""
    _cookbook("--io-error")


def break_one_percent():
    """1% of disk operations fail (charybdefs.clj:77-80)."""
    _cookbook("--probability")


def clear():
    """Clear a previous failure injection (charybdefs.clj:82-85)."""
    _cookbook("--clear")
