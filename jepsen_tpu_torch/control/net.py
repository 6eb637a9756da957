"""Network control functions: IP lookup helpers used by iptables grudges
and tcpdump filters (reference jepsen/src/jepsen/control/net.clj).

All of these run *within a node scope* (inside ``c.on(node)``): the lookups
reflect that node's view of DNS, which is what matters when inserting
iptables rules there.
"""

from __future__ import annotations

import re
import threading

from . import exec_ as _exec
from . import _bind, _sudo


class BlankGetentIP(Exception):
    pass


def reachable(node) -> bool:
    """Can the current node ping the given node? (control/net.clj:8-12)"""
    try:
        _exec("ping", "-w", "1", node)
        return True
    except Exception:  # noqa: BLE001 - mirrors reference catch
        return False


def local_ip():
    """The current node's IP address (control/net.clj:14-17)."""
    return _exec("hostname", "-I").split()[0]


def ip_star(host):
    """Look up an ip for a hostname on the current node, unmemoized
    (control/net.clj:19-36). getent output: ``74.125.239.39 STREAM ...``"""
    res = _exec("getent", "ahosts", host)
    ip_ = res.splitlines()[0].split()[0] if res else ""
    if not ip_:
        raise BlankGetentIP(f"blank getent ip for {host!r}: {res!r}")
    return ip_


_ip_cache = {}
_ip_cache_lock = threading.Lock()


def ip(host):
    """Look up an ip for a hostname. Memoized *per resolving node* — nodes'
    DNS views can disagree, which is the whole reason iptables rules use
    resolved IPs (control/net.clj:38-40). on_nodes pmaps resolve
    concurrently, so the cache is locked (the resolve itself runs
    outside the lock: two racing threads may both resolve, one result
    wins)."""
    from . import _host
    key = (_host.get(), host)
    with _ip_cache_lock:
        cached = _ip_cache.get(key)
    if cached is None:
        cached = ip_star(host)
        with _ip_cache_lock:
            _ip_cache[key] = cached
    return cached


def control_ip():
    """The *control* node's IP as perceived by the current DB node — from
    $SSH_CLIENT, escaping the sudo env since the var doesn't reach
    subshells (control/net.clj:42-53)."""
    with _bind(_sudo, None):
        out = _exec("bash", "-c", "echo $SSH_CLIENT")
    m = re.match(r"^(.+?)\s", out + " ")
    return m.group(1) if m else None
