"""Network manipulation: partitions and traffic shaping (reference
jepsen/src/jepsen/net.clj + net/proto.clj).

The Net protocol drops/heals links and injects latency/loss with iptables
and tc-netem on the nodes. A *grudge* is {node: set-of-nodes-whose-inbound-
traffic-to-drop}; ``drop_all`` applies a whole grudge in one batched pass
per node (the PartitionAll fast path, net/proto.clj:5-12,
net.clj:101-111)."""

from __future__ import annotations

from . import control as c


class Net:
    """drop/heal/slow/flaky/fast (net.clj:15-26)."""

    def drop(self, test, src, dest):
        """Drop traffic from src to dest (inbound on dest)."""
        raise NotImplementedError

    def heal(self, test):
        raise NotImplementedError

    def slow(self, test, mean_ms=50, variance_ms=10, distribution="normal"):
        raise NotImplementedError

    def flaky(self, test):
        raise NotImplementedError

    def fast(self, test):
        raise NotImplementedError

    def drop_all(self, test, grudge):
        """Apply a full grudge; default loops drop(), impls may batch
        (net/proto.clj PartitionAll)."""
        for dest, srcs in grudge.items():
            for src in srcs:
                self.drop(test, src, dest)


def _resolve_ip(node):
    """Node hostname -> IP as resolved *on the current node* via getent
    (control/net.clj ip): `iptables -s <name>` resolves at rule-insert
    time and silently matches nothing if the node's DNS view disagrees.
    Falls back to the raw name when resolution fails (e.g. dummy
    remotes)."""
    from .control import net as cn
    try:
        return cn.ip(node)
    except Exception:  # noqa: BLE001 - dummy remotes have no getent
        return node


class IPTables(Net):
    """iptables -A INPUT -s ... -j DROP; tc qdisc netem for latency/loss
    (net.clj:58-111)."""

    def drop(self, test, src, dest):
        def go(t, node):
            if node == dest:
                with c.su():
                    c.exec_("iptables", "-A", "INPUT", "-s",
                            _resolve_ip(src), "-j", "DROP", "-w")
        c.on_nodes(test, go, [dest])

    def heal(self, test):
        def go(t, node):
            with c.su():
                c.exec_("iptables", "-F", "-w")
                c.exec_("iptables", "-X", "-w")
        c.on_nodes(test, go)

    def slow(self, test, mean_ms=50, variance_ms=10,
             distribution="normal"):
        def go(t, node):
            with c.su():
                c.exec_("tc", "qdisc", "add", "dev", "eth0", "root",
                        "netem", "delay", f"{mean_ms}ms",
                        f"{variance_ms}ms", "distribution", distribution)
        c.on_nodes(test, go)

    def flaky(self, test):
        def go(t, node):
            with c.su():
                c.exec_("tc", "qdisc", "add", "dev", "eth0", "root",
                        "netem", "loss", "20%", "75%")
        c.on_nodes(test, go)

    def fast(self, test):
        def go(t, node):
            with c.su():
                c.exec_star("tc", "qdisc", "del", "dev", "eth0", "root")
        c.on_nodes(test, go)

    def drop_all(self, test, grudge):
        """Batched PartitionAll fast path: one iptables invocation per
        affected node (net.clj:101-111)."""
        def go(t, node):
            srcs = grudge.get(node)
            if srcs:
                with c.su():
                    c.exec_("iptables", "-A", "INPUT", "-s",
                            ",".join(_resolve_ip(s) for s in sorted(srcs)),
                            "-j", "DROP", "-w")
        c.on_nodes(test, go, [n for n, s in grudge.items() if s])


class IPFilter(Net):
    """ipfilter-based impl for SmartOS/illumos nodes (net.clj:113-145)."""

    def drop(self, test, src, dest):
        def go(t, node):
            with c.su():
                c.exec_("bash", "-c",
                        f'echo "block in quick from {src} to any" | '
                        f"ipf -f -")
        c.on_nodes(test, go, [dest])

    def heal(self, test):
        def go(t, node):
            with c.su():
                c.exec_("ipf", "-Fa")
        c.on_nodes(test, go)

    def slow(self, test, **kw):
        raise NotImplementedError("ipfilter cannot shape traffic")

    def flaky(self, test):
        raise NotImplementedError("ipfilter cannot shape traffic")

    def fast(self, test):
        pass


iptables = IPTables()
ipfilter = IPFilter()


def drop_all(test, grudge):
    """Apply a grudge via the test's net (net.clj:29-44)."""
    return test.get("net", iptables).drop_all(test, grudge)


def heal(test):
    return test.get("net", iptables).heal(test)
