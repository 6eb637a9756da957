"""Pure grudge computations: who should stop talking to whom (reference
jepsen/src/jepsen/nemesis.clj:108-281). A grudge maps each node to the set
of nodes whose inbound traffic it drops."""

from __future__ import annotations

import random

from ..util import majority


def bisect(coll):
    """Cut a sequence in half, smaller half first (nemesis.clj:108-111)."""
    coll = list(coll)
    mid = len(coll) // 2
    return [coll[:mid], coll[mid:]]


def split_one(coll, loner=None):
    """Split one node off from the rest (nemesis.clj:113-118)."""
    coll = list(coll)
    if loner is None:
        loner = random.choice(coll)
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components):
    """No node can talk outside its component (nemesis.clj:120-132)."""
    components = [set(comp) for comp in components]
    universe = set().union(*components) if components else set()
    grudge = {}
    for comp in components:
        for node in comp:
            grudge[node] = universe - comp
    return grudge


def invert_grudge(nodes, conns):
    """Map of nodes to *allowed* peers -> map of nodes to dropped peers
    (nemesis.clj:134-142)."""
    nodes = set(nodes)
    return {a: nodes - set(conns.get(a, set())) for a in sorted(nodes)}


def bridge(nodes):
    """Two halves plus one bridge node that talks to both
    (nemesis.clj:144-155)."""
    components = bisect(nodes)
    bridge_node = components[1][0]
    grudge = complete_grudge(components)
    del grudge[bridge_node]
    return {node: s - {bridge_node} for node, s in grudge.items()}


def majorities_ring_perfect(nodes):
    """Exact ring for <=5 nodes: every node sees a distinct majority
    (nemesis.clj:202-219)."""
    nodes = list(nodes)
    U = set(nodes)
    n = len(nodes)
    m = majority(n)
    shuffled = list(nodes)
    random.shuffle(shuffled)
    ring = shuffled * 2
    grudge = {}
    for i in range(n):
        maj = ring[i:i + m]
        center = maj[len(maj) // 2]
        grudge[center] = U - set(maj)
    return grudge


def majorities_ring_stochastic(nodes):
    """Incremental least-connected matching for larger clusters
    (nemesis.clj:221-258)."""
    nodes = list(nodes)
    n = len(nodes)
    m = majority(n)
    conns = {a: {a} for a in nodes}
    while True:
        by_degree = sorted(nodes, key=lambda a: (len(conns[a]),
                                                 random.random()))
        a = by_degree[0]
        if len(conns[a]) >= m:
            return invert_grudge(nodes, conns)
        candidates = [b for b in by_degree[1:] if b not in conns[a]]
        if not candidates:
            return invert_grudge(nodes, conns)
        b = candidates[0]
        conns[a].add(b)
        conns[b].add(a)


def majorities_ring(nodes):
    """Perfect for <=5 nodes, stochastic beyond (nemesis.clj:260-275)."""
    nodes = list(nodes)
    if len(nodes) <= 5:
        return majorities_ring_perfect(nodes)
    return majorities_ring_stochastic(nodes)
