"""Combined nemesis packages: the standard algebra for composing faults
(reference jepsen/src/jepsen/nemesis/combined.clj, 374 LoC).

A *package* is a dict::

    {"nemesis":          Nemesis handling the package's fs,
     "generator":        generator of fault ops (or None),
     "final_generator":  generator run at end-of-test to heal (or None),
     "perf":             set of perf-region specs for the perf graphs}

Packages compose: generators via gen.any, final generators sequentially,
nemeses via nemesis.compose, perf specs via set union
(combined.clj:305-316)."""

from __future__ import annotations

import random

from . import Nemesis, noop as nemesis_noop
from . import (bisect, complete_grudge, compose as n_compose,
               f_map as n_f_map, majorities_ring, partitioner, split_one)
from . import time as nt
from .. import db as dbm
from .. import generator as gen
from ..util import (majority, minority_third, rand_nth,
                    random_nonempty_subset)

#: default seconds between nemesis operations (combined.clj:27-29)
DEFAULT_INTERVAL = 10

#: a package which does nothing (combined.clj:31-36)
noop = {"generator": None,
        "final_generator": None,
        "nemesis": nemesis_noop,
        "perf": set()}


def db_nodes(test, db, node_spec):
    """Resolve a node spec to a concrete node list (combined.clj:38-61).

    Specs: None (random non-empty subset), "one", "minority", "majority",
    "minority-third", "primaries", "all", or an explicit list of nodes."""
    nodes = test["nodes"]
    if node_spec is None:
        return random_nonempty_subset(nodes)
    if node_spec == "one":
        return [rand_nth(nodes)]
    if node_spec == "minority":
        return random.sample(nodes, majority(len(nodes)) - 1)
    if node_spec == "majority":
        return random.sample(nodes, majority(len(nodes)))
    if node_spec == "minority-third":
        return random.sample(nodes, minority_third(len(nodes)))
    if node_spec == "primaries":
        return random_nonempty_subset(db.primaries(test))
    if node_spec == "all":
        return list(nodes)
    return list(node_spec)


def node_specs(db):
    """All node specs valid for this DB (combined.clj:63-68)."""
    specs = [None, "one", "minority-third", "minority", "majority", "all"]
    if isinstance(db, dbm.Primary):
        specs.append("primaries")
    return specs


class DbNemesis(Nemesis):
    """start/kill/pause/resume a DB's processes on spec'd nodes
    (combined.clj:70-98)."""

    def __init__(self, db):
        self.db = db

    def invoke(self, test, op):
        from .. import control as c
        db = self.db
        f = {"start": lambda t, n: db.start(t, n),
             "kill": lambda t, n: db.kill(t, n),
             "pause": lambda t, n: db.pause(t, n),
             "resume": lambda t, n: db.resume(t, n)}[op["f"]]
        nodes = db_nodes(test, db, op.get("value"))
        res = c.on_nodes(test, f, nodes)
        out = dict(op)
        out["value"] = res
        return out

    def fs(self):
        return {"start", "kill", "pause", "resume"}


def db_generators(opts):
    """{"generator", "final_generator"} for DB process faults
    (combined.clj:100-139)."""
    db = opts["db"]
    faults = opts["faults"]
    kill_p = isinstance(db, dbm.Process) and "kill" in faults
    pause_p = isinstance(db, dbm.Pause) and "pause" in faults

    kill_targets = opts.get("kill", {}).get("targets") or node_specs(db)
    pause_targets = opts.get("pause", {}).get("targets") or node_specs(db)

    start = {"type": "info", "f": "start", "value": "all"}
    resume = {"type": "info", "f": "resume", "value": "all"}

    def kill(test, ctx):
        return {"type": "info", "f": "kill",
                "value": rand_nth(kill_targets)}

    def pause(test, ctx):
        return {"type": "info", "f": "pause",
                "value": rand_nth(pause_targets)}

    modes, final = [], []
    if pause_p:
        modes.append(gen.flip_flop(pause, gen.repeat(resume)))
        final.append(resume)
    if kill_p:
        modes.append(gen.flip_flop(kill, gen.repeat(start)))
        final.append(start)
    return {"generator": gen.mix(modes) if modes else None,
            "final_generator": final or None}


def db_package(opts):
    """Package for killing/pausing a DB's processes (combined.clj:141-160)."""
    needed = bool({"kill", "pause"} & set(opts["faults"]))
    gens = db_generators(opts)
    interval = opts.get("interval", DEFAULT_INTERVAL)
    g = (gen.stagger(interval, gens["generator"])
         if gens["generator"] is not None else None)
    return {"generator": g if needed else None,
            "final_generator": gens["final_generator"] if needed else None,
            # unlike the reference (combined.clj:152, which wires the
            # nemesis unconditionally), a disabled package contributes no
            # nemesis: its setup must not touch the nodes
            "nemesis": DbNemesis(opts["db"]) if needed else None,
            "perf": {_perf(name="kill", start={"kill"}, stop={"start"},
                           color="#E9A4A0"),
                     _perf(name="pause", start={"pause"}, stop={"resume"},
                           color="#A0B1E9")}}


def _perf(**kw):
    """Perf-region specs live in sets, so they're stored as frozen item
    tuples; perf_spec() turns them back into dicts."""
    return tuple(sorted(
        (k, frozenset(v) if isinstance(v, (set, frozenset)) else v)
        for k, v in kw.items()))


def perf_spec(p):
    """Decode a _perf item tuple back to a dict for checker.perf."""
    return dict(p)


def grudge(test, db, part_spec):
    """Compute a grudge from a partition spec (combined.clj:162-188).

    Specs: "one", "majority", "majorities-ring", "minority-third",
    "primaries", or an explicit grudge dict."""
    nodes = test["nodes"]
    if part_spec == "one":
        return complete_grudge(split_one(nodes))
    if part_spec == "majority":
        sh = list(nodes)
        random.shuffle(sh)
        return complete_grudge(bisect(sh))
    if part_spec == "majorities-ring":
        return majorities_ring(nodes)
    if part_spec == "minority-third":
        sh = list(nodes)
        random.shuffle(sh)
        k = minority_third(len(nodes))
        return complete_grudge([sh[:k], sh[k:]])
    if part_spec == "primaries":
        primaries = random_nonempty_subset(db.primaries(test))
        others = [n for n in nodes if n not in set(primaries)]
        return complete_grudge([others] + [[p] for p in primaries])
    return part_spec


def partition_specs(db):
    """All partition specs valid for this DB (combined.clj:190-194)."""
    specs = ["one", "minority-third", "majority", "majorities-ring"]
    if isinstance(db, dbm.Primary):
        specs.append("primaries")
    return specs


class PartitionNemesis(Nemesis):
    """Wraps a partitioner with partition-spec support
    (combined.clj:196-224)."""

    def __init__(self, db, p=None):
        self.db = db
        self.p = p if p is not None else partitioner()

    def setup(self, test):
        return PartitionNemesis(self.db, self.p.setup(test))

    def invoke(self, test, op):
        inner = dict(op)
        if op["f"] == "start-partition":
            inner["f"] = "start"
            inner["value"] = grudge(test, self.db, op.get("value"))
        elif op["f"] == "stop-partition":
            inner["f"] = "stop"
        else:
            raise ValueError(f"partition nemesis: unknown f {op['f']!r}")
        out = dict(self.p.invoke(test, inner))
        out["f"] = op["f"]
        return out

    def teardown(self, test):
        self.p.teardown(test)

    def fs(self):
        return {"start-partition", "stop-partition"}


def partition_package(opts):
    """Package for network partitions (combined.clj:226-246)."""
    needed = "partition" in opts["faults"]
    db = opts["db"]
    targets = opts.get("partition", {}).get("targets") or partition_specs(db)

    def start(test, ctx):
        return {"type": "info", "f": "start-partition",
                "value": rand_nth(targets)}

    stop = {"type": "info", "f": "stop-partition", "value": None}
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                    gen.flip_flop(start, gen.repeat(stop)))
    return {"generator": g if needed else None,
            "final_generator": stop if needed else None,
            "nemesis": PartitionNemesis(db) if needed else None,
            "perf": {_perf(name="partition", start={"start-partition"},
                           stop={"stop-partition"}, color="#E9DCA0")}}


def clock_package(opts):
    """Package for clock skew, with fs namespaced *-clock
    (combined.clj:248-280)."""
    needed = "clock" in opts["faults"]
    db = opts["db"]
    # a disabled clock package must not install shims / stop ntpd at
    # setup, so it contributes no nemesis at all
    nemesis = n_compose({(("reset-clock", "reset"),
                          ("check-clock-offsets", "check-offsets"),
                          ("strobe-clock", "strobe"),
                          ("bump-clock", "bump")): nt.clock_nemesis()}) \
        if needed else None
    target_specs = opts.get("clock", {}).get("targets") or node_specs(db)

    def targets(test):
        return db_nodes(test, db,
                        rand_nth(target_specs) if target_specs else None)

    clock_gen = gen.phases(
        {"type": "info", "f": "check-offsets"},
        gen.mix([nt.reset_gen_select(targets),
                 nt.bump_gen_select(targets),
                 nt.strobe_gen_select(targets)]))
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                    gen.f_map({"reset": "reset-clock",
                               "check-offsets": "check-clock-offsets",
                               "strobe": "strobe-clock",
                               "bump": "bump-clock"}, clock_gen))
    return {"generator": g if needed else None,
            "final_generator": ({"type": "info", "f": "reset-clock"}
                                if needed else None),
            "nemesis": nemesis,
            "perf": {_perf(name="clock", start={"bump-clock"},
                           stop={"reset-clock"}, fs={"strobe-clock"},
                           color="#A0E9E3")}}


def f_map_perf(lift, perf):
    """Lift the f sets inside perf-region specs (combined.clj:282-292)."""
    out = set()
    for p in perf:
        d = perf_spec(p)
        d["name"] = lift(d["name"])
        for k in ("start", "stop", "fs"):
            if d.get(k):
                d[k] = {lift(f) for f in d[k]}
        out.add(_perf(**d))
    return out


def f_map(lift, pkg):
    """Lift all :f values in a package — generator, nemesis, and perf
    specs together (combined.clj:294-303)."""
    if isinstance(lift, dict):
        d = dict(lift)
        lift = lambda f: d.get(f, f)  # noqa: E731
    if pkg["nemesis"] is None:
        return dict(pkg, perf=f_map_perf(lift, pkg["perf"]))
    fm = {f: lift(f) for f in pkg["nemesis"].fs()}
    return {"generator": (gen.f_map(fm, pkg["generator"])
                          if pkg["generator"] is not None else None),
            "final_generator": (gen.f_map(fm, pkg["final_generator"])
                                if pkg["final_generator"] is not None
                                else None),
            "nemesis": n_f_map(lift, pkg["nemesis"]),
            "perf": f_map_perf(lift, pkg["perf"])}


def compose_packages(packages):
    """Combine packages: generators race via gen.any, final generators run
    sequentially, nemeses compose (combined.clj:305-316)."""
    packages = list(packages)
    if not packages:
        return noop
    if len(packages) == 1:
        pkg = dict(packages[0])
        if pkg.get("nemesis") is None:
            pkg["nemesis"] = nemesis_noop
        return pkg
    nems = [p["nemesis"] for p in packages if p["nemesis"] is not None]
    return {"generator": gen.any(*[p["generator"] for p in packages
                                   if p["generator"] is not None]),
            "final_generator": [p["final_generator"] for p in packages
                                if p["final_generator"] is not None],
            "nemesis": n_compose(nems) if nems else nemesis_noop,
            "perf": set().union(*[p["perf"] for p in packages])}


def nemesis_packages(opts):
    """The standard packages, pre-composition (combined.clj:318-326)."""
    opts = dict(opts)
    opts["faults"] = set(opts.get("faults",
                                  ["partition", "kill", "pause", "clock"]))
    return [partition_package(opts), clock_package(opts), db_package(opts)]


def nemesis_package(opts):
    """One combined package from an option map (combined.clj:328-374).

    Options: db (required); interval (seconds between ops); faults
    (collection from {"partition","kill","pause","clock"}); partition /
    kill / pause / clock option dicts, each with a "targets" list."""
    return compose_packages(nemesis_packages(opts))
