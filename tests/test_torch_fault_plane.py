"""The port's fault plane on nodes (``os/*``, ``faketime``,
``charybdefs``, ``nemesis.time``, ``nemesis.membership``,
``nemesis.combined``) against the JAX package's.

Each scenario of the JAX package's ``tests/test_aux.py`` (faketime,
charybdefs, membership), ``tests/test_combined.py`` and
``tests/test_nemesis_time.py`` runs through both packages under the
dummy remote (scripted where a command's output matters) from the same
``random`` seed, and the recorded command streams, the nemesis
completions and the generator ops (each package's
``generator.testing.simulate``) must be equal. Commands issued from
several nodes at once are compared as sorted lists; an upload's local
path is compared with the package's directory name and the name of an
``upload_string`` temporary file taken out (the two ``resources/`` hold
the same bytes, checked below). Tolerance: exact equality."""

import importlib
import os
import random
import re
import shutil
import subprocess
import tempfile
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": "jepsen_tpu", "torch": "jepsen_tpu_torch"}


def m(side, name):
    return importlib.import_module(f"{SIDES[side]}.{name}")


#: scripted answers: (substring of the command, its output), the first
#: match wins
ANSWERS = [
    ("date +%s.%N", "1000.25\n"),
    ("date +%s", "200000\n"),
    ("stat -c %Y", "100\n"),
    ("hostname", "n1\n"),
    ("cat /etc/hosts", "127.0.0.1\tlocalhost.localdomain\n"
                       "::1 ip6-localhost\n10.0.0.1 n1\n"),
    ("dpkg --get-selections", "wget\tinstall\ncurl:amd64\tinstall\n"
                              "vim\tdeinstall\n"),
    ("apt-cache policy", "  Installed: 1.2.3\n  Candidate: 1.2.4\n"),
    ("yum list installed", "wget.x86_64 1.14-18.el7 @base\n"
                           "curl-7.29.x86_64 7.29 @base\n"),
    ("pkgin -p list", "wget-1.20;GNU wget\ncurl-7.60;curl\n"),
    ("ls /usr/bin", "bash\nls\n"),
    ("bump-time", "1000.75\n"),
    ("strobe-time", "42\n"),
]


def scripted_remote(side, log, exists=True):
    """A dummy remote of ``side``'s package answering ANSWERS; ``test -e``
    fails unless ``exists``."""
    Dummy = m(side, "control.remotes").DummyRemote

    class Scripted(Dummy):
        def connect(self, conn_spec):
            return Scripted(conn_spec.get("host"), self.log)

        def execute(self, ctx, action):
            out = super().execute(ctx, action)
            cmd = out.get("cmd", "")
            if "test -e" in cmd:
                out["exit"] = 0 if exists else 1
                return out
            if cmd.endswith(".c"):
                return out
            for pat, ans in ANSWERS:
                if pat in cmd:
                    out["out"] = ans
                    break
            return out

    return Scripted(log=log)


def normalize(log):
    """The log with the package's name and the temporary file of an
    ``upload_string`` taken out of the upload lines."""
    tmp = re.escape(tempfile.gettempdir())
    return [(h, re.sub(rf"'{tmp}/[^']*'", "'<tmp>'",
                       cmd.replace("jepsen_tpu_torch", "jepsen_tpu")))
            for h, cmd in log]


def on_node(side, fn, exists=True, nodes=("n1",), node="n1", net=False):
    """Run ``fn(side)`` on ``node`` under the scripted remote; returns
    (result or the exception's type and text, normalized command log)."""
    c = m(side, "control")
    log = []
    test = {"nodes": list(nodes), "remote": scripted_remote(side, log, exists),
            "dummy-log": log}
    if net:
        test["net"] = m(side, "net").iptables
    with c.ssh_scope(test), c.on(node):
        try:
            out = fn(side, test)
        except Exception as exc:  # noqa: BLE001 - compared across sides
            out = (type(exc).__name__, str(exc))
    return out, normalize(log)


def both(fn, **kw):
    ours = on_node("torch", fn, **kw)
    theirs = on_node("jax", fn, **kw)
    assert ours == theirs
    return ours


# ---------------------------------------------------------------------------
# os/*: every installer's command stream

OS_CALLS = {
    "debian": [
        lambda o, t: o.setup_hostfile(),
        lambda o, t: o.time_since_last_update(),
        lambda o, t: o.maybe_update(),
        lambda o, t: o.update(),
        lambda o, t: sorted(o.installed(["wget", "curl", "vim", "git"])),
        lambda o, t: o.installed_p(["wget", "curl"]),
        lambda o, t: o.installed_p("git"),
        lambda o, t: o.installed_version("wget"),
        lambda o, t: o.uninstall(["wget", "git"]),
        lambda o, t: o.install(["wget", "git", "tcpdump"]),
        lambda o, t: o.install({"wget": "1.2.3", "git": "2.0"},
                               apt_opts=("--no-install-recommends",)),
        lambda o, t: o.add_key("keyserver.ubuntu.com", "ABCD"),
        lambda o, t: o.add_repo("extra", "deb http://x/ stable main",
                                "keyserver.ubuntu.com", "ABCD"),
        lambda o, t: o.install_jdk11(),
        lambda o, t: o.os.setup(t, "n1"),
        lambda o, t: o.os.teardown(t, "n1"),
    ],
    "ubuntu": [
        lambda o, t: o.os.setup(t, "n1"),
        lambda o, t: o.os.teardown(t, "n1"),
    ],
    "centos": [
        lambda o, t: o.setup_hostfile(),
        lambda o, t: o.time_since_last_update(),
        lambda o, t: o.maybe_update(),
        lambda o, t: sorted(o.installed(["wget", "curl", "gcc"])),
        lambda o, t: o.installed_p(["wget"]),
        lambda o, t: o.installed_version("wget"),
        lambda o, t: o.uninstall(["wget", "gcc"]),
        lambda o, t: o.install(["wget", "gcc"]),
        lambda o, t: o.install({"wget": "1.14", "gcc": "4.8"}),
        lambda o, t: o.installed_start_stop_daemon_p(),
        lambda o, t: o.install_start_stop_daemon(),
        lambda o, t: o.os.setup(t, "n1"),
    ],
    "smartos": [
        lambda o, t: o.setup_hostfile(),
        lambda o, t: o.time_since_last_update(),
        lambda o, t: o.maybe_update(),
        lambda o, t: sorted(o.installed(["wget", "curl", "vim"])),
        lambda o, t: o.installed_p("curl"),
        lambda o, t: o.installed_version("curl"),
        lambda o, t: o.uninstall("curl"),
        lambda o, t: o.install(["wget", "vim"]),
        lambda o, t: o.install({"wget": "1.20", "vim": "8"}),
        lambda o, t: o.os.setup(t, "n1"),
    ],
}


@pytest.mark.parametrize("name", sorted(OS_CALLS))
@pytest.mark.parametrize("exists", [True, False])
def test_os_installers_match_jax(name, exists):
    issued = 0
    for call in OS_CALLS[name]:
        _, log = both(lambda s, t: call(m(s, f"os.{name}"), t),
                      exists=exists, net=True)
        issued += len(log)
    assert issued
    assert m("torch", f"os.{name}").BASE_PACKAGES \
        == m("jax", f"os.{name}").BASE_PACKAGES


def test_os_package_names_the_implementations():
    jos = m("torch", "os")
    assert isinstance(m("torch", "os.debian").os, jos.OS)
    for name in ("ubuntu", "centos", "smartos"):
        assert isinstance(m("torch", f"os.{name}").os, jos.OS)


# ---------------------------------------------------------------------------
# faketime

def test_faketime_script_and_rand_factor_match_jax():
    ft, jft = m("torch", "faketime"), m("jax", "faketime")
    for args in (("/usr/bin/db", 30, 1.5), ("/x", -5, 1.0),
                 ("/opt/db/bin/run", 0, 0.75), ("/y", 12.9, 2)):
        assert ft.script(*args) == jft.script(*args)
    rng, jrng = random.Random(45100), random.Random(45100)
    draws = [ft.rand_factor(2.5, rng) for _ in range(500)]
    assert draws == [jft.rand_factor(2.5, jrng) for _ in range(500)]
    assert max(draws) / min(draws) <= 2.5


@pytest.mark.parametrize("exists", [True, False])
def test_faketime_commands_match_jax(exists):
    both(lambda s, t: m(s, "faketime").wrap("/usr/bin/db", 10, 1.2),
         exists=exists)
    both(lambda s, t: m(s, "faketime").unwrap("/usr/bin/db"),
         exists=exists)
    both(lambda s, t: m(s, "faketime").install(), exists=exists)


def test_faketime_wrap_moves_original_once():
    _, log = both(lambda s, t: m(s, "faketime").wrap("/usr/bin/db", 10, 1.2),
                  exists=False)
    cmds = [cmd for _, cmd in log]
    assert any("mv /usr/bin/db /usr/bin/db.no-faketime" in x for x in cmds)
    assert any("chmod a+x /usr/bin/db" in x for x in cmds)


# ---------------------------------------------------------------------------
# charybdefs

@pytest.mark.parametrize("exists", [True, False])
def test_charybdefs_commands_match_jax(exists):
    for fn in ("install_thrift", "install", "break_all",
               "break_one_percent", "clear"):
        both(lambda s, t, fn=fn: getattr(m(s, "charybdefs"), fn)(),
             exists=exists)
    _, log = both(lambda s, t: (m(s, "charybdefs").break_all(),
                                m(s, "charybdefs").break_one_percent(),
                                m(s, "charybdefs").clear()))
    cmds = [cmd for _, cmd in log]
    assert any("--io-error" in x and "cookbook" in x for x in cmds)
    assert any("--probability" in x for x in cmds)
    assert any("--clear" in x for x in cmds)


# ---------------------------------------------------------------------------
# nemesis.time

def test_resources_are_the_jax_packages_bytes():
    ours = os.path.join(ROOT, "jepsen_tpu_torch", "resources")
    theirs = os.path.join(ROOT, "jepsen_tpu", "resources")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) \
        == ["bump-time.c", "strobe-time.c"]
    for name in os.listdir(theirs):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    assert m("torch", "nemesis.time")._RESOURCE_DIR == ours


@pytest.mark.parametrize("src", ["bump-time.c", "strobe-time.c"])
def test_shims_compile(src, tmp_path):
    if shutil.which("gcc") is None:
        pytest.skip("gcc is not installed here: the shims compile on the "
                    "db nodes")
    out = str(tmp_path / "a.out")
    r = subprocess.run(["gcc", "-Wall", "-Werror", "-O2",
                        os.path.join(ROOT, "jepsen_tpu_torch", "resources",
                                     src), "-o", out],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    r2 = subprocess.run([out], capture_output=True, text=True)
    assert r2.returncode == 1 and "usage" in r2.stderr


@pytest.mark.parametrize("exists", [True, False])
def test_compile_tools_and_install_match_jax(exists):
    _, log = both(lambda s, t: m(s, "nemesis.time").compile_tools(),
                  exists=exists)
    both(lambda s, t: m(s, "nemesis.time").install(), exists=exists)
    if not exists:
        cmds = [cmd for _, cmd in log]
        assert any(x.startswith("upload") and "bump-time.c" in x
                   for x in cmds)
        assert len([x for x in cmds if "gcc" in x]) == 2


CLOCK_OPS = [
    {"type": "info", "process": "nemesis", "f": "bump",
     "value": {"n1": 4000, "n3": -250}},
    {"type": "info", "process": "nemesis", "f": "check-offsets"},
    {"type": "info", "process": "nemesis", "f": "strobe",
     "value": {"n2": {"delta": 100, "period": 5, "duration": 2}}},
    {"type": "info", "process": "nemesis", "f": "reset",
     "value": ["n1", "n2"]},
]


def _clock_run(side, test):
    nt = m(side, "nemesis.time")
    nem = nt.clock_nemesis()
    nem.setup(test)
    done = [nem.invoke(test, dict(op)) for op in CLOCK_OPS]
    nem.teardown(test)
    return done, sorted(nem.fs())


def test_clock_nemesis_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    ours = on_node("torch", _clock_run, exists=False,
                   nodes=("n1", "n2", "n3"))
    theirs = on_node("jax", _clock_run, exists=False,
                     nodes=("n1", "n2", "n3"))
    assert sorted(ours[1]) == sorted(theirs[1])
    assert ours[0] == theirs[0]
    (bump, check, strobe, reset), fs = ours[0]
    assert bump["clock_offsets"] == {"n1": 0.75, "n3": 0.75}
    assert set(check["clock_offsets"]) == {"n1", "n2", "n3"}
    assert set(strobe["clock_offsets"]) == {"n2"}
    assert set(reset["clock_offsets"]) == {"n1", "n2"}
    assert fs == ["bump", "check-offsets", "reset", "strobe"]


def test_clock_generators_match_jax():
    test = {"nodes": ["a", "b", "c", "d", "e"]}
    for name in ("reset_gen", "bump_gen", "strobe_gen"):
        got = []
        for side in ("torch", "jax"):
            random.seed(45100)
            got.append([getattr(m(side, "nemesis.time"), name)(test, None)
                        for _ in range(20)])
        assert got[0] == got[1], name
    for name in ("bump_gen_select", "strobe_gen_select"):
        got = []
        for side in ("torch", "jax"):
            g = getattr(m(side, "nemesis.time"), name)(
                lambda t: t["nodes"][:3], random.Random(7))
            got.append([g(test, None) for _ in range(20)])
        assert got[0] == got[1], name


def _simulate(side, build, test):
    gen = m(side, "generator")
    random.seed(45100)
    with gen.fixed_rand(45100):
        return m(side, "generator.testing").simulate(
            dict(test), build(side), m(side, "generator.testing").perfect)


def test_clock_gen_simulation_matches_jax():
    test = {"nodes": ["n1", "n2"], "concurrency": 1}

    def build(s):
        return m(s, "generator").limit(12, m(s, "nemesis.time").clock_gen())

    ours, theirs = _simulate("torch", build, test), \
        _simulate("jax", build, test)
    assert ours == theirs
    infos = [o for o in ours if o["type"] == "info"]
    assert infos[0]["f"] == "check-offsets"


# ---------------------------------------------------------------------------
# nemesis.membership

def _membership_run(side, test):
    mb = m(side, "nemesis.membership")
    gen = m(side, "generator")

    class JoinState(mb.State):
        def __init__(self, joined=frozenset(), target=()):
            self.joined = frozenset(joined)
            self.target = tuple(target)

        def node_view(self, test, node):
            return sorted(self.joined)

        def merge_views(self, test):
            views = [v for v in self.node_views.values() if v is not None]
            return sorted(set().union(*map(set, views))) if views else []

        def fs(self):
            return {"join"}

        def op(self, test):
            left = [n for n in self.target if n not in self.joined]
            if not left:
                return None
            if self.pending:
                return "pending"
            return {"type": "info", "f": "join", "value": left[0]}

        def invoke(self, test, op):
            return dict(op, type="info")

        def resolve_op(self, test, pair):
            inv, _done = pair
            node = dict(inv).get("value")
            if node not in self.joined:
                return self.assoc(joined=self.joined | {node})
            return None

    test = dict(test, concurrency=1)
    pkg = mb.package({"faults": {"membership"}, "interval": 0.01,
                      "membership": {"state": JoinState(
                          target=("n1", "n2")),
                          "node_view_interval": 0.05}})
    nem = pkg["nemesis"]
    nem.setup(test)
    ctx = gen.context(test)
    seen, g = [], pkg["generator"]
    deadline = time.monotonic() + 8
    while time.monotonic() < deadline:
        got = gen.gen_op(g, test, ctx)
        if got is None:
            break
        op, g = got
        if op is gen.PENDING or op == gen.PENDING:
            time.sleep(0.01)
            continue
        seen.append(nem.invoke(test, dict(op)))
    nem.teardown(test)
    # the process an op is filled in with depends on when the hand-driven
    # loop asks (as in the JAX package's test, which checks the values)
    seen = [{k: v for k, v in o.items() if k not in ("time", "process")}
            for o in seen]
    return (seen, sorted(nem.box["state"].joined), sorted(nem.fs()),
            [mb.package({"faults": {"kill"}})])


def test_membership_package_matches_jax():
    (seen, joined, fs, disabled), log = both(_membership_run,
                                             nodes=("n1", "n2"))
    assert [o["value"] for o in seen] == ["n1", "n2"]
    assert joined == ["n1", "n2"] and fs == ["join"]
    assert disabled == [None] and log == []


def test_membership_resolve_matches_jax():
    got = []
    for side in ("torch", "jax"):
        mb = m(side, "nemesis.membership")

        class Counter(mb.State):
            def __init__(self, n=0):
                self.n = n

            def resolve(self, test):
                return self.assoc(n=min(self.n + 1, 5))

            def resolve_op(self, test, pair):
                return self if pair[0] == "done" else None

        st = mb.initial_fields(Counter()).assoc(
            pending=frozenset({("done", 1), ("open", 2)}))
        out = mb.resolve(st, {}, {})
        got.append((out.n, sorted(out.pending), out.view, out.node_views))
    assert got[0] == got[1] == (5, [("open", 2)], None, {})


# ---------------------------------------------------------------------------
# nemesis.combined

NODES = ["n1", "n2", "n3", "n4", "n5"]


def db_classes(side):
    c = m(side, "control")
    jdb = m(side, "db")

    class ProcDB(jdb.DB, jdb.Process, jdb.Pause):
        def setup(self, test, node):
            pass

        def teardown(self, test, node):
            pass

        def start(self, test, node):
            c.exec_("db-start")
            return "started"

        def kill(self, test, node):
            with c.su():
                c.exec_("pkill", "-9", "-f", "db")
            return "killed"

        def pause(self, test, node):
            c.exec_("pkill", "-STOP", "-f", "db")
            return "paused"

        def resume(self, test, node):
            c.exec_("pkill", "-CONT", "-f", "db")
            return "resumed"

    class PrimaryDB(ProcDB, jdb.Primary):
        def primaries(self, test):
            return test["nodes"][:2]

        def setup_primary(self, test, node):
            pass

    return ProcDB, PrimaryDB


def _grudge(g):
    return {k: sorted(v) for k, v in g.items()} if isinstance(g, dict) \
        else g


def test_db_nodes_and_grudges_match_jax():
    got = []
    for side in ("torch", "jax"):
        nc = m(side, "nemesis.combined")
        ProcDB, PrimaryDB = db_classes(side)
        db, test = PrimaryDB(), {"nodes": NODES}
        random.seed(45100)
        out = [nc.db_nodes(test, db, spec)
               for spec in nc.node_specs(db) + [["n4"]] for _ in range(4)]
        out += [_grudge(nc.grudge(test, db, spec))
                for spec in nc.partition_specs(db) + [{"n1": {"n2"}}]
                for _ in range(4)]
        out += [nc.node_specs(ProcDB()), nc.partition_specs(ProcDB()),
                nc.node_specs(db), nc.partition_specs(db),
                nc.DEFAULT_INTERVAL,
                m(side, "util").random_nonempty_subset([])]
        got.append(out)
    assert got[0] == got[1]


def _package_summary(side, opts_fn):
    nc = m(side, "nemesis.combined")
    ProcDB, PrimaryDB = db_classes(side)
    pkg = opts_fn(nc, ProcDB, PrimaryDB)
    nem = pkg["nemesis"]
    perf = sorted((tuple(sorted((k, sorted(v) if isinstance(v, frozenset)
                                 else v) for k, v in nc.perf_spec(p).items()))
                   for p in pkg["perf"]))
    final = pkg["final_generator"]
    return {"fs": sorted(nem.fs()) if nem is not None else None,
            "generator?": pkg["generator"] is not None,
            "final": final if isinstance(final, (dict, list)) or final is None
            else "gen", "perf": perf}


PACKAGES = {
    "all": lambda nc, P, PP: nc.nemesis_package({"db": PP(), "interval": 1}),
    "kill": lambda nc, P, PP: nc.nemesis_package({"db": P(),
                                                  "faults": ["kill"]}),
    "none": lambda nc, P, PP: nc.nemesis_package({"db": P(), "faults": []}),
    "partition": lambda nc, P, PP: nc.partition_package(
        {"db": P(), "faults": {"partition"}, "interval": 1}),
    "lifted": lambda nc, P, PP: nc.f_map(
        lambda f: f"db1-{f}", nc.partition_package(
            {"db": P(), "faults": {"partition"}, "interval": 1})),
    "lifted-map": lambda nc, P, PP: nc.f_map(
        {"kill": "kill-db"}, nc.db_package(
            {"db": P(), "faults": {"kill"}, "interval": 1})),
    "clock": lambda nc, P, PP: nc.clock_package(
        {"db": PP(), "faults": {"clock"}, "interval": 1}),
    "disabled-clock": lambda nc, P, PP: nc.clock_package(
        {"db": PP(), "faults": set()}),
    "compose-empty": lambda nc, P, PP: dict(
        nc.compose_packages([nc.db_package({"db": P(),
                                             "faults": set()})])),
}


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_packages_match_jax(name):
    ours = _package_summary("torch", PACKAGES[name])
    theirs = _package_summary("jax", PACKAGES[name])
    assert ours == theirs


SIMULATED = {
    "all": lambda nc, P, PP: nc.nemesis_package(
        {"db": PP(), "interval": 1}),
    "kill-targets": lambda nc, P, PP: nc.nemesis_package(
        {"db": P(), "faults": ["kill", "pause"], "interval": 0.5,
         "kill": {"targets": ["one", "all"]}}),
    "partition": lambda nc, P, PP: nc.nemesis_package(
        {"db": PP(), "faults": ["partition"], "interval": 2,
         "partition": {"targets": ["majority", "one"]}}),
    "clock": lambda nc, P, PP: nc.nemesis_package(
        {"db": PP(), "faults": ["clock"], "interval": 3}),
    "lifted": lambda nc, P, PP: nc.f_map(
        lambda f: f"db1-{f}", nc.nemesis_package(
            {"db": P(), "faults": ["kill", "partition"], "interval": 1})),
}


@pytest.mark.parametrize("name", sorted(SIMULATED))
def test_package_generators_match_jax(name):
    test = {"nodes": NODES, "concurrency": 1}

    def build(s):
        nc = m(s, "nemesis.combined")
        pkg = SIMULATED[name](nc, *db_classes(s))
        gen = m(s, "generator")
        final = pkg["final_generator"]
        return [gen.limit(24, pkg["generator"])] \
            + ([final] if final is not None else [])

    ours, theirs = _simulate("torch", build, test), \
        _simulate("jax", build, test)
    assert len(ours) >= 24
    assert ours == theirs


def _kill_run(side):
    nc = m(side, "nemesis.combined")
    tst, gen = m(side, "tests"), m(side, "generator")
    random.seed(45100)
    test = tst.noop_test()
    test["ssh"] = {"dummy?": True}
    test["db"] = db_classes(side)[0]()
    pkg = nc.nemesis_package(
        {"db": test["db"], "faults": ["kill"], "interval": 0.01,
         "kill": {"targets": ["all"]}})
    test["nemesis"] = pkg["nemesis"]
    test["generator"] = gen.nemesis(
        [gen.limit(2, pkg["generator"]), pkg["final_generator"]])
    done = m(side, "core").run(test)
    nem = [(o["type"], o["f"], o.get("value")) for o in done["history"]
           if o["process"] == "nemesis"]
    return nem, sorted(cmd for _, cmd in done["dummy-log"])


def test_kill_package_run_matches_jax(tmp_path, monkeypatch):
    for side in ("torch", "jax"):
        monkeypatch.setattr(m(side, "store"), "base_dir",
                            str(tmp_path / side))
    ours, theirs = _kill_run("torch"), _kill_run("jax")
    assert ours == theirs
    nem, cmds = ours
    assert [f for t, f, _ in nem if t == "info"][:1] == ["kill"]
    assert len([x for x in cmds if "pkill -9 -f db" in x]) == 5
    assert any("sudo" in x for x in cmds if "pkill -9" in x)


def test_perf_specs_feed_perf_checker_match_jax():
    hist = [{"process": "nemesis", "type": "info", "f": "kill",
             "value": None, "time": 0, "index": 0},
            {"process": "nemesis", "type": "info", "f": "start",
             "value": None, "time": 10 ** 9, "index": 1}]
    got = []
    for side in ("torch", "jax"):
        nc = m(side, "nemesis.combined")
        pkg = nc.nemesis_package({"db": db_classes(side)[0](),
                                  "faults": ["kill"]})
        parts = m(side, "checker.perf").nemesis_ops(pkg["perf"], hist)
        got.append(sorted(str(sorted(p.items())) for p in parts))
    assert got[0] == got[1] and any("kill" in p for p in got[0])


def test_partition_nemesis_commands_match_jax():
    """The partition package's nemesis on the dummy net: start with each
    spec, then stop."""
    def run(side, test):
        nc = m(side, "nemesis.combined")
        random.seed(45100)
        nem = nc.partition_package({"db": db_classes(side)[1](),
                                    "faults": {"partition"}})["nemesis"]
        nem = nem.setup(test)
        out = []
        for spec in ("one", "majority", "majorities-ring",
                     "minority-third", "primaries"):
            done = nem.invoke(test, {"type": "info",
                                     "f": "start-partition", "value": spec})
            out.append((done["f"], _grudge(done["value"][1])
                        if isinstance(done["value"], list) else
                        done["value"]))
            out.append(nem.invoke(test, {"type": "info",
                                         "f": "stop-partition",
                                         "value": None})["value"])
        nem.teardown(test)
        return out

    ours = on_node("torch", run, nodes=NODES, net=True)
    theirs = on_node("jax", run, nodes=NODES, net=True)
    assert ours[0] == theirs[0]
    assert sorted(ours[1]) == sorted(theirs[1])
    assert any("iptables" in cmd for _, cmd in ours[1])
