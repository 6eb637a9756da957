"""A built-in demo "database": in-memory clients for every stock workload,
runnable with the dummy remote — the out-of-the-box consumer suite (the
port's copy of ``jepsen_tpu/demo.py``).

    python -m jepsen_tpu_torch test --workload register --no-ssh
    python -m jepsen_tpu_torch test --workload bank --no-ssh --bug lost-write

This plays the role of the reference's per-database suites (SURVEY.md
section 2.8): a workload registry plus clients, wired into the standard
CLI (cli.clj:352-427). ``--bug`` injects misbehavior so checkers have
something to catch (exit code 1).

The port adds one option, ``device``: where every engine of the test map
that can touch a device runs (the register workload's linearizable
checker, the txn workloads' cycle checkers, the streaming monitor).
None means CUDA, and without a card those engines raise; the CPU is used
only when asked for (``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import threading

from . import checker as cc
from . import resolve_device
from . import client as jclient
from . import db as jdb
from . import generator as gen
from . import independent
from .checker import checkers as cks
from .tests import bank as bank_workload
from .tests import linearizable_register
from .tests.cycle import append as append_workload
from .tests.cycle import wr as wr_workload


class DemoState:
    """Shared in-memory cluster state."""

    def __init__(self):
        self.lock = threading.Lock()
        self.registers = {}
        self.balances = {}
        self.set = set()
        self.lists = {}
        self.kv = {}


class DemoDB(jdb.DB):
    def __init__(self, state):
        self.state = state

    def setup(self, test, node):
        with self.state.lock:
            self.state.registers.clear()
            self.state.set.clear()
            self.state.lists.clear()
            self.state.kv.clear()
            accounts = test.get("accounts") or []
            total = test.get("total-amount") or 0
            if accounts:
                per = total // len(accounts)
                self.state.balances = {a: per for a in accounts}
                self.state.balances[accounts[0]] += total - per * len(
                    accounts)

    def teardown(self, test, node):
        pass


class RegisterClient(jclient.Client):
    """Keyed cas-register client; --bug lost-write drops every 5th write,
    --bug dirty-read returns garbage occasionally."""

    def __init__(self, state, bug=None):
        self.state = state
        self.bug = bug
        self._n = 0

    def open(self, test, node):
        return RegisterClient(self.state, self.bug)

    def invoke(self, test, op):
        k, v = op["value"]
        out = dict(op)
        with self.state.lock:
            self._n += 1
            if op["f"] == "write":
                if self.bug == "lost-write" and self._n % 5 == 0:
                    out["type"] = "ok"   # acked but not applied
                else:
                    self.state.registers[k] = v
                    out["type"] = "ok"
            elif op["f"] == "read":
                val = self.state.registers.get(k)
                if self.bug == "dirty-read" and self._n % 7 == 0:
                    val = 99
                out["type"] = "ok"
                out["value"] = independent.tuple_(k, val)
            elif op["f"] == "cas":
                cur, new = v
                if self.state.registers.get(k) == cur:
                    self.state.registers[k] = new
                    out["type"] = "ok"
                else:
                    out["type"] = "fail"
        return out


class BankClient(jclient.Client):
    def __init__(self, state, bug=None):
        self.state = state
        self.bug = bug
        self._n = 0

    def open(self, test, node):
        return BankClient(self.state, self.bug)

    def invoke(self, test, op):
        out = dict(op)
        with self.state.lock:
            self._n += 1
            if op["f"] == "read":
                out["type"] = "ok"
                out["value"] = dict(self.state.balances)
            else:
                v = op["value"]
                if self.state.balances.get(v["from"], 0) < v["amount"]:
                    out["type"] = "fail"
                else:
                    self.state.balances[v["from"]] -= v["amount"]
                    self.state.balances[v["to"]] += v["amount"]
                    if self.bug == "lost-write" and self._n % 5 == 0:
                        # partial apply: money vanishes
                        self.state.balances[v["to"]] -= 1
                    out["type"] = "ok"
        return out


class SetClient(jclient.Client):
    def __init__(self, state, bug=None):
        self.state = state
        self.bug = bug
        self._n = 0

    def open(self, test, node):
        return SetClient(self.state, self.bug)

    def invoke(self, test, op):
        out = dict(op)
        with self.state.lock:
            self._n += 1
            if op["f"] == "add":
                if not (self.bug == "lost-write" and self._n % 5 == 0):
                    self.state.set.add(op["value"])
                out["type"] = "ok"
            elif op["f"] == "read":
                out["type"] = "ok"
                out["value"] = sorted(self.state.set)
        return out


def register_workload(opts, state):
    w = linearizable_register.test({
        "nodes": opts["nodes"],
        "algorithm": opts.get("algorithm", "jax-wgl"),
        "per-key-limit": opts.get("per-key-limit", 20),
        "engine_opts": {"device": opts.get("device")},
    })
    return {**w, "client": RegisterClient(state, opts.get("bug"))}


def bank_workload_fn(opts, state):
    w = bank_workload.test()
    return {**w,
            "client": BankClient(state, opts.get("bug")),
            "generator": gen.clients(w["generator"])}


def set_workload(opts, state):
    counter = {"n": 0}

    def add(test, ctx):
        counter["n"] += 1
        return {"type": "invoke", "f": "add", "value": counter["n"]}

    g = gen.phases(
        gen.clients(gen.limit(
            opts.get("ops", 500), gen.stagger(0.001, add))),
        gen.clients(gen.once({"type": "invoke", "f": "read"})))
    return {"client": SetClient(state, opts.get("bug")),
            "checker": cks.set_checker(),
            "generator": g}


class AppendClient(jclient.Client):
    """Transactional list-append over shared per-key lists. The
    dirty-read bug occasionally reverses a read, which the cycle
    checker flags as an incompatible order; the future-read bug makes
    every 5th read *predict* the next append (returning got +
    [max+1]), so the eventual writer of that value precedes the read
    in the dependency graph while realtime orders them the other way
    -- a G1c-realtime cycle the streaming monitor catches live."""

    def __init__(self, state, bug=None):
        self.state = state
        self.bug = bug
        self._n = 0

    def open(self, test, node):
        return AppendClient(self.state, self.bug)

    def invoke(self, test, op):
        out = dict(op)
        txn = []
        # the future-read prediction must stay cross-txn (a txn
        # predicting a value IT then appends reads as a within-txn
        # incompatible order, not the clean G1c signal)
        own_appends = {k for f, k, _ in op["value"] if f == "append"}
        with self.state.lock:
            self._n += 1
            for f, k, v in op["value"]:
                if f == "append":
                    lst = self.state.lists.setdefault(k, [])
                    # store-assigned contiguous per-key values:
                    # generated values apply out of order under
                    # concurrency, which would leave gaps the
                    # future-read prediction trips over
                    v = lst[-1] + 1 if lst else 1
                    lst.append(v)
                    txn.append([f, k, v])
                else:
                    got = list(self.state.lists.get(k, []))
                    if self.bug == "dirty-read" and self._n % 7 == 0 \
                            and len(got) >= 2:
                        got = got[::-1]
                    elif self.bug == "future-read" \
                            and self._n % 5 == 0 and got \
                            and k not in own_appends:
                        got = got + [max(got) + 1]
                    txn.append([f, k, got])
        out.update(type="ok", value=txn)
        return out


class WrClient(jclient.Client):
    """Transactional write/read over shared per-key registers (the
    rw-register family). The stale-read bug serves every 7th read from
    the key's *previous* version, which the wr cycle checker flags via
    rw/wr conflict cycles."""

    def __init__(self, state, bug=None):
        self.state = state
        self.bug = bug
        self._n = 0

    def open(self, test, node):
        return WrClient(self.state, self.bug)

    def invoke(self, test, op):
        out = dict(op)
        txn = []
        with self.state.lock:
            self._n += 1
            for f, k, v in op["value"]:
                if f == "w":
                    prev = self.state.kv.get(k, (None, None))[0]
                    self.state.kv[k] = (v, prev)
                    txn.append([f, k, v])
                else:
                    cur, prev = self.state.kv.get(k, (None, None))
                    got = cur
                    if self.bug in ("stale-read", "dirty-read") \
                            and self._n % 7 == 0 and prev is not None:
                        got = prev
                    txn.append([f, k, got])
        out.update(type="ok", value=txn)
        return out


def append_workload_fn(opts, state):
    w = append_workload.test({"key-count": 3, "max-txn-length": 3,
                              "device": opts.get("device")})
    return {**w,
            "client": AppendClient(state, opts.get("bug")),
            "generator": gen.clients(gen.stagger(0.001, w["generator"]))}


def wr_workload_fn(opts, state):
    w = wr_workload.test({"key-count": 3, "max-txn-length": 3,
                          "device": opts.get("device")})
    return {**w,
            "client": WrClient(state, opts.get("bug")),
            "generator": gen.clients(gen.stagger(0.001, w["generator"]))}


def noop_workload(opts, state):
    return {"client": jclient.noop,
            "checker": cc.unbridled_optimism(),
            "generator": gen.clients(gen.limit(
                10, gen.repeat({"f": "read"})))}


WORKLOADS = {
    "register": register_workload,
    "bank": bank_workload_fn,
    "set": set_workload,
    "append": append_workload_fn,
    "wr": wr_workload_fn,
    "noop": noop_workload,
}

#: workloads whose histories are transactions over jepsen_tpu_torch.cycle
#: mops -- the txn monitor family applies to exactly these
TXN_WORKLOADS = ("append", "wr")

#: workloads whose checkers search on the device
DEVICE_WORKLOADS = ("register",) + TXN_WORKLOADS


def nemesis_axis(mode):
    """The ``nemesis`` campaign axis: None/"none" -> noop; "faketime" ->
    the libfaketime clock nemesis; "charybdefs" -> FUSE EIO injection.
    Both real nemeses need a real cluster; under the demo's dummy ssh
    their control calls are contained into info completions so the same
    campaign matrix runs everywhere."""
    from . import nemesis as jnemesis
    if mode in (None, "none"):
        return jnemesis.noop, None
    if mode == "faketime":
        from .nemesis import time as ntime
        nem = _contained(ntime.ClockNemesis())
        return nem, gen.stagger(2, ntime.clock_gen())
    if mode == "charybdefs":
        from . import charybdefs

        def start(test, node):
            charybdefs.break_one_percent()
            return "charybdefs-1pct"

        def stop(test, node):
            charybdefs.clear()
            return "charybdefs-clear"

        nem = _contained(jnemesis.node_start_stopper(
            lambda nodes: list(nodes), start, stop))
        return nem, gen.stagger(2, gen.cycle(
            gen.once({"type": "info", "f": "start"}),
            gen.once({"type": "info", "f": "stop"})))
    raise ValueError(f"unknown nemesis axis value {mode!r}; "
                     "expected none/faketime/charybdefs")


def _contained(nemesis_obj):
    """Wrap a real-cluster nemesis so control-layer failures (no sshd,
    dummy remotes, missing tooling) become info completions instead of
    run-killing crashes."""
    from . import nemesis as jnemesis

    class _Contained(jnemesis.Nemesis):
        def setup(self, test):
            try:
                return _contained(nemesis_obj.setup(test))
            except Exception:  # noqa: BLE001 - demo must survive
                return self

        def invoke(self, test, op):
            try:
                return nemesis_obj.invoke(test, op)
            except Exception as exc:  # noqa: BLE001
                out = dict(op)
                out.update(type="info",
                           value=["nemesis-unavailable", repr(exc)[:200]])
                return out

        def teardown(self, test):
            try:
                nemesis_obj.teardown(test)
            except Exception:  # noqa: BLE001
                pass

        def fs(self):
            return nemesis_obj.fs()

    return _Contained()


def _monitor_map(mcfg):
    """``test["monitor"]`` as a fresh dict: True means the defaults, an
    int the chunk."""
    if mcfg is True:
        return {}
    if isinstance(mcfg, int):
        return {"chunk": mcfg}
    return dict(mcfg)


def demo_test(options):
    """Build a full test map from parsed CLI options (the suite's
    test-fn). ``options["device"]`` (None: CUDA) goes to every device
    engine of the map; a device that is not there raises here."""
    from .os import noop as os_noop

    state = DemoState()
    name = options.get("workload", "register")
    if name in DEVICE_WORKLOADS or options.get("monitor"):
        # fail before the run, not in its checker (which would contain
        # the error into an "unknown" verdict): no card, no run
        resolve_device(options.get("device"))
    concurrency = options.get("concurrency") or len(options["nodes"])
    if name == "register":
        # the register workload groups 2*len(nodes) threads per key and
        # needs the worker count to be a multiple of the group size
        # (independent.clj:49-77)
        group = 2 * len(options["nodes"])
        concurrency = max(group,
                          (concurrency + group - 1) // group * group)
    options = {**options, "concurrency": concurrency}
    workload = WORKLOADS[name](options, state)
    nem, nem_gen = nemesis_axis(options.get("nemesis"))
    body = workload["generator"]
    if nem_gen is not None:
        body = gen.nemesis(nem_gen, body)
    generator = gen.time_limit(options.get("time-limit", 60), body)
    checker = cc.compose({
        "workload": workload["checker"],
        "stats": cks.stats(),
        "exceptions": cks.unhandled_exceptions(),
    })
    test = {
        "name": f"demo-{name}" + (f"-{options['bug']}"
                                  if options.get("bug") else ""),
        "nodes": options["nodes"],
        "concurrency": concurrency,
        "ssh": options.get("ssh", {"dummy?": True}),
        "os": os_noop,
        "db": DemoDB(state),
        "nemesis": nem,
        "client": workload["client"],
        "generator": generator,
        "checker": checker,
        "leave-db-running?": options.get("leave-db-running?", False),
        "logging-json?": options.get("logging-json?", False),
    }
    # harness knobs flow straight from the parsed CLI options onto the
    # test-map keys core.run/interpreter/monitor watch (the robustness
    # flags previously never reached the demo test map at all)
    for k in ("op-timeout-ms", "time-limit-s", "abort-grace-s",
              "monitor", "monitor-chunk", "searchplan?", "device",
              "searchplan-partitions", "searchplan-min-segment",
              "profile?", "profile-dir", "profile-max-s",
              "progress-interval-s", "telemetry-flush-ms"):
        if options.get(k) is not None:
            test[k] = options[k]
    # transactional workloads monitor through the txn family: normalize
    # test["monitor"] to a dict and route it to monitor/txn.py (the WGL
    # path would find no linearizable gate in the cycle checker tree)
    if test.get("monitor") and name in TXN_WORKLOADS:
        mcfg = _monitor_map(test["monitor"])
        mcfg.setdefault("family", "txn")
        mcfg.setdefault("workload", name)
        if options.get("skew-bound-s"):
            # e.g. planted by the txn-skew chaos profile: history
            # times are ns, the bound arrives in seconds
            mcfg.setdefault("skew-bound",
                            int(float(options["skew-bound-s"]) * 1e9))
        test["monitor"] = mcfg
    if test.get("monitor") and options.get("device") is not None:
        # the monitor's device checks run where the checkers do
        mcfg = _monitor_map(test["monitor"])
        mcfg["engine-opts"] = {**(mcfg.get("engine-opts") or {}),
                               "device": options["device"]}
        test["monitor"] = mcfg
    if name == "bank":
        # the workload bundle already carries the generator's constants
        test.update({k: workload[k] for k in ("accounts", "total-amount",
                                              "max-transfer")})
    return test
