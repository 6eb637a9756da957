"""The port's toystore suite on the control==node rig
(``jepsen_tpu_torch.suites.toystore``; ``tests/test_integration_local.py``
runs the JAX package's): live server processes deployed, daemonized,
killed, paused and log-snarfed through the port's real control path,
checked on ``device="cpu"``. Each run's nodes bind ports the kernel
finds free (``toystore.free_base_port``), clear of the JAX package's
tests' fixed ones (37110-37444), and every test leaves no daemon
behind."""

import os
import random
import subprocess
import sys

import pytest

from jepsen_tpu.suites import toystore as jtoystore
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch.checker import checkers
from jepsen_tpu_torch.suites import toystore


@pytest.fixture(autouse=True)
def _isolated_store(tmp_path, monkeypatch):
    from jepsen_tpu_torch import store
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    yield
    checkers.join_racers()
    # no server process of this test is left behind (axww: plain ps
    # truncates argv before the scratch path)
    left = os.popen(
        "ps axww -o args= | grep toystore.py | grep -v grep").read()
    assert str(tmp_path) not in left


def _opts(tmp_path, base_port=None, **kw):
    opts = {
        "nodes": ["n1", "n2", "n3"],
        "time-limit": 5,
        "base-port": base_port or toystore.free_base_port(3),
        "scratch-dir": str(tmp_path / "nodes"),
        "algorithm": "competition",
        "device": "cpu",
    }
    opts.update(kw)
    return opts


def _store_dir(test):
    import pathlib

    from jepsen_tpu_torch import store
    return pathlib.Path(store.path(test))


def test_server_and_rig_are_the_reference_copies():
    """The port deploys the same server and names runs the same way;
    only its default base port differs, so the two packages' default
    rigs never clear each other's daemons."""
    assert toystore.SERVER_SRC == jtoystore.SERVER_SRC
    assert sorted(toystore.WORKLOADS) == sorted(jtoystore.WORKLOADS)
    assert toystore.BASE_PORT != jtoystore.BASE_PORT
    test = {"nodes": ["n1", "n2"], "base-port": 37390}
    assert toystore.peers(test) == jtoystore.peers(test)


def test_toystore_end_to_end_with_kill_nemesis(tmp_path):
    random.seed(45100)
    test = toystore.toystore_test(_opts(tmp_path,
                                        **{"nemesis-mode": "kill"}))
    test = core.run(test)
    res = test["results"]
    assert res["valid"] is True, res
    hist = test["history"]
    oks = [o for o in hist if o.get("type") == "ok"
           and o.get("process") != "nemesis"]
    assert len(oks) >= 20, "live ops actually ran"
    nem = [o for o in hist if o.get("process") == "nemesis"
           and o.get("type") == "info" and o.get("f") == "start"]
    assert nem, "nemesis ran"
    d = _store_dir(test)
    logs = [p for p in (d / "n1").glob("*") if p.name == "toystore.log"] \
        if (d / "n1").exists() else []
    assert logs and "boot node=0" in logs[0].read_text()


def test_toystore_stale_reads_detected(tmp_path):
    random.seed(45100)
    test = toystore.toystore_test(_opts(
        tmp_path, concurrency=6, stale=True,
        **{"nemesis-mode": "none", "time-limit": 8}))
    assert test["name"] == "toystore stale"
    test = core.run(test)
    res = test["results"]
    assert res["valid"] is False, res
    lin = res["linear"]
    assert lin["op"]["f"] in ("read", "cas")
    assert lin["final_paths"], "witness path attached"


def test_daemon_helpers_against_live_process(tmp_path):
    from jepsen_tpu_torch.control import util as cu
    test = {"nodes": ["n1"], "ssh": {"local?": True}}
    script = tmp_path / "spin.sh"
    script.write_text("#!/bin/bash\nwhile true; do sleep 0.2; done\n")
    script.chmod(0o755)
    pidfile = str(tmp_path / "spin.pid")
    with core.with_sessions(test):
        with c.on("n1"):
            assert cu.start_daemon(str(script), pidfile=pidfile,
                                   logfile=str(tmp_path / "spin.log"))
            assert cu.daemon_running(pidfile)
            cu.stop_daemon(pidfile=pidfile)
            assert not cu.daemon_running(pidfile)


def _zombie(zdir, port):
    """A toystore server started outside the rig from ``zdir``, up and
    holding key x = 9 on ``port``."""
    import socket as _socket
    import time as _time
    zdir.mkdir(parents=True)
    (zdir / "toystore.py").write_text(toystore.SERVER_SRC)
    z = subprocess.Popen(
        [sys.executable, str(zdir / "toystore.py"), "--port", str(port),
         "--node-id", "0", "--peers", "", "--data-dir", str(zdir)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    for _ in range(50):
        try:
            with _socket.create_connection(("127.0.0.1", port), 1) as s:
                s.sendall(b"W x 9\n")
                assert s.makefile().readline().strip() == "OK"
            return z
        except OSError:
            _time.sleep(0.1)
    z.kill()
    z.wait()
    pytest.fail("zombie never came up")


def test_toystore_setup_clears_zombie_daemons(tmp_path):
    """A daemon an earlier run of the same scratch dir left on its port
    is cleared by setup (its path marker), and the run is valid."""
    base = toystore.free_base_port(3)
    z = _zombie(tmp_path / "nodes" / "n1", base)
    try:
        random.seed(45100)
        test = toystore.toystore_test(_opts(tmp_path, base))
        test = core.run(test)
        assert test["results"]["valid"] is True, test["results"]
        assert z.poll() is not None, \
            f"setup must have killed zombie pid {z.pid}"
    finally:
        if z.poll() is None:
            z.kill()
            z.wait()


def test_toystore_setup_refuses_another_runs_port(tmp_path):
    """A server of another run (another scratch dir) on a node's port is
    left alone: setup raises naming the port, and that server lives on."""
    base = toystore.free_base_port(3)
    z = _zombie(tmp_path / "other" / "n1", base)
    try:
        test = toystore.toystore_test(_opts(tmp_path, base))
        with pytest.raises(Exception, match=f"port {base} is taken"):
            core.run(test)
        assert z.poll() is None, "another run's server must live on"
    finally:
        z.kill()
        z.wait()


def test_free_base_port_is_bindable_and_clear_of_fixed_ports():
    import socket as _socket
    base = toystore.free_base_port(3)
    assert not set(range(base, base + 3)) & set(toystore.FIXED_PORTS)
    for p in range(base, base + 3):
        with _socket.socket() as s:
            s.bind(("127.0.0.1", p))


def test_toystore_pause_nemesis(tmp_path):
    random.seed(45100)
    test = toystore.toystore_test(_opts(
        tmp_path, **{"nemesis-mode": "pause", "time-limit": 5}))
    test = core.run(test)
    assert test["results"]["valid"] is True, test["results"]


def test_toystore_set_workload_end_to_end(tmp_path):
    test = toystore.toystore_test(_opts(tmp_path, **{
        "workload": "set", "nemesis-mode": "pause", "time-limit": 4}))
    test = core.run(test)
    res = test["results"]
    assert res["valid"] is True, res
    assert res["lost-count"] == 0
    assert res["ok-count"] >= 5, res


def test_toystore_register_indep_workload(tmp_path):
    random.seed(45100)
    test = toystore.toystore_test(_opts(tmp_path, **{
        "workload": "register-indep", "nemesis-mode": "none",
        "concurrency": 4, "time-limit": 4, "ops-per-key": 12}))
    test = core.run(test)
    res = test["results"]
    assert res["valid"] is True, res
    assert res["results"], "per-key verdicts present"


def test_toystore_without_a_device_means_cuda(tmp_path):
    """The register workloads resolve their device before any daemon
    starts: without a card the default raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the suite resolves CUDA")
    opts = _opts(tmp_path)
    opts.pop("device")
    with pytest.raises(RuntimeError, match="CUDA"):
        toystore.toystore_test(opts)


def test_cli_stale_run_exits_one(tmp_path):
    """``python -m jepsen_tpu_torch.suites.toystore test --stale`` exits
    1 with the linearizability checker's invalid verdict."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.suites.toystore", "test",
         "--node", "n1", "--node", "n2", "--node", "n3",
         "--time-limit", "6", "--concurrency", "6", "--stale",
         "--nemesis-mode", "none", "--base-port",
         str(toystore.free_base_port(3)),
         "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert r.returncode == 1, r.stdout[-2000:] + r.stderr[-2000:]
