"""The port's zookeeper suite and its jute wire protocol
(``jepsen_tpu_torch.suites.{zookeeper,zk_proto}``) held against the JAX
package's: the hand-assembled golden frames of ``tests/test_wire_golden.py``
byte for byte, each package's client against the other's protocol
server, the same DB command streams, and the suite end to end on
``device="cpu"`` (``tests/test_suite_zookeeper.py``)."""

import random
import socket
import struct

import pytest

import test_wire_golden as golden
from jepsen_tpu import control as jc
from jepsen_tpu.suites import zk_proto as jzk
from jepsen_tpu.suites import zookeeper as jzkmod
from jepsen_tpu_torch import control as tc
from jepsen_tpu_torch import core, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import checkers
from jepsen_tpu_torch.suites import zk_proto as tzk
from jepsen_tpu_torch.suites import zookeeper as zk

SIDES = (("torch", tzk), ("jax", jzk))


@pytest.fixture(autouse=True)
def store_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    yield
    # the competition's losing racers end at their next chunk: join them
    # here, so none is still running when the worker exits
    checkers.join_racers()


def _transcript(proto):
    """Drive one package's client through the golden script; returns the
    bytes it sent and what it decoded."""
    srv = golden._ScriptedZkServer([
        (len(golden.CONNECT_REQ), golden.CONNECT_RESP),
        (len(golden.CREATE_REQ), golden.CREATE_RESP),
        (len(golden.GETDATA_REQ), golden.WATCH_EVENT + golden.GETDATA_RESP),
        (len(golden.SETDATA_REQ), golden.BADVERSION_RESP),
    ])
    c = proto.ZkWireClient("127.0.0.1", srv.port)
    seen = [c.session_id, c.negotiated_timeout,
            c.create("/jepsen", b"0"), c.get_data("/jepsen")]
    with pytest.raises(proto.ZkError) as ei:
        c.set_data("/jepsen", b"6", version=7)
    seen.append(ei.value.code)
    c.sock.close()
    srv.join()
    return srv.got, seen


def test_zk_jute_golden_transcript():
    got, seen = _transcript(tzk)
    assert got == [golden.CONNECT_REQ, golden.CREATE_REQ,
                   golden.GETDATA_REQ, golden.SETDATA_REQ]
    sid, timeout, path, (data, stat), err = seen
    assert (sid, timeout, path, data) == (0x1234, 10_000, "/jepsen", b"5")
    assert stat["version"] == 7 and stat["czxid"] == 1
    assert stat["dataLength"] == 1 and stat["pzxid"] == 2
    assert err == tzk.BAD_VERSION
    # the same frames and the same decoded values as the reference
    assert (got, seen) == _transcript(jzk)


@pytest.mark.parametrize("value", [
    ("int", 0), ("int", -103), ("int", 2 ** 31 - 1), ("long", -1),
    ("long", 2 ** 40 + 7), ("bool", True), ("bool", False),
    ("buffer", b""), ("buffer", None), ("buffer", b"\x00\xff"),
    ("string", "/jepsen"), ("string", "ünïcode"),
])
def test_jute_primitives_encode_byte_equal(value):
    kind, v = value
    out = []
    for _name, proto in SIDES:
        enc = proto._Enc()
        getattr(enc, kind)(v)
        raw = bytes(enc.b)
        dec = proto._Dec(raw)
        out.append((raw, getattr(dec, kind)()))
    assert out[0] == out[1]


def test_stat_bytes_equal_the_reference():
    for args in ((0, 0, 0), (7, 1, 2), (2 ** 31 - 1, 5, 2 ** 40)):
        assert tzk._stat_bytes(*args) == jzk._stat_bytes(*args)
    assert tzk.OPEN_ACL == jzk.OPEN_ACL
    assert (tzk.OK, tzk.NO_NODE, tzk.BAD_VERSION, tzk.NODE_EXISTS) \
        == (jzk.OK, jzk.NO_NODE, jzk.BAD_VERSION, jzk.NODE_EXISTS)


def test_fake_zk_server_decodes_golden_requests():
    srv = tzk.FakeZkServer()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), 5.0)
        s.settimeout(5.0)

        def frame(raw):
            s.sendall(raw)
            (n,) = struct.unpack(">i", tzk._recv_exact(s, 4))
            return tzk._Dec(tzk._recv_exact(s, n))

        d = frame(golden.CONNECT_REQ)
        d.int()
        assert d.int() == 10_000
        d = frame(golden.CREATE_REQ)
        assert (d.int(), d.long(), d.int())[2] == tzk.OK
        assert d.string() == "/jepsen"
        d = frame(golden.GETDATA_REQ)
        assert (d.int(), d.long(), d.int())[2] == tzk.OK
        assert d.buffer() == b"0"
        assert d.stat()["version"] == 0
        d = frame(golden.SETDATA_REQ)
        assert (d.int(), d.long(), d.int())[2] == tzk.BAD_VERSION
        s.close()
    finally:
        srv.close()


def _roundtrip(client_proto, server_proto):
    srv = server_proto.FakeZkServer()
    out = []
    try:
        c1 = client_proto.ZkWireClient("127.0.0.1", srv.port)
        out.append(c1.create("/jepsen", b"0"))
        try:
            c1.create("/jepsen", b"1")
        except client_proto.ZkError as e:
            out.append(e.code)
        out.append(c1.get_data("/jepsen"))
        c1.set_data("/jepsen", b"3")
        out.append(c1.get_data("/jepsen"))
        c1.set_data("/jepsen", b"4", version=1)
        for args in (("/jepsen", b"5", 1),):
            try:
                c1.set_data(*args[:2], version=args[2])
            except client_proto.ZkError as e:
                out.append(e.code)
        try:
            c1.get_data("/missing")
        except client_proto.ZkError as e:
            out.append(e.code)
        c1.close()
    finally:
        srv.close()
    return out


@pytest.mark.parametrize("client,server", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_wire_client_against_protocol_server(client, server):
    """Create, get, set and version-guarded CAS over real sockets, each
    package's client against each package's server: the same answers
    as the reference's pair."""
    protos = dict(SIDES)
    got = _roundtrip(protos[client], protos[server])
    assert got == _roundtrip(jzk, jzk)
    assert got[1] == tzk.NODE_EXISTS
    assert got[2][0] == b"0" and got[2][1]["version"] == 0
    assert got[3][0] == b"3" and got[3][1]["version"] == 1
    assert got[4:] == [tzk.BAD_VERSION, tzk.NO_NODE]


def test_zoo_cfg_and_node_ids():
    test = {"nodes": ["n1", "n2", "n3"]}
    assert zk.zk_node_ids(test) == jzkmod.zk_node_ids(test) \
        == {"n1": 0, "n2": 1, "n3": 2}
    assert zk.zoo_cfg_servers(test) == jzkmod.zoo_cfg_servers(test)
    assert zk.ZOO_CFG == jzkmod.ZOO_CFG and zk.VERSION == jzkmod.VERSION


def test_db_setup_command_stream():
    logs = {}
    for name, mod, c in (("torch", zk, tc), ("jax", jzkmod, jc)):
        test = {"nodes": ["n1", "n2"], "ssh": {"dummy?": True}}
        db = mod.ZkDB()
        with c.ssh_scope(test), c.on("n2"):
            with pytest.raises(RuntimeError,
                               match="mktemp returned|extracted nothing"):
                db.setup(test, "n2")
            db.teardown(test, "n2")
        logs[name] = [cmd for _, cmd in test["dummy-log"]]
        assert db.log_files(test, "n2") \
            == ["/opt/zookeeper/logs/zookeeper.log"]
    assert logs["torch"] == logs["jax"]
    cmds = logs["torch"]
    assert any("wget-cache" in x for x in cmds)
    assert not any("mv /*" in x for x in cmds)
    assert any("zkServer.sh stop" in x for x in cmds)


def test_stub_end_to_end_with_partitions():
    random.seed(45100)
    t = zk.zk_test({"nodes": ["n1", "n2", "n3"], "stub": True,
                    "concurrency": 6, "time-limit": 7, "device": "cpu"})
    done = core.run(t)
    res = done["results"]
    assert res["linear"]["valid"] is True
    nem_fs = {o["f"] for o in done["history"]
              if o.get("process") == "nemesis"}
    assert "start" in nem_fs
    cmds = [cmd for _, cmd in done.get("dummy-log", [])]
    assert any("iptables" in x for x in cmds)


def test_cli_main_stub():
    random.seed(45100)
    with pytest.raises(SystemExit) as exc:
        zk.main(["test", "--stub", "--node", "n1", "--node", "n2",
                 "--time-limit", "2", "--concurrency", "4",
                 "--device", "cpu"])
    assert exc.value.code == 0
    assert store.latest()["results"]["valid"] is True


def test_without_a_device_means_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the suite resolves CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        zk.zk_test({"nodes": ["n1"], "stub": True})


def test_zk_suite_live_against_protocol_server():
    srv = tzk.FakeZkServer()
    try:
        random.seed(45100)
        t = zk.zk_test({"nodes": ["127.0.0.1"], "stub": True,
                        "concurrency": 4, "time-limit": 4,
                        "device": "cpu"})
        t["client"] = zk.ZkClient()
        t["zk-port"] = srv.port
        t["generator"] = gen.time_limit(
            4, gen.clients(gen.stagger(
                0.02, gen.mix([zk.r, zk.w, zk.cas]))))
        done = core.run(t)
        res = done["results"]
        assert res["linear"]["valid"] is True, res
        oks = [o for o in done["history"] if o.get("type") == "ok"
               and o.get("process") != "nemesis"]
        assert len(oks) >= 10
    finally:
        srv.close()
