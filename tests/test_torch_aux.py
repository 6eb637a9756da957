"""The port's leaves ``fs_cache``, ``codec``, ``report`` and ``repl`` held
against the JAX package's (``tests/test_aux.py``, ``tests/test_misc.py``):
the same cache file names, encodings, deploy command streams, codec
bytes, report output and stored-test reads."""

import threading
import time as wall

import pytest

from jepsen_tpu import codec as jcodec
from jepsen_tpu import control as jc
from jepsen_tpu import fs_cache as jfs
from jepsen_tpu import report as jreport
from jepsen_tpu import repl as jrepl
from jepsen_tpu import store as jstore
from jepsen_tpu_torch import codec as tcodec
from jepsen_tpu_torch import control as tc
from jepsen_tpu_torch import fs_cache as tfs
from jepsen_tpu_torch import report as treport
from jepsen_tpu_torch import repl as trepl
from jepsen_tpu_torch import store as tstore

PATHS = [["foo"], ["foo", "bar"], [1], [True], ["a/b"], [1.5],
         ["db", 7, False, "x\\y"]]


@pytest.fixture(autouse=True)
def cache_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(tfs, "dir", str(tmp_path / "cache"))
    monkeypatch.setattr(jfs, "dir", str(tmp_path / "cache"))


def dummy_test(nodes=("n1",)):
    return {"nodes": list(nodes), "ssh": {"dummy?": True},
            "dummy-log": []}


# -- fs-cache ----------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS, ids=str)
def test_path_encoding_equals_the_reference(path):
    assert tfs.fs_path(path) == jfs.fs_path(path)
    assert tfs.file(path) == jfs.file(path)


def test_path_encoding_distinguishes_types_and_nesting():
    assert tfs.fs_path(["foo"]) == ["fs_foo"]
    assert tfs.fs_path(["foo", "bar"]) == ["ds_foo", "fs_bar"]
    assert tfs.fs_path([1]) == ["fl_1"]
    assert tfs.fs_path([True]) == ["fb_true"]
    assert tfs.fs_path(["a/b"]) == ["fs_a\\/b"]
    for fs in (tfs, jfs):
        with pytest.raises(ValueError):
            fs.fs_path([])
        with pytest.raises(TypeError):
            fs.fs_path("not-a-seq")
        with pytest.raises(TypeError):
            fs.fs_path([None])


def test_string_roundtrip_and_cached():
    path = ["db", "license"]
    assert not tfs.cached(path)
    assert tfs.load_string(path) is None
    assert tfs.save_string("sekrit", path) == "sekrit"
    assert tfs.cached(path)
    assert tfs.load_string(path) == "sekrit"
    # one directory, one encoding: the reference reads it back
    assert jfs.load_string(path) == "sekrit"
    tfs.clear(path)
    assert not tfs.cached(path) and not jfs.cached(path)


def test_data_roundtrip():
    data = {"nodes": ["a", "b"], "epoch": 3}
    tfs.save_data(data, ["cluster", "state"])
    assert tfs.load_data(["cluster", "state"]) == data
    jfs.save_data(data, ["cluster", "other"])
    assert tfs.load_data(["cluster", "other"]) == data
    assert tfs.load_data(["cluster", "none"]) is None


def test_file_roundtrip(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"\x00\x01binary")
    assert tfs.save_file(str(src), ["blobs", 7]) == str(src)
    f = tfs.load_file(["blobs", 7])
    assert f is not None and f == jfs.load_file(["blobs", 7])
    with open(f, "rb") as fh:
        assert fh.read() == b"\x00\x01binary"


def test_clear_all():
    tfs.save_string("x", ["one"])
    tfs.save_string("y", ["two"])
    tfs.clear()
    assert not tfs.cached(["one"])
    assert not tfs.cached(["two"])


def test_locking_serializes():
    order = []

    def worker(i):
        with tfs.locking(["expensive"]):
            order.append(("in", i))
            wall.sleep(0.05)
            order.append(("out", i))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for a, b in zip(order[::2], order[1::2]):
        assert a[0] == "in" and b[0] == "out" and a[1] == b[1]


def test_deploy_remote_guards_suspicious_paths():
    tfs.save_string("x", ["d"])
    with pytest.raises(ValueError, match="suspicious"):
        tfs.deploy_remote(["d"], "/etc")
    with pytest.raises(RuntimeError, match="not cached"):
        tfs.deploy_remote(["nope"], "/var/lib/db/data")


def test_deploy_remote_command_stream():
    """The same command stream through each package's control plane."""
    tfs.save_string("data", ["deployable"])
    logs = {}
    for name, fs, c in (("torch", tfs, tc), ("jax", jfs, jc)):
        test = dummy_test()
        with c.ssh_scope(test), c.on("n1"):
            fs.deploy_remote(["deployable"], "/var/lib/db/data")
        logs[name] = [cmd for _, cmd in test["dummy-log"]]
    assert logs["torch"] == logs["jax"]
    cmds = logs["torch"]
    assert any("rm -rf /var/lib/db/data" in x for x in cmds)
    assert any("mkdir -p /var/lib/db" in x for x in cmds)
    assert any(x.startswith("upload") for x in cmds)


def test_save_remote_downloads_into_the_cache():
    test = dummy_test()
    with tc.ssh_scope(test), tc.on("n1"):
        assert tfs.save_remote("/var/log/db.log", ["logs", "n1"]) \
            == "/var/log/db.log"
    assert any(cmd.startswith("download")
               for _, cmd in test["dummy-log"])


# -- codec, report, repl ----------------------------------------------------

@pytest.mark.parametrize("value", [None, {"a": [1, 2]}, [1, "x", None],
                                   "s", 3, 2.5, True])
def test_codec_bytes_equal_the_reference(value):
    assert tcodec.encode(value) == jcodec.encode(value)
    assert tcodec.decode(tcodec.encode(value)) \
        == jcodec.decode(jcodec.encode(value))


def test_codec_roundtrip():
    assert tcodec.decode(tcodec.encode({"a": [1, 2]})) == {"a": [1, 2]}
    assert tcodec.encode(None) == b""
    assert tcodec.decode(b"") is None
    assert tcodec.decode(None) is None
    assert tcodec.decode(bytearray(b"[1]")) == [1]
    assert tcodec.decode('{"k": 1}') == {"k": 1}


def test_report_to(tmp_path, capsys):
    outs = {}
    for name, rep in (("torch", treport), ("jax", jreport)):
        p = tmp_path / name / "out" / "summary.txt"
        with rep.to(str(p)):
            print("all good")
        outs[name] = (p.read_text(),
                      capsys.readouterr().out.replace(str(p), "P"))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"] == ("all good\n", "Report written to P\n")


def test_repl_reads_the_latest_test(tmp_path, monkeypatch):
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path / "store"))
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path / "store"))
    assert trepl.latest_test() is None
    assert trepl.latest_history() is None
    test = {"name": "repl", "start-time": "20260729T000000.000000+0000",
            "history": [{"index": 0, "type": "invoke", "f": "read",
                         "value": None, "process": 0}],
            "nodes": ["n1"]}
    tstore.save_1(test)
    tstore.update_symlinks(test)
    got = trepl.latest_history()
    assert got == jrepl.latest_history()
    assert [o["f"] for o in got] == ["read"]
    assert trepl.latest_test()["name"] == "repl"
