"""The port's host checkers ``queue``, ``set_full``, ``total_queue`` (with
``expand_queue_drain_ops``), ``unique_ids``, ``counter`` and
``log_file_pattern`` held against the JAX package's on the cases of
``tests/test_checkers.py``, with tolerance zero: the same verdict maps
from the same histories, over each package's own host models."""

import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import models as jmodels
from jepsen_tpu import store as jstore
from jepsen_tpu.checker import checkers as jck
from jepsen_tpu.checker import core as jcore
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.checker import checkers as tck
from jepsen_tpu_torch.checker import core as tcore

inv = th.invoke_op
ok = th.ok_op
MS = 1_000_000


def fail(process, f, value=None, **kw):
    return th.op("fail", process, f, value, **kw)


def info(process, f, value=None, **kw):
    return th.op("info", process, f, value, **kw)


def _t(o, t):
    o = dict(o)
    o["time"] = t
    return o


def _plain(x):
    """A verdict map as compared: host model objects by type and
    fields (each package has its own classes)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return (type(x).__name__, _plain(vars(x)))
    return x


#: (case, checker factory and its args, history)
CASES = [
    ("queue-empty", ("queue", None), []),
    ("queue-possible-enqueue", ("queue", "unordered"),
     [inv(1, "enqueue", 1)]),
    ("queue-definite-enqueue", ("queue", "unordered"),
     [ok(1, "enqueue", 1)]),
    ("queue-concurrent", ("queue", "unordered"),
     [inv(2, "dequeue"), inv(1, "enqueue", 1), ok(2, "dequeue", 1)]),
    ("queue-dequeue-without-enqueue", ("queue", "unordered"),
     [ok(1, "dequeue", 1)]),
    ("queue-fifo-order", ("queue", "fifo"),
     [inv(1, "enqueue", 1), inv(1, "enqueue", 2), ok(2, "dequeue", 2)]),
    ("total-queue-sane", ("total_queue",),
     [inv(1, "enqueue", 1), inv(2, "enqueue", 2), ok(2, "enqueue", 2),
      inv(3, "dequeue", 1), ok(3, "dequeue", 1), inv(3, "dequeue", 2),
      ok(3, "dequeue", 2)]),
    ("total-queue-pathological", ("total_queue",),
     [inv(1, "enqueue", "hung"), inv(2, "enqueue", "enqueued"),
      ok(2, "enqueue", "enqueued"), inv(3, "enqueue", "dup"),
      ok(3, "enqueue", "dup"), inv(4, "dequeue"), inv(5, "dequeue"),
      ok(5, "dequeue", "wtf"), inv(6, "dequeue"), ok(6, "dequeue", "dup"),
      inv(7, "dequeue"), ok(7, "dequeue", "dup")]),
    ("total-queue-drain", ("total_queue",),
     [inv(1, "enqueue", 1), ok(1, "enqueue", 1), inv(1, "enqueue", 2),
      ok(1, "enqueue", 2), inv(2, "drain"), ok(2, "drain", [1, 2])]),
    ("counter-empty", ("counter",), []),
    ("counter-initial-read", ("counter",),
     [inv(0, "read"), ok(0, "read", 0)]),
    ("counter-ignores-failed", ("counter",),
     [inv(0, "add", 1), fail(0, "add", 1), inv(0, "read"),
      ok(0, "read", 0)]),
    ("counter-initial-invalid", ("counter",),
     [inv(0, "read"), ok(0, "read", 1)]),
    ("counter-interleaved", ("counter",),
     [inv(0, "read"), inv(1, "add", 1), inv(2, "read"), inv(3, "add", 2),
      inv(4, "read"), inv(5, "add", 4), inv(6, "read"), inv(7, "add", 8),
      inv(8, "read"), ok(0, "read", 6), ok(1, "add", 1),
      ok(2, "read", 0), ok(3, "add", 2), ok(4, "read", 3),
      ok(5, "add", 4), ok(6, "read", 100), ok(7, "add", 8),
      ok(8, "read", 15)]),
    ("counter-rolling", ("counter",),
     [inv(0, "add", 1), ok(0, "add", 1), inv(0, "read"), ok(0, "read", 1),
      inv(0, "add", 2), ok(0, "add", 2), inv(0, "read"), ok(0, "read", 3),
      inv(0, "add", 5), info(0, "add", 5), inv(1, "read"),
      ok(1, "read", 8)]),
    ("counter-negative-adds", ("counter",),
     [inv(0, "add", -2), ok(0, "add", -2), inv(0, "read"),
      ok(0, "read", -2), inv(1, "add", -3), inv(2, "read"),
      ok(2, "read", -4)]),
    ("set-full-stable", ("set_full",),
     [_t(inv(0, "add", 0), 0), _t(ok(0, "add", 0), 1),
      _t(inv(1, "read"), 2), _t(ok(1, "read", [0]), 3)]),
    ("set-full-lost", ("set_full",),
     [_t(inv(0, "add", 0), 0), _t(ok(0, "add", 0), 1),
      _t(inv(1, "read"), 2), _t(ok(1, "read", [0]), 3),
      _t(inv(1, "read"), 4), _t(ok(1, "read", []), 5)]),
    ("set-full-never-read", ("set_full",),
     [_t(inv(0, "add", 0), 0), _t(ok(0, "add", 0), 1)]),
    ("set-full-duplicate", ("set_full",),
     [_t(inv(0, "add", 0), 0), _t(ok(0, "add", 0), 1),
      _t(inv(1, "read"), 2), _t(ok(1, "read", [0, 0]), 3)]),
    ("set-full-linearizable-stale", ("set_full", {"linearizable?": True}),
     [_t(inv(0, "add", 0), 0), _t(ok(0, "add", 0), 10 * MS),
      _t(inv(1, "read"), 20 * MS), _t(ok(1, "read", []), 30 * MS),
      _t(inv(1, "read"), 40 * MS), _t(ok(1, "read", [0]), 50 * MS)]),
    ("set-full-eventual-stale", ("set_full",),
     [_t(inv(0, "add", 0), 0), _t(ok(0, "add", 0), 10 * MS),
      _t(inv(1, "read"), 20 * MS), _t(ok(1, "read", []), 30 * MS),
      _t(inv(1, "read"), 40 * MS), _t(ok(1, "read", [0]), 50 * MS)]),
    ("unique-ids-ok", ("unique_ids",),
     [inv(0, "generate"), ok(0, "generate", 0), inv(0, "generate"),
      ok(0, "generate", 1)]),
    ("unique-ids-dup", ("unique_ids",),
     [inv(0, "generate"), ok(0, "generate", 0), inv(0, "generate"),
      ok(0, "generate", 0)]),
]


def _checker(ck, models, spec):
    name, *args = spec
    if name == "queue":
        model = {None: None, "unordered": models.unordered_queue,
                 "fifo": models.fifo_queue}[args[0]]
        return ck.queue(model() if model else None)
    return getattr(ck, name)(*args)


@pytest.mark.parametrize("case,spec,hist", CASES,
                         ids=[c[0] for c in CASES])
def test_host_checkers_equal_the_reference(case, spec, hist):
    got = tcore.check(_checker(tck, tmodels, spec), {}, hist, None)
    want = jcore.check(_checker(jck, jmodels, spec), {}, hist, None)
    assert _plain(got) == _plain(want)


def test_expected_verdicts_of_the_reference_cases():
    """The reference's own assertions on the port's outputs."""
    out = {c: tcore.check(_checker(tck, tmodels, s), {}, h, None)
           for c, s, h in CASES}
    assert out["queue-empty"]["valid"] is True
    assert out["queue-concurrent"]["valid"] is True
    assert out["queue-dequeue-without-enqueue"]["valid"] is False
    sane = out["total-queue-sane"]
    assert (sane["valid"], sane["recovered"], sane["ok-count"]) \
        == (True, {1: 1}, 2)
    path = out["total-queue-pathological"]
    assert (path["lost"], path["unexpected"], path["duplicated"]) \
        == ({"enqueued": 1}, {"wtf": 1}, {"dup": 1})
    assert out["counter-empty"] == {"valid": True, "reads": [],
                                    "errors": []}
    assert out["counter-initial-invalid"]["valid"] is False
    assert out["set-full-lost"]["lost"] == [0]
    assert out["set-full-never-read"]["valid"] == "unknown"
    assert out["set-full-duplicate"]["duplicated"] == {0: 2}
    assert out["set-full-linearizable-stale"]["stale"] == [0]
    assert out["set-full-eventual-stale"]["valid"] is True
    assert out["unique-ids-ok"]["range"] == [0, 1]
    assert out["unique-ids-dup"]["duplicated"] == {0: 2}


def test_expand_queue_drain_ops():
    hist = [inv(1, "drain"), ok(1, "drain", [1, 2]), inv(2, "drain"),
            fail(2, "drain")]
    got = tck.expand_queue_drain_ops(hist)
    assert got == jck.expand_queue_drain_ops(
        [dict(o) for o in hist])
    assert [(o["type"], o["f"], o.get("value")) for o in got] == [
        ("invoke", "dequeue", None), ("ok", "dequeue", 1),
        ("invoke", "dequeue", None), ("ok", "dequeue", 2)]
    for ck in (tck, jck):
        with pytest.raises(ValueError, match="crashed drain"):
            ck.expand_queue_drain_ops([info(1, "drain")])


def test_log_file_pattern(tmp_path, monkeypatch):
    monkeypatch.setattr(jstore, "base_dir", str(tmp_path))
    monkeypatch.setattr(tstore, "base_dir", str(tmp_path))
    ts = "20260729T000000.000000+0000"
    test = {"name": "lfp", "start-time": ts, "nodes": ["n1", "n2"]}
    node_dir = tmp_path / "lfp" / ts / "n1"
    node_dir.mkdir(parents=True)
    (node_dir / "db.log").write_text("ok line\npanic: boom\nok line\n")
    got = tcore.check(tck.log_file_pattern(r"panic", "db.log"), test, [],
                      None)
    assert got == jcore.check(jck.log_file_pattern(r"panic", "db.log"),
                              test, [], None)
    assert got["valid"] is False and got["count"] == 1
    assert got["matches"] == [{"node": "n1", "line": "panic: boom"}]


def test_log_file_pattern_no_store():
    for ck, core in ((tck, tcore), (jck, jcore)):
        r = core.check(ck.log_file_pattern(r"panic", "db.log"),
                       {"nodes": ["n1"]}, [], None)
        assert r["valid"] == "unknown"


def test_histories_helpers_agree():
    # the cases are built with the port's op helpers; the reference's
    # build the same maps
    assert inv(1, "enqueue", 1) == jh.invoke_op(1, "enqueue", 1)
    assert ok(1, "dequeue", 2) == jh.ok_op(1, "dequeue", 2)
