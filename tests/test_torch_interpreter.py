"""The port's interpreter with fake in-process clients: the JAX package's
cases (``tests/test_interpreter.py``, after the reference's
test/jepsen/generator/interpreter_test.clj) against
``jepsen_tpu_torch.interpreter``."""

import time

from jepsen_tpu_torch import client as jc
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import interpreter, nemesis


class OkClient(jc.Client):
    """Sleeps 5 ms and returns ok (interpreter_test.clj:18-34)."""

    def invoke(self, test, op):
        time.sleep(0.005)
        out = dict(op)
        out["type"] = "ok"
        return out


class CrashClient(jc.Client):
    def __init__(self, counter):
        self.counter = counter

    def open(self, test, node):
        self.counter["opens"] += 1
        return self

    def close(self, test):
        self.counter["closes"] += 1

    def invoke(self, test, op):
        raise RuntimeError("boom")


def _base_test(**kw):
    t = {"concurrency": 4, "nodes": ["n1", "n2"],
         "client": OkClient(), "nemesis": nemesis.noop,
         "generator": None}
    t.update(kw)
    return t


def test_simple_run():
    test = _base_test(
        generator=gen.clients(gen.limit(20, gen.repeat({"f": "read"}))))
    h = interpreter.run(test)
    invokes = [o for o in h if o["type"] == "invoke"]
    oks = [o for o in h if o["type"] == "ok"]
    assert len(invokes) == 20
    assert len(oks) == 20
    # times are monotone nondecreasing
    times = [o["time"] for o in h]
    assert times == sorted(times)
    # each completion pairs with its invocation by process
    open_ = {}
    for o in h:
        if o["type"] == "invoke":
            assert o["process"] not in open_
            open_[o["process"]] = o
        else:
            inv = open_.pop(o["process"])
            assert inv["f"] == o["f"]


def test_crash_reassigns_process():
    counter = {"opens": 0, "closes": 0}
    test = _base_test(
        client=CrashClient(counter),
        generator=gen.clients(gen.limit(8, gen.repeat({"f": "read"}))))
    h = interpreter.run(test)
    infos = [o for o in h if o["type"] == "info"]
    assert len(infos) == 8
    procs = {o["process"] for o in h if o["type"] == "invoke"}
    assert len(procs) == 8  # every crash burns a process id
    # crashed clients are closed and fresh ones opened per process
    assert counter["opens"] == 8
    assert counter["closes"] >= 7


def test_nemesis_routing():
    class RecordingNemesis(nemesis.Nemesis):
        def __init__(self):
            self.ops = []

        def invoke(self, test, op):
            self.ops.append(op)
            out = dict(op)
            out["type"] = "info"
            return out

    nem = RecordingNemesis()
    test = _base_test(
        nemesis=nem,
        generator=gen.any(
            gen.clients(gen.limit(4, gen.repeat({"f": "read"}))),
            gen.nemesis(gen.limit(2, gen.repeat({"f": "break"})))))
    h = interpreter.run(test)
    assert len(nem.ops) == 2
    assert all(o["process"] == "nemesis" for o in nem.ops)
    nem_ops = [o for o in h if o["process"] == "nemesis"]
    assert len(nem_ops) == 4  # 2 invokes + 2 infos


def test_time_limited_run():
    test = _base_test(
        generator=gen.clients(
            gen.time_limit(0.3, gen.repeat({"f": "read"}))))
    t0 = time.monotonic()
    h = interpreter.run(test)
    dt = time.monotonic() - t0
    assert dt < 5
    assert len(h) > 0


def test_sleep_and_log_excluded_from_history():
    test = _base_test(
        generator=gen.clients([gen.log("hi"), gen.sleep(0.01),
                               {"f": "read"}]))
    h = interpreter.run(test)
    assert all(o["type"] not in ("sleep", "log") for o in h)
    assert any(o.get("f") == "read" for o in h)


def test_generator_exception_propagates():
    def bad(test, ctx):
        raise ValueError("bad generator")

    test = _base_test(generator=gen.clients(bad))
    try:
        interpreter.run(test)
        raise AssertionError("expected exception")
    except RuntimeError as e:
        assert "bad generator" in str(e.__cause__ or e) or \
            "Generator threw" in str(e)
