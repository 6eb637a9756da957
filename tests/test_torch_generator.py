"""The port's generator combinators via the simulated-time harness.

The first half is the JAX package's own generator cases
(``tests/test_generator.py``, which mirrors the reference's
generator_test.clj) run against ``jepsen_tpu_torch.generator``. The
second half, ``test_simulation_equals_jax``, drives the same
compositions through both packages' ``generator.testing.simulate`` under
``fixed_rand(45100)`` with ``random`` seeded alike, and requires equal
histories, op for op (tolerance: exact equality)."""

import random

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jindependent
from jepsen_tpu.generator import testing as jgt
from jepsen_tpu.tests import linearizable_register as jlr
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.generator import testing as gt
from jepsen_tpu_torch.tests import linearizable_register as lr


def invocations(h):
    return [o for o in h if o["type"] == "invoke"]


def test_nil_is_exhausted():
    assert gt.quick(None) == []


def test_map_is_one_shot():
    h = gt.quick({"f": "write", "value": 2})
    assert len(h) == 2  # invoke + ok
    assert h[0]["f"] == "write" and h[0]["type"] == "invoke"
    assert h[0]["time"] == 0
    assert h[1]["type"] == "ok"
    assert h[1]["time"] == gt.PERFECT_LATENCY


def test_sequence_chains():
    h = invocations(gt.quick([{"f": "a"}, {"f": "b"}, {"f": "c"}]))
    assert [o["f"] for o in h] == ["a", "b", "c"]


def test_function_generator():
    count = {"n": 0}

    def f():
        count["n"] += 1
        if count["n"] > 3:
            return None
        return {"f": "w", "value": count["n"]}

    h = invocations(gt.quick(f))
    assert [o["value"] for o in h] == [1, 2, 3]


def test_limit():
    h = invocations(gt.quick(gen.limit(3, gen.repeat({"f": "r"}))))
    assert len(h) == 3


def test_once():
    h = invocations(gt.quick(gen.once(gen.repeat({"f": "r"}))))
    assert len(h) == 1


def test_repeat_bounded():
    h = invocations(gt.quick(gen.repeat(5, {"f": "r"})))
    assert len(h) == 5
    assert all(o["f"] == "r" for o in h)


def test_mix_uses_all():
    g = gen.mix([gen.repeat(4, {"f": "a"}), gen.repeat(4, {"f": "b"})])
    h = invocations(gt.quick(g))
    fs = {o["f"] for o in h}
    assert fs == {"a", "b"}
    assert len(h) == 8


def test_filter():
    xs = [{"f": "w", "value": i} for i in range(8)]
    g = gen.filter(lambda op: op["value"] % 2 == 0, xs)
    h = invocations(gt.quick(g))
    assert [o["value"] for o in h] == [0, 2, 4, 6]


def test_map_transform():
    g = gen.map(lambda op: {**op, "value": op["value"] * 10},
                [{"f": "w", "value": 1}, {"f": "w", "value": 2}])
    h = invocations(gt.quick(g))
    assert [o["value"] for o in h] == [10, 20]


def test_f_map():
    g = gen.f_map({"start": "nem-start"}, [{"f": "start"}])
    h = invocations(gt.quick(g))
    assert h[0]["f"] == "nem-start"


def test_time_limit():
    # delay 1s between ops; time-limit 3s -> ops at 0,1,2 seconds
    g = gen.time_limit(3, gen.delay(1, gen.repeat({"f": "r"})))
    h = invocations(gt.quick(g))
    times = [o["time"] / 1e9 for o in h]
    assert times == [0.0, 1.0, 2.0]


def test_delay_spacing():
    g = gen.limit(4, gen.delay(0.5, gen.repeat({"f": "r"})))
    h = invocations(gt.quick(g))
    times = [o["time"] / 1e9 for o in h]
    assert times == [0.0, 0.5, 1.0, 1.5]


def test_stagger_rate():
    g = gen.time_limit(10, gen.stagger(1, gen.repeat({"f": "r"})))
    h = invocations(gt.quick(g))
    # ~1 op/sec for 10 seconds; random spacing in [0, 2s)
    assert 5 <= len(h) <= 20


def test_phases_barrier():
    g = gen.phases(gen.limit(4, gen.repeat({"f": "a"})),
                   gen.limit(2, gen.repeat({"f": "b"})))
    h = gt.quick(g)
    fs = [o["f"] for o in h]
    # every 'a' (invoke and completion) before any 'b'
    last_a = max(i for i, f in enumerate(fs) if f == "a")
    first_b = min(i for i, f in enumerate(fs) if f == "b")
    assert last_a < first_b


def test_then():
    g = gen.then(gen.once({"f": "b"}), gen.limit(2, gen.repeat({"f": "a"})))
    h = invocations(gt.quick(g))
    assert [o["f"] for o in h] == ["a", "a", "b"]


def test_clients_excludes_nemesis():
    g = gen.clients(gen.limit(6, gen.repeat({"f": "r"})))
    h = invocations(gt.quick(g))
    assert all(o["process"] != gen.NEMESIS for o in h)


def test_nemesis_routing():
    g = gen.nemesis(gen.limit(2, gen.repeat({"f": "break"})),
                    gen.limit(4, gen.repeat({"f": "r"})))
    h = invocations(gt.quick(g))
    by_f = {}
    for o in h:
        by_f.setdefault(o["f"], set()).add(o["process"])
    assert by_f["break"] == {gen.NEMESIS}
    assert gen.NEMESIS not in by_f["r"]


def test_each_thread():
    g = gen.clients(gen.each_thread(gen.once({"f": "hi"})))
    h = invocations(gt.quick(g))
    assert sorted(o["process"] for o in h) == [0, 1]


def test_reserve():
    test = {"concurrency": 4}
    g = gen.reserve(2, gen.limit(4, gen.repeat({"f": "w"})),
                    gen.limit(4, gen.repeat({"f": "r"})))
    with gen.fixed_rand():
        h = gt.simulate(test, gen.clients(g), gt.perfect)
    by_f = {}
    for o in h:
        if o["type"] == "invoke":
            by_f.setdefault(o["f"], set()).add(o["process"])
    assert by_f["w"] <= {0, 1}
    assert by_f["r"] <= {2, 3}


def test_until_ok():
    fails = {"n": 0}

    def completion(op):
        fails["n"] += 1
        comp = dict(op)
        comp["type"] = "fail" if fails["n"] < 3 else "ok"
        comp["time"] = op["time"] + 10
        return comp

    g = gen.until_ok(gen.repeat({"f": "w"}))
    with gen.fixed_rand():
        h = gt.simulate({"concurrency": 1}, gen.clients(g), completion)
    oks = [o for o in h if o["type"] == "ok"]
    assert len(oks) == 1
    # after the ok, no further invocations
    i_ok = h.index(oks[0])
    assert not any(o["type"] == "invoke" for o in h[i_ok + 1:])


def test_flip_flop():
    g = gen.limit(6, gen.flip_flop(gen.repeat({"f": "a"}),
                                   gen.repeat({"f": "b"})))
    h = invocations(gt.quick(g))
    assert [o["f"] for o in h] == ["a", "b", "a", "b", "a", "b"]


def test_process_limit():
    # all ops crash -> each op consumes a fresh process; limit 4 distinct
    # processes over concurrency 2
    g = gen.clients(gen.process_limit(4, gen.repeat({"f": "w"})))
    with gen.fixed_rand():
        h = gt.simulate({"concurrency": 2}, g, gt.perfect_info)
    procs = {o["process"] for o in h if o["type"] == "invoke"}
    assert len(procs) <= 4


def test_synchronize_waits():
    # one slow op on thread 0, then a synchronize barrier: the post-barrier
    # op must start only after the slow op completes
    def slow(op):
        comp = dict(op)
        comp["type"] = "ok"
        comp["time"] = op["time"] + 1000
        return comp

    g = gen.clients([gen.once({"f": "slow"}),
                     gen.synchronize(gen.once({"f": "after"}))])
    with gen.fixed_rand():
        h = gt.simulate({"concurrency": 2}, g, slow)
    slow_done = next(o for o in h if o["type"] == "ok" and o["f"] == "slow")
    after = next(o for o in h if o["type"] == "invoke"
                 and o["f"] == "after")
    assert after["time"] >= slow_done["time"]


def test_any_merges():
    g = gen.any(gen.limit(2, gen.repeat({"f": "a"})),
                gen.limit(2, gen.repeat({"f": "b"})))
    h = invocations(gt.quick(g))
    assert sorted(o["f"] for o in h) == ["a", "a", "b", "b"]


def test_validate_rejects_bad_op():
    g = gen.validate([{"f": "w", "type": "bogus"}])
    with pytest.raises(gen.InvalidOp):
        gt.quick(g)


def test_log_and_sleep_ops():
    # concurrency 1: the sleep must block the only client thread
    g = [gen.log("hello"), gen.sleep(1), {"f": "r"}]
    with gen.fixed_rand():
        h = gt.simulate({"concurrency": 1}, gen.clients(g), gt.perfect)
    assert h[0]["type"] == "log"
    assert h[1]["type"] == "sleep"
    r = next(o for o in h if o.get("f") == "r")
    assert r["time"] >= 1e9  # after the 1s sleep


def test_deterministic_with_seed():
    g = gen.time_limit(5, gen.stagger(0.5, gen.repeat({"f": "r"})))
    h1 = gt.quick(g)
    h2 = gt.quick(g)
    assert h1 == h2


def test_generation_rate():
    """Reference: >20k ops/s single-threaded generation
    (generator.clj:67-70). The simulator includes completion handling, so
    just assert we can push 20k ops through quickly."""
    import time
    g = gen.limit(20_000, gen.repeat({"f": "r"}))
    t0 = time.monotonic()
    h = gt.quick(g)
    dt = time.monotonic() - t0
    assert len(invocations(h)) == 20_000
    assert dt < 20, f"generator too slow: {20_000/dt:.0f} ops/s"

def test_cycle_advances_and_restarts():
    """cycle() drives a sequence to exhaustion and restarts it -- unlike
    repeat(), which never advances the underlying generator (the
    zookeeper-style sleep/start/sleep/stop schedule relies on this)."""
    from jepsen_tpu_torch.generator.testing import perfect, simulate
    g = gen.limit(6, gen.cycle({"f": "a"}, {"f": "b"}, {"f": "c"}))
    hist = simulate({"nodes": ["n1"], "concurrency": 1}, g, perfect)
    fs = [o["f"] for o in hist if o["type"] == "invoke"]
    assert fs == ["a", "b", "c", "a", "b", "c"]


def test_cycle_empty_template_terminates():
    from jepsen_tpu_torch.generator.testing import perfect, simulate
    hist = simulate({"nodes": ["n1"], "concurrency": 1},
                    gen.cycle(), perfect)
    assert hist == []


# ---------------------------------------------------------------------------
# parity with the JAX package's generators

PORT = {"gen": gen, "gt": gt, "independent": independent, "lr": lr}
JAX = {"gen": jgen, "gt": jgt, "independent": jindependent, "lr": jlr}


def _until_ok_completion(p):
    fails = {"n": 0}

    def completion(op):
        fails["n"] += 1
        comp = dict(op)
        comp["type"] = "fail" if fails["n"] < 3 else "ok"
        comp["time"] = op["time"] + 10
        return comp
    return completion


def _write(test=None, ctx=None):
    return {"f": "write", "value": random.randint(0, 4)}


#: name -> (test map, build(pkg) -> generator, completion(pkg) -> fn)
CASES = {
    "limit": ({"concurrency": 2}, lambda p: p["gen"].limit(
        5, p["gen"].repeat({"f": "r"})), lambda p: p["gt"].perfect),
    "mix": ({"concurrency": 3}, lambda p: p["gen"].clients(
        p["gen"].limit(30, p["gen"].mix([
            p["gen"].repeat({"f": "a"}), p["gen"].repeat({"f": "b"}),
            _write]))), lambda p: p["gt"].imperfect()),
    "reserve": ({"concurrency": 4}, lambda p: p["gen"].clients(
        p["gen"].reserve(2, p["gen"].limit(6, p["gen"].repeat({"f": "w"})),
                         p["gen"].limit(6, p["gen"].repeat({"f": "r"})))),
        lambda p: p["gt"].perfect),
    "each_thread": ({"concurrency": 3}, lambda p: p["gen"].clients(
        p["gen"].each_thread(p["gen"].limit(2, p["gen"].repeat(
            {"f": "hi"})))), lambda p: p["gt"].imperfect()),
    "phases_synchronize": ({"concurrency": 3}, lambda p: p["gen"].clients(
        p["gen"].phases(p["gen"].limit(4, p["gen"].repeat({"f": "a"})),
                        p["gen"].synchronize(p["gen"].limit(
                            3, p["gen"].repeat({"f": "b"}))))),
        lambda p: p["gt"].imperfect()),
    "stagger": ({"concurrency": 2}, lambda p: p["gen"].time_limit(
        5, p["gen"].stagger(0.5, p["gen"].repeat({"f": "r"}))),
        lambda p: p["gt"].perfect),
    "time_limit": ({"concurrency": 2}, lambda p: p["gen"].time_limit(
        3, p["gen"].delay(0.25, p["gen"].repeat({"f": "r"}))),
        lambda p: p["gt"].perfect),
    "cycle": ({"concurrency": 1}, lambda p: p["gen"].limit(
        7, p["gen"].cycle({"f": "a"}, {"f": "b"}, {"f": "c"})),
        lambda p: p["gt"].perfect),
    "until_ok": ({"concurrency": 1}, lambda p: p["gen"].clients(
        p["gen"].until_ok(p["gen"].repeat({"f": "w"}))),
        _until_ok_completion),
    "flip_flop": ({"concurrency": 2}, lambda p: p["gen"].limit(
        6, p["gen"].flip_flop(p["gen"].repeat({"f": "a"}),
                              p["gen"].repeat({"f": "b"}))),
        lambda p: p["gt"].perfect),
    "process_limit": ({"concurrency": 2}, lambda p: p["gen"].clients(
        p["gen"].process_limit(5, p["gen"].repeat({"f": "w"}))),
        lambda p: p["gt"].perfect_info),
    "clients_nemesis": ({"concurrency": 3}, lambda p: p["gen"].nemesis(
        p["gen"].limit(3, p["gen"].repeat({"f": "break"})),
        p["gen"].limit(9, p["gen"].repeat({"f": "r"}))),
        lambda p: p["gt"].imperfect()),
    "any": ({"concurrency": 2}, lambda p: p["gen"].any(
        p["gen"].limit(3, p["gen"].repeat({"f": "a"})),
        p["gen"].limit(3, p["gen"].repeat({"f": "b"}))),
        lambda p: p["gt"].perfect),
    "concurrent_generator": ({"concurrency": 4}, lambda p: p["gen"].limit(
        40, p["independent"].concurrent_generator(
            2, range(5), lambda k: p["gen"].limit(6, p["gen"].mix([
                p["gen"].repeat({"f": "read"}), _write])))),
        lambda p: p["gt"].imperfect()),
    "linearizable_register": ({"concurrency": 4}, lambda p: p["gen"].limit(
        120, p["lr"].test({"nodes": ["n1", "n2"],
                           "per-key-limit": 12})["generator"]),
        lambda p: p["gt"].imperfect()),
}


def _simulate(p, name):
    test, build, completion = CASES[name]
    random.seed(7)
    with p["gen"].fixed_rand(45100):
        return p["gt"].simulate(dict(test), build(p), completion(p))


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulation_equals_jax(name):
    ours = _simulate(PORT, name)
    theirs = _simulate(JAX, name)
    assert ours, name
    assert ours == theirs

