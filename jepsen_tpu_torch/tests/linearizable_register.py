"""Generators and checkers for linearizability over a set of independent
registers (reference jepsen/src/jepsen/tests/linearizable_register.clj;
the port's copy of ``jepsen_tpu/tests/linearizable_register.py``).

Clients should understand three functions — write, read, and
compare-and-set. Reads receive None and replace it with the value read:

    {"type": "invoke", "f": "write", "value": [k, v]}
    {"type": "invoke", "f": "read",  "value": [k, None]}
    {"type": "invoke", "f": "cas",   "value": [k, [v, v2]]}
"""

from __future__ import annotations

import random

from .. import checker as cc
from .. import generator as gen
from .. import independent
from ..checker import checkers as ck
from ..checker import timeline


def w(test, ctx):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def r(test, ctx):
    return {"type": "invoke", "f": "read"}


def cas(test, ctx):
    return {"type": "invoke", "f": "cas",
            "value": [random.randint(0, 4), random.randint(0, 4)]}


def test(opts):
    """A partial test: generator, model, and checker — you provide the
    client (linearizable_register.clj:22-53). Options:

      nodes          nodes to operate on (only the count matters: 2n
                     workers per key, n of them reserved for reads)
      model          model name/spec for checking (default cas-register)
      algorithm      linearizable algorithm (default competition)
      per-key-limit  max ops per key (default 20, randomized 90-110% so
                     keys drift off Significant Event Boundaries)
      process-limit  max processes per key (default 20)
      engine_opts    passed to the linearizable checker (e.g.
                     ``{"device": "cpu"}``); the JAX package's workload
                     passes only model and algorithm
    """
    n = len(opts.get("nodes") or [])
    model = opts.get("model", "cas-register")
    per_key_limit = opts.get("per-key-limit", 20)
    process_limit = opts.get("process-limit", 20)

    def fgen(k):
        g = gen.reserve(n, r, gen.mix([w, cas, cas]))
        if per_key_limit:
            g = gen.limit(int((0.9 + random.random() * 0.2)
                              * per_key_limit), g)
        return gen.process_limit(process_limit, g)

    return {
        "checker": independent.checker(cc.compose({
            "linearizable": ck.linearizable(
                {"model": model,
                 "algorithm": opts.get("algorithm", "competition"),
                 "engine_opts": opts.get("engine_opts")}),
            "timeline": timeline.html(),
        })),
        "generator": independent.concurrent_generator(
            2 * n if n else 2, _count_from(0), fgen),
    }


def _count_from(start):
    """An endless key sequence ((range) in the reference)."""
    k = start
    while True:
        yield k
        k += 1
