"""The linearizability checker: histories in, verdict maps out (reference
jepsen/src/jepsen/checker.clj:185-216, mirroring
``jepsen_tpu.checker.checkers.Linearizable``).

``linearizable`` dispatches on "algorithm" as the reference dispatches to
knossos (checker.clj:199-202): "wgl" runs the sequential CPU oracle,
"linear" just-in-time linearization on the CPU (``linear``), and
"jax-wgl" the batched device search (``torch_wgl``; the name is the JAX
package's, so test maps carry over). "competition" comes with a later
slice of the port (ROADMAP.md queue A.8) and raises
NotImplementedError. There is no search-plan path yet: a check here is
what the JAX package does with ``test["searchplan?"] = False``.
"""

from __future__ import annotations

from .. import history as h
from ..models import base as mbase
from .core import Checker

__all__ = ["Linearizable", "linearizable"]

#: algorithms of the JAX package that a later slice brings
_LATER = {"competition": "A.8, competition"}


class Linearizable(Checker):
    """THE gate to the linearizability engines (checker.clj:185-216).
    algorithm: "wgl" (sequential CPU oracle), "linear" (JIT
    linearization on the CPU) or "jax-wgl" (the default here: the
    batched device search). ``engine_opts`` go to
    ``torch_wgl.check_encoded`` (``device``, ``rollout_kernel``,
    budgets); ``init_ops`` establish the initial state as in the JAX
    package."""

    def __init__(self, model, algorithm="jax-wgl", engine_opts=None,
                 init_ops=None):
        assert model is not None, \
            "the linearizable checker requires a model"
        self.spec = mbase.model_spec(model)
        if algorithm in _LATER:
            raise NotImplementedError(
                f"algorithm {algorithm!r} is not ported to "
                f"jepsen_tpu_torch yet: ROADMAP.md queue A, "
                f"{_LATER[algorithm]}")
        if algorithm not in ("wgl", "linear", "jax-wgl"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.algorithm = algorithm
        self.engine_opts = engine_opts or {}
        self.init_ops = list(init_ops or [])

    def prepare_history(self, client_hist):
        """Prepend the init ops as already-completed pairs ordered before
        every real op (negative indices), as the JAX package does."""
        if not self.init_ops:
            return client_hist
        lo = min((o.get("index", 0) for o in client_hist), default=0)
        synth = []
        for j, op in enumerate(self.init_ops):
            base = lo - 2 * (len(self.init_ops) - j)
            synth.append({"type": "invoke", "process": -1,
                          "f": op["f"], "value": op.get("value"),
                          "index": base, "time": base})
            synth.append({"type": "ok", "process": -1,
                          "f": op["f"], "value": op.get("value"),
                          "index": base + 1, "time": base + 1})
        return synth + client_hist

    def check(self, test, hist, opts=None):
        from . import linear, torch_wgl, wgl
        client_hist = self.prepare_history(h.client_ops(hist))
        e, init_state = self.spec.encode(client_hist)
        if self.algorithm == "wgl":
            a = wgl.check_encoded(self.spec, e, init_state)
        elif self.algorithm == "linear":
            a = linear.check_encoded(self.spec, e, init_state)
        else:
            a = torch_wgl.check_encoded(self.spec, e, init_state,
                                        **self.engine_opts)
        # truncate heavyweight fields (checker.clj:213-216: "writing
        # these can take *hours*"): at most 10 paths / 10 configs
        if "final_paths" in a:
            a["final_paths"] = a["final_paths"][:10]
        if "configs" in a:
            a["configs"] = a["configs"][:10]
        a["valid?"] = a["valid"]
        return a


def linearizable(opts):
    """linearizable({"model": ..., "algorithm": ...})
    (checker.clj:185-216)."""
    if isinstance(opts, dict):
        return Linearizable(opts["model"], opts.get("algorithm",
                                                    "jax-wgl"),
                            opts.get("engine_opts"),
                            opts.get("init-ops"))
    return Linearizable(opts)
