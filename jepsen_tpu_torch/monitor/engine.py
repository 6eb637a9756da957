"""Prefix-check dispatch for the streaming checks (the PyTorch port of
``jepsen_tpu.monitor.engine``).

One function, four engines:

* ``jax-wgl`` -- the batched device search (``checker/torch_wgl.py``;
  the name is the JAX package's, so monitor options carry over);
* ``linear`` -- just-in-time linearization on the CPU
  (``checker/linear.py``);
* ``wgl`` -- the sequential oracle, for tests and tiny histories;
* ``streamlin`` -- the device-resident frontier
  (``checker/streamlin.py``) as a one-shot fold over the whole prefix;
  the O(window) streaming check is ``monitor/wgl_stream.StreamCheck``,
  which reaches this function only for its flat fall-backs and its
  violation confirms.

``engine_opts["device"]`` (None: CUDA) is where the device engines run.
Budgets are deliberately modest: a monitor check that can't decide
quickly returns "unknown". Unlike the JAX package, an exception raises:
a device or build failure is never turned into an "unknown" verdict.
"""

from __future__ import annotations

__all__ = ["ENGINES", "TXN_WORKLOADS", "check_prefix",
           "check_txn_prefix"]

#: engines the monitor can drive
ENGINES = ("jax-wgl", "linear", "wgl", "streamlin")

#: txn-family workloads the monitor can stream (monitor/txn.py)
TXN_WORKLOADS = ("append", "wr")

#: CPU-engine budgets: chunk checks repeat, so each one must stay small
LINEAR_MAX_CONFIGS = 200_000
WGL_MAX_CONFIGS = 2_000_000


def check_prefix(spec, e, init_state, engine="jax-wgl",
                 engine_opts=None, cancel=None):
    """Check one encoded prefix; returns the engine's result dict
    ({"valid": True|False|"unknown", ...})."""
    if len(e) == 0 or e.n_ok == 0:
        return {"valid": True, "configs_explored": 0, "engine": engine}
    opts = dict(engine_opts or {})
    if engine == "linear":
        from ..checker import linear
        return linear.check_encoded(
            spec, e, init_state, max_configs=LINEAR_MAX_CONFIGS,
            cancel=cancel)
    if engine == "wgl":
        from ..checker import wgl
        return wgl.check_encoded(
            spec, e, init_state, max_configs=WGL_MAX_CONFIGS,
            cancel=cancel)
    if engine == "streamlin":
        from ..checker import streamlin
        return streamlin.check_encoded(
            spec, e, init_state,
            max_configs=int(opts.get("frontier-cap")
                            or streamlin.DEFAULT_FRONTIER_CAP),
            cancel=cancel, device=opts.get("device"))
    if engine != "jax-wgl":
        raise ValueError(f"unknown monitor engine {engine!r}; expected "
                         f"one of {ENGINES}")
    from ..checker import torch_wgl
    # the mesh/checkpoint machinery is offline-only; a monitor check is
    # short-lived and re-runs every chunk
    for k in ("mesh", "checkpoint", "checkpoint_every_s", "confirm"):
        opts.pop(k, None)
    return torch_wgl.check_encoded(spec, e, init_state, cancel=cancel,
                                   **opts)


def check_txn_prefix(history, workload="append", opts=None, cancel=None):
    """family="txn" dispatch: run the full offline ``cycle/`` analysis
    over a consumed txn prefix -- the verdict of record the streaming
    closure's suspicion defers to. ``opts["device"]`` (None: CUDA) is
    where the closures run. ``cancel`` is accepted for the JAX
    package's signature; the analysis is not interruptible."""
    opts = dict(opts or {})
    device = opts.get("device")
    if workload == "wr":
        from ..cycle import wr
        return wr.analyze(list(history), opts, device)
    from ..cycle import DEFAULT_ANOMALIES
    from ..cycle import append as app
    return app.analyze(
        list(history),
        tuple(opts.get("anomalies", DEFAULT_ANOMALIES)),
        realtime=opts.get("realtime", True),
        process=opts.get("process", False),
        skew_bound=opts.get("skew-bound", opts.get("skew_bound", 0)),
        device=device)
