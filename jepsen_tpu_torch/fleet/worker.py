"""The fleet worker: run ONE campaign cell in a standalone process (the
port's copy of ``jepsen_tpu/fleet/worker.py``).

The dispatcher (dispatch.py) execs this module on a worker host over
the control plane::

    python -m jepsen_tpu_torch.fleet.worker  # cell spec JSON on stdin

The *cell spec* is everything a fresh process needs to rebuild and run
the cell -- not the test map itself (clients/checkers/generators don't
serialize), but the recipe: an importable builder plus the options and
per-cell params the coordinator would have fed it locally::

    {"campaign": "c1", "cell": "seed=0,workload=noop",
     "builder": "jepsen_tpu_torch.demo:demo_test",
     "options": {...},            # JSON-able base CLI options
     "params": {"seed": 0, ...},  # this cell's axis values
     "store-dir": "/abs/store",   # the coordinator's store root
     "backend": "cpu",            # fleet.backends tier (optional)
     "seed": 0}                   # RNG seed before build (optional)

The worker prints exactly one result line, prefixed with
``JEPSEN-FLEET-RESULT:``, carrying the same record shape the campaign
scheduler journals (outcome/valid/path/wall_s/error + this run's
compile-cache delta). Everything else (logging) goes to stderr. The
DISPATCHER appends the record to the campaign journal -- the worker
never touches ``cells.jsonl``, so the journal stays single-writer and
a kill -9'd worker simply produces no result line (its lease expires
and the cell is stolen).

The device travels in the options: ``options["device"]`` (the port's
own option, ``demo.py``), overlaid by the backend tier's
(``backends.tier_options``) when the spec names one. A worker told
nothing runs on CUDA, and on a host without a card the build raises,
so the cell records ``"crashed"`` with the error: nothing carries on
on the CPU unasked.

Fault injection for the work-stealing tests rides on the spec:
``"die-once-marker": path`` makes the worker SIGKILL itself before
running the cell, exactly once per marker path -- the second lease of
the same cell finds the marker and runs normally.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback

logger = logging.getLogger(__name__)

__all__ = ["RESULT_MARKER", "resolve_builder", "run_cell_spec", "main",
           "parse_result"]

RESULT_MARKER = "JEPSEN-FLEET-RESULT:"


def resolve_builder(ref):
    """``"pkg.module:function"`` -> the callable. The builder must be
    importable on the worker host; it receives the merged options
    mapping and returns a test map (the same contract as a suite's
    test-fn)."""
    mod, sep, fn = str(ref).partition(":")
    if not sep or not mod or not fn:
        raise ValueError(f"builder {ref!r} should be 'pkg.module:fn'")
    import importlib
    return getattr(importlib.import_module(mod), fn)


def _die_once(marker):
    """SIGKILL this process unless ``marker`` already exists (creating
    it first, so only the FIRST attempt dies): the deterministic
    worker-death injection the work-stealing tests key on."""
    if not marker:
        return
    if os.path.exists(marker):
        return
    with open(marker, "w") as f:
        f.write(str(os.getpid()))
        f.flush()
        os.fsync(f.fileno())
    logger.warning("die-once-marker %s: killing self (SIGKILL)", marker)
    os.kill(os.getpid(), 9)


def run_cell_spec(spec):
    """Build and run one cell from its spec; returns the journal-shaped
    record. Crashes are contained into outcome "crashed" -- the worker
    must always produce a parseable result if it survives at all.

    Telemetry plane: the spec's ``trace`` block (minted by the
    dispatcher) is bound into the run as ``test["obs-context"]``, so
    every span and metric this process emits carries {campaign, cell,
    worker} -- and the worker stamps its OWN wall clock at spec
    receipt and result print (``rec["clock"]``), the two worker-side
    legs of the handshake ``obs.merge`` normalizes clock skew with."""
    from .. import core, store
    from ..campaign import compile_cache

    # chaos clock skew (fleet.chaos "txn-skew"): this worker's wall
    # clock reads skewed by a seeded offset; both handshake stamps
    # shift together, exactly like a host with a wrong clock
    skew_s = float(spec.get("clock-skew-s") or 0.0)
    received_epoch = time.time() + skew_s
    cid = spec.get("cell")
    params = dict(spec.get("params") or {})
    tctx = spec.get("trace") or {}
    rec = {"cell": cid, "group": spec.get("group") or cid,
           "params": params, "worker": spec.get("worker"),
           "pid": os.getpid(),
           # echo the coordinator's fencing token (fleet.ha): the
           # record names the epoch that leased it even when it is
           # relayed through a zombie coordinator's journal append
           **({"coordinator-epoch": spec["coordinator-epoch"]}
              if spec.get("coordinator-epoch") is not None else {}),
           "clock": {"worker-received-epoch": received_epoch,
                     **({"coord-sent-epoch":
                         tctx["coord-sent-epoch"]}
                        if tctx.get("coord-sent-epoch") is not None
                        else {})}}
    t0 = time.monotonic()
    test = None
    try:
        if spec.get("store-dir"):
            store.base_dir = str(spec["store-dir"])
        _die_once(spec.get("die-once-marker")
                  or params.get("die-once-marker"))
        if spec.get("ledger", True):
            from . import ledger as fledger
            fledger.attach()
        cc_before = compile_cache.stats()
        options = dict(spec.get("options") or {})
        options.update(params)
        tier = spec.get("backend")
        if tier:
            # the tier's device, before the build: the build resolves
            # the device and raises where it is missing
            from . import backends as fbackends
            options.update(fbackends.tier_options(tier))
        if isinstance(options.get("concurrency"), str):
            from ..cli import parse_concurrency
            options["concurrency"] = parse_concurrency(
                options["concurrency"], options.get("nodes") or [])
        if params.get("seed") is not None:
            import random
            random.seed(params["seed"])
        build = resolve_builder(spec.get("builder")
                                or "jepsen_tpu_torch.demo:demo_test")
        test = core.prepare_test(build(options))
        test.setdefault("campaign", {}).update(
            {"id": spec.get("campaign"), "cell": cid, "params": params,
             "worker": spec.get("worker")})
        # bind the campaign trace context into obs: the run's tracer
        # anchors trace_meta with it and the registry labels every
        # metric, so the mirrored artifacts merge attributably
        test.setdefault("obs-context", {
            "campaign": spec.get("campaign"), "cell": cid,
            "worker": spec.get("worker")})
        if options.get("telemetry-flush-ms") is not None:
            test.setdefault("telemetry-flush-ms",
                            options["telemetry-flush-ms"])
        if tier:
            fbackends.apply(test, tier)
            rec["backend"] = tier
        finished = core.run(test)
        valid = (finished.get("results") or {}).get("valid")
        rec["valid"] = valid
        rec["outcome"] = valid if valid in (True, False) else "unknown"
        if finished.get("aborted"):
            rec["abort-reason"] = str(finished["aborted"])
        err = (finished.get("results") or {}).get("error")
        if err:
            rec["error"] = str(err)
        rec["compile-cache"] = compile_cache.delta(cc_before)
    except Exception:  # noqa: BLE001 - contained per cell
        logger.warning("fleet worker cell %s crashed\n%s", cid,
                       traceback.format_exc())
        rec["outcome"] = "crashed"
        rec["error"] = traceback.format_exc(limit=8)
    try:
        from .. import store as _store
        rec["path"] = _store.path(test) if test else None
    except (AssertionError, AttributeError, KeyError, TypeError):
        rec["path"] = None
    rec["wall_s"] = round(time.monotonic() - t0, 3)
    rec["clock"]["worker-result-epoch"] = time.time() + skew_s
    return rec


def parse_result(out):
    """Extract the record from a worker's stdout, or None when the
    worker died before printing it (the dispatcher's steal signal).
    The marker line is searched from the END: a chatty test's own
    stdout must not shadow the result."""
    for line in reversed((out or "").splitlines()):
        line = line.strip()
        if line.startswith(RESULT_MARKER):
            try:
                rec = json.loads(line[len(RESULT_MARKER):])
            except ValueError:
                return None
            # a chatty test can emit a marker-shaped line whose JSON
            # isn't a record; only a dict is a result, anything else
            # is the steal signal
            return rec if isinstance(rec, dict) else None
    return None


def main(argv=None):
    """CLI entry: read the cell spec (stdin by default), run it, print
    the result line. Exits 0 whenever a result was produced -- the
    OUTCOME rides in the record; nonzero exits are reserved for
    harness-level failure (unparseable spec), which the dispatcher
    treats as a worker fault."""
    p = argparse.ArgumentParser(prog="jepsen_tpu_torch.fleet.worker")
    p.add_argument("--spec", default="-",
                   help="Cell spec JSON file ('-' = stdin).")
    ns = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s\t%(levelname)s\t%(name)s: %(message)s")
    try:
        if ns.spec == "-":
            spec = json.load(sys.stdin)
        else:
            with open(ns.spec) as f:
                spec = json.load(f)
    except ValueError as e:
        print(f"fleet worker: unparseable cell spec: {e}",
              file=sys.stderr)
        return 3
    rec = run_cell_spec(spec)
    from .. import store
    print(RESULT_MARKER + json.dumps(rec, cls=store._Encoder),
          flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    # hard exit (cli.hard_main rationale): a racer thread still
    # launching on the card can abort the runtime during normal
    # teardown and stomp the exit code the dispatcher keys on; the
    # result line is already out
    sys.stdout.flush()
    sys.stderr.flush()
    logging.shutdown()
    os._exit(code)
