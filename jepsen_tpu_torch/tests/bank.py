"""Bank tests: simulate transfers between accounts and verify that reads
always show the same total balance (reference
jepsen/src/jepsen/tests/bank.clj; the port's copy of
``jepsen_tpu/tests/bank.py``). Host-only.

The test map should carry:

  accounts      collection of account identifiers
  total-amount  total amount allocated
  max-transfer  largest transfer to attempt
"""

from __future__ import annotations

import logging
import random

from .. import checker as cc
from .. import generator as gen
from .. import history as h
from ..checker.core import Checker

logger = logging.getLogger(__name__)


def read(test, ctx):
    """A generator of read operations (bank.clj:20-23)."""
    return {"type": "invoke", "f": "read"}


def transfer(test, ctx):
    """A random transfer between two randomly selected accounts
    (bank.clj:25-33)."""
    accounts = test["accounts"]
    return {"type": "invoke", "f": "transfer",
            "value": {"from": random.choice(accounts),
                      "to": random.choice(accounts),
                      "amount": 1 + random.randint(
                          0, test["max-transfer"] - 1)}}


#: Transfers only between different accounts (bank.clj:35-39).
diff_transfer = gen.filter(
    lambda op: op["value"]["from"] != op["value"]["to"], transfer)


def generator():
    """A mixture of reads and transfers for clients (bank.clj:41-44)."""
    return gen.mix([diff_transfer, read])


def err_badness(test, err):
    """Bigger numbers mean more egregious errors (bank.clj:46-55)."""
    t = err["type"]
    if t == "unexpected-key":
        return len(err["unexpected"])
    if t == "nil-balance":
        return len(err["nils"])
    if t == "wrong-total":
        return abs((err["total"] - test["total-amount"])
                   / test["total-amount"])
    if t == "negative-value":
        return -sum(err["negative"])
    return 0


def check_op(accts, total, negative_balances, op):
    """Errors in a single read's balances, or None (bank.clj:57-81)."""
    value = op.get("value") or {}
    ks = list(value.keys())
    balances = list(value.values())
    if not all(k in accts for k in ks):
        return {"type": "unexpected-key",
                "unexpected": [k for k in ks if k not in accts],
                "op": op}
    if any(b is None for b in balances):
        return {"type": "nil-balance",
                "nils": {k: v for k, v in value.items() if v is None},
                "op": op}
    if sum(balances) != total:
        return {"type": "wrong-total", "total": sum(balances), "op": op}
    if not negative_balances and any(b < 0 for b in balances):
        return {"type": "negative-value",
                "negative": [b for b in balances if b < 0],
                "op": op}
    return None


class _BankChecker(Checker):
    """All reads sum to :total-amount; balances non-negative unless
    :negative-balances? (bank.clj:83-121)."""

    def __init__(self, checker_opts=None):
        self.opts = checker_opts or {}

    def check(self, test, hist, opts=None):
        accts = set(test["accounts"])
        total = test["total-amount"]
        neg_ok = self.opts.get("negative-balances?", False)
        reads = [o for o in hist if h.ok(o) and o.get("f") == "read"]
        errors = {}
        for op in reads:
            err = check_op(accts, total, neg_ok, op)
            if err is not None:
                errors.setdefault(err["type"], []).append(err)
        first_error = None
        firsts = [errs[0] for errs in errors.values()]
        if firsts:
            first_error = min(
                firsts, key=lambda e: e["op"].get("index", 0))
        out_errors = {}
        for etype, errs in errors.items():
            entry = {"count": len(errs),
                     "first": errs[0],
                     "worst": max(errs,
                                  key=lambda e: err_badness(test, e)),
                     "last": errs[-1]}
            if etype == "wrong-total":
                entry["lowest"] = min(errs, key=lambda e: e["total"])
                entry["highest"] = max(errs, key=lambda e: e["total"])
            out_errors[etype] = entry
        return {"valid": not errors,
                "read-count": len(reads),
                "error-count": sum(len(v) for v in errors.values()),
                "first-error": first_error,
                "errors": out_errors}


def checker(checker_opts=None):
    return _BankChecker(checker_opts)


def ok_reads(history):
    """Just OK reads; None if there are none (bank.clj:123-130)."""
    out = [o for o in history if h.ok(o) and o.get("f") == "read"]
    return out or None


def by_node(test, history):
    """Groups operations by the node their process talked to
    (bank.clj:132-141)."""
    nodes = test["nodes"]
    n = len(nodes)
    out = {}
    for op in history:
        p = op.get("process")
        if isinstance(p, int):
            out.setdefault(nodes[p % n], []).append(op)
    return out


def points(history):
    """[time-seconds, total-of-accounts] points (bank.clj:143-150)."""
    return [[op.get("time", 0) / 1e9,
             sum(v for v in (op.get("value") or {}).values()
                 if v is not None)]
            for op in history]


class _BankPlotter(Checker):
    """Renders a graph of balances over time (bank.clj:152-183)."""

    def check(self, test, hist, opts=None):
        opts = opts or {}
        reads = ok_reads(hist)
        if not reads:
            return {"valid": True}
        try:
            from .. import store
            path = store.make_path(test, opts.get("subdirectory"),
                                   "bank.png")
        except (AssertionError, OSError):
            return {"valid": True}
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(10, 6))
            for node, data in sorted(by_node(test, reads).items()):
                pts = points(data)
                ax.scatter([p[0] for p in pts], [p[1] for p in pts],
                           marker="x", s=14, label=str(node))
            ax.set_title(f"{test.get('name')} bank")
            ax.set_xlabel("Time (s)")
            ax.set_ylabel("Total of all accounts")
            ax.legend()
            from ..checker import perf
            perf.shade_nemeses(ax, hist,
                               (test.get("plot") or {}).get("nemeses"))
            fig.savefig(path, dpi=100)
            plt.close(fig)
        except Exception:  # noqa: BLE001 - plotting is best-effort
            logger.warning("bank plot failed", exc_info=True)
        return {"valid": True}


def plotter():
    return _BankPlotter()


def test(opts=None):
    """A partial test: default accounts/amounts + generator and checker
    (bank.clj:185-203). Options: negative-balances? — if true, doesn't
    verify balances remain positive."""
    opts = opts or {"negative-balances?": False}
    return {
        "max-transfer": 5,
        "total-amount": 100,
        "accounts": list(range(8)),
        "checker": cc.compose({"SI": checker(opts), "plot": plotter()}),
        "generator": generator(),
    }
