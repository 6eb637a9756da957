"""The port's public surface against the JAX package's.

* The names the port added last: ``checker.core.concurrency_limit``
  (the reference's six-thread case of ``tests/test_checkers.py``, with a
  shared key), ``analysis.warnings`` and ``analysis.max_severity`` (the
  cases of ``tests/test_analysis.py``), ``StreamCheck.skipped`` (against
  the JAX ``StreamCheck`` on one seeded stream with skipped ops) and
  ``__version__``.
* The surface guard: every name in every JAX module's ``__all__``
  (parsed with ``ast``, so no JAX module is imported for it) has a
  counterpart in the port's module of the same path, except the
  deliberate divergences listed in ``DIVERGENCES``, each of which names
  the words of its ROADMAP.md C item."""

import ast
import importlib
import os
import random
import threading
import time

import pytest

from jepsen_tpu.models import base as jbase
from jepsen_tpu.monitor.wgl_stream import StreamCheck as JStreamCheck
from jepsen_tpu_torch import analysis as tanalysis
from jepsen_tpu_torch import simulate
from jepsen_tpu_torch.checker import core as tcore
from jepsen_tpu_torch.models import base as tbase
from jepsen_tpu_torch.monitor.wgl_stream import StreamCheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "jepsen_tpu")

#: (module path under the package, name) -> words of its ROADMAP.md C
#: item; a name "*" stands for the whole module
DIVERGENCES = {
    ("analysis", "jaxlint"): "jaxlint's tracing checks",
    ("analysis.jaxlint", "*"): "jaxlint's tracing checks",
    ("campaign.compile_cache", "n_floor"): "**The floor is a constant.**",
    ("campaign.compile_cache", "set_n_floor"):
        "**The floor is a constant.**",
    ("campaign.compile_cache", "bucket_floor"):
        "**The floor is a constant.**",
    ("campaign.compile_cache", "DEFAULT_N_FLOOR"):
        "**The floor is a constant.**",
    ("fleet.ledger", "enable_jax_cache"):
        "**`enable_jax_cache` has no counterpart**",
    ("fleet.ledger", "JAX_CACHE_DIR"):
        "**`enable_jax_cache` has no counterpart**",
    ("fleet.backends", "tier_env"): "**The device travels as an option.**",
}


# ---------------------------------------------------------------------------
# the names


def test_concurrency_limit():
    """The reference's case: six threads through a limit of 2."""
    active = []
    peak = []
    lock = threading.Lock()

    class Slow(tcore.Checker):
        def check(self, test, hist, opts=None):
            with lock:
                active.append(1)
                peak.append(len(active))
            time.sleep(0.02)
            with lock:
                active.pop()
            return {"valid": True}

    limited = tcore.concurrency_limit(2, Slow(), key="surface-limit")
    threads = [threading.Thread(target=limited.check, args=({}, []))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(peak) == 6 and max(peak) <= 2


def test_concurrency_limit_shares_the_first_semaphore_of_a_key():
    """A second limit under an existing key shares the first one's
    semaphore, whatever its own limit; without a key each limit has its
    own."""
    import jepsen_tpu.checker.core as jcore
    for core in (tcore, jcore):
        a = core.concurrency_limit(1, core.noop(), key="surface-shared")
        b = core.concurrency_limit(5, core.noop(), key="surface-shared")
        assert b.sem is a.sem and b.key == "surface-shared"
        c = core.concurrency_limit(1, core.noop())
        assert c.sem is not a.sem and c.key == id(c)
        assert b.check({}, [], None) == {"valid": True}
    assert "concurrency_limit" in tcore.__all__
    assert isinstance(tcore.concurrency_limit(1, tcore.noop()),
                      tcore.ConcurrencyLimit)


def test_concurrency_limit_serializes_across_limits_of_one_key():
    """Two limits built under one key with limit 1 never overlap."""
    spans = []
    lock = threading.Lock()

    class Timed(tcore.Checker):
        def check(self, test, hist, opts=None):
            t0 = time.monotonic()
            time.sleep(0.01)
            with lock:
                spans.append((t0, time.monotonic()))
            return {"valid": True}

    limits = [tcore.concurrency_limit(1, Timed(), key="surface-serial")
              for _ in range(4)]
    threads = [threading.Thread(target=lim.check, args=({}, []))
               for lim in limits for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans.sort()
    assert len(spans) == 8
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_warnings_and_max_severity():
    """The cases of the reference's ``test_diagnostic_model_and_renderers``."""
    d1 = tanalysis.diag("HL002", tanalysis.ERROR, "boom", "history[3]",
                        "fix it")
    d2 = tanalysis.diag("HL001", tanalysis.WARNING, "meh")
    d3 = tanalysis.diag("HL003", tanalysis.INFO, "fyi")
    assert tanalysis.max_severity([d1, d2]) == "error"
    assert tanalysis.max_severity([d2]) == "warning"
    assert tanalysis.max_severity([d3]) == "info"
    assert tanalysis.max_severity([]) is None
    assert tanalysis.warnings([d1, d2, d3]) == [d2]
    assert tanalysis.warnings([d1]) == []
    assert tanalysis.errors([d1, d2]) == [d1]
    assert {"warnings", "max_severity"} <= set(tanalysis.__all__)


def _stream_with_skips(seed=15000):
    """A seeded cas-register history with skipped events mixed in: bare
    completions (nemesis style), invokes of an unknown function, and a
    second invoke on a process with an op still open."""
    rng = random.Random(seed)
    hist = simulate.random_history(rng, "cas-register", 3, 60, 0.05)
    out = []
    for op in hist:
        out.append(op)
        roll = rng.random()
        if roll < 0.08:
            out.append({"type": "info", "process": "nemesis",
                        "f": "start", "value": None})
        elif roll < 0.12:
            out.append({"type": "invoke", "process": 90 + len(out),
                        "f": "frobnicate", "value": 1})
        elif roll < 0.16 and op["type"] == "invoke":
            out.append(dict(op))
    return out


def test_streamcheck_skipped_equals_the_jax_streamcheck():
    spec = tbase.model_spec("cas-register")
    jspec = jbase.model_spec("cas-register")
    sc = StreamCheck(spec, device="cpu")
    jsc = JStreamCheck(jspec, opts={"coalesce?": False})
    for i, op in enumerate(_stream_with_skips()):
        assert sc.offer(op, i) == jsc.offer(op, i)
        assert sc.skipped == jsc.skipped, i
    assert sc.skipped > 3
    assert sc.skipped == sc.enc.skipped


def test_version():
    import jepsen_tpu
    import jepsen_tpu_torch
    assert jepsen_tpu_torch.__version__ == jepsen_tpu.__version__ == "0.1.0"


# ---------------------------------------------------------------------------
# the surface guard


def _literal_all(path):
    """The module's ``__all__`` from its source: a literal list, or one
    re-exported from a sibling (``from .core import __all__``)."""
    tree = ast.parse(open(path).read())
    imported = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                if a.name == "__all__":
                    imported[a.asname or a.name] = node.module
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            try:
                return list(ast.literal_eval(node.value))
            except ValueError:
                src = [n.id for n in ast.walk(node.value)
                       if isinstance(n, ast.Name) and n.id in imported]
                assert len(src) == 1, path
                return _literal_all(os.path.join(os.path.dirname(path),
                                                 imported[src[0]] + ".py"))
    return None


def _jax_modules():
    for dirpath, _dirs, files in sorted(os.walk(JAX_ROOT)):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), JAX_ROOT)
            mod = rel[:-3].replace(os.sep, ".")
            if mod == "__init__":
                mod = ""
            elif mod.endswith(".__init__"):
                mod = mod[:-len(".__init__")]
            yield mod, os.path.join(dirpath, f)


def _roadmap_c():
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    return text[text.index("### C. Faults found in the port"):
                text.index("## Recent")]


def test_every_jax_name_has_a_port_counterpart():
    missing = []
    checked = 0
    for mod, path in _jax_modules():
        names = _literal_all(path)
        if names is None:
            continue
        if (mod, "*") in DIVERGENCES:
            continue
        port = importlib.import_module(
            "jepsen_tpu_torch" + (f".{mod}" if mod else ""))
        for name in names:
            checked += 1
            if not hasattr(port, name) and (mod, name) not in DIVERGENCES:
                missing.append(f"{mod}.{name}")
    assert checked > 400
    assert missing == []


def test_every_divergence_is_real_and_named_in_roadmap_c():
    c = _roadmap_c()
    for (mod, name), words in DIVERGENCES.items():
        assert words in c, (mod, name)
        if name == "*":
            with pytest.raises(ImportError):
                importlib.import_module(f"jepsen_tpu_torch.{mod}")
            continue
        base = os.path.join(JAX_ROOT, *mod.split("."))
        path = base + ".py" if os.path.exists(base + ".py") \
            else os.path.join(base, "__init__.py")
        assert name in _literal_all(path), (mod, name)
        port = importlib.import_module(f"jepsen_tpu_torch.{mod}")
        assert not hasattr(port, name), (mod, name)
        assert f"`{name}`" in c, (mod, name)
