"""The port's codelint (``jepsen_tpu_torch.analysis.codelint``) and its
runner (``python -m jepsen_tpu_torch.lint``) held against the JAX
package's codelint and ``tools/lint.py``: the same findings on the same
seeded defects, the port's own tree clean, and the same exit codes."""

import glob
import json
import os
import subprocess
import sys

import pytest

from jepsen_tpu.analysis import codelint as jcodelint
from jepsen_tpu_torch import analysis
from jepsen_tpu_torch.analysis import codelint as tcodelint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "jepsen_tpu_torch")

SEEDED_DEFECT = '''
import threading

_cache = {}
_lock = threading.Lock()


def worker(key, value):
    _cache[key] = value          # unsynchronized!


def safe(key, value):
    with _lock:
        _cache[key] = value


def spawn():
    threading.Thread(target=worker, args=(1, 2)).start()
'''

MORE = '''
_handle = None


class Shared:
    count = 0

    def bump(self):
        Shared.count += 1


def set_handle(x):
    global _handle
    _handle = x
'''

SHADOW = '''
_cache = {}


def fine():
    _cache = {}          # a fresh local, not the module global
    _cache["x"] = 1
    return _cache
'''

#: a journal append outside the coordinator role (CL004)
JOURNAL = '''
def sneak(jr):
    jr.append_event({"event": "x"})
'''

#: the same write escaped with the pragma in the comment block above
JOURNAL_OK = '''
def sneak(jr):
    # codelint: ok -- a deliberate second writer in a test
    jr.append_event({"event": "x"})
'''

#: the try/finally shape ``checkers.short_switch`` had: the mutation
#: is under its lock, but the reference's pass reads the whole compound
#: statement, so the lock must sit in a function of its own
TRY_FINALLY = '''
import threading

_open = []
_lock = threading.Lock()


def scope(x):
    try:
        yield
    finally:
        with _lock:
            _open.remove(x)


def spawn():
    threading.Thread(target=scope).start()
'''


def _findings(diags):
    """Findings without their file's directory."""
    return [(d.code, d.severity, d.message, os.path.basename(
        d.location.rsplit(":", 1)[0]) + ":" + d.location.rsplit(":", 1)[1],
        d.fix_hint) for d in diags]


@pytest.mark.parametrize("name,src", [
    ("defect.py", SEEDED_DEFECT), ("more.py", MORE),
    ("shadow.py", SHADOW), ("try_finally.py", TRY_FINALLY),
    ("suppressed.py", SEEDED_DEFECT.replace(
        "_cache[key] = value          # unsynchronized!",
        "_cache[key] = value          # codelint: ok -- test only")),
    ("broken.py", "def f(:\n    pass\n"),
])
def test_seeded_sources_lint_as_the_reference(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(src)
    got = tcodelint.lint_paths([str(p)])
    assert _findings(got) == _findings(jcodelint.lint_paths([str(p)]))


def test_codelint_catches_seeded_defect(tmp_path):
    p = tmp_path / "defect.py"
    p.write_text(SEEDED_DEFECT)
    diags = tcodelint.lint_paths([str(p)])
    assert [d.code for d in analysis.errors(diags)] == ["CL001"]
    assert "defect.py:9" in diags[0].location


def test_codelint_lock_and_pragma_suppression(tmp_path):
    src = SEEDED_DEFECT.replace(
        "_cache[key] = value          # unsynchronized!",
        "_cache[key] = value          # codelint: ok -- test only")
    p = tmp_path / "suppressed.py"
    p.write_text(src)
    assert tcodelint.lint_paths([str(p)]) == []


def test_codelint_global_rebind_and_class_attr(tmp_path):
    p = tmp_path / "more.py"
    p.write_text(MORE)
    got = {d.code for d in analysis.errors(tcodelint.lint_paths([str(p)]))}
    assert got == {"CL002", "CL003"}


def test_codelint_local_shadowing_not_flagged(tmp_path):
    p = tmp_path / "shadow.py"
    p.write_text(SHADOW)
    assert tcodelint.lint_paths([str(p)]) == []


def test_codelint_journal_writes_outside_the_coordinator(tmp_path):
    """CL004 names the port's coordinator modules: a journal append in
    any other module of the package is an error, the coordinator files
    and the pragma are not."""
    pkg = tmp_path / "jepsen_tpu_torch"
    (pkg / "campaign").mkdir(parents=True)
    (pkg / "fleet").mkdir()
    for f in ("__init__.py", "campaign/__init__.py", "fleet/__init__.py"):
        (pkg / f).write_text("")
    (pkg / "fleet" / "worker.py").write_text(JOURNAL)
    (pkg / "fleet" / "ok.py").write_text(JOURNAL_OK)
    for f in ("campaign/journal.py", "campaign/scheduler.py",
              "fleet/dispatch.py", "fleet/ha.py"):
        (pkg / f).write_text(JOURNAL)
    diags = tcodelint.lint_paths([str(pkg)], package_root=str(pkg))
    assert [(d.code, os.path.basename(d.location.split(":")[0]))
            for d in diags] == [("CL004", "worker.py")]
    assert tuple(tcodelint.JOURNAL_WRITER_FILES) \
        == tuple(jcodelint.JOURNAL_WRITER_FILES)
    for suffix in tcodelint.JOURNAL_WRITER_FILES:
        assert os.path.isfile(os.path.join(PORT, suffix)), suffix


def test_codelint_shipped_tree_is_clean():
    """The port's own tree has no error-severity finding."""
    diags = tcodelint.lint_paths([PORT], package_root=PORT)
    assert analysis.errors(diags) == [], analysis.render_text(diags)


def test_port_pragmas_mark_only_import_time_registries():
    """The pragma escapes only what the reference escapes: import-time
    registries (``models.register_model``, ``capplan.register_shapes``),
    each on the registry's one write."""
    hits = []
    for path in sorted(glob.glob(os.path.join(PORT, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, PORT)
        if rel in (os.path.join("analysis", "codelint.py"), "lint.py"):
            continue                 # the pass itself names its pragma
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.lstrip().startswith("# codelint: ok"):
                    hits.append(rel)
    assert hits == [os.path.join("analysis", "capplan.py"),
                    os.path.join("models", "base.py")]


def test_threaded_reachability_ranks_modules():
    files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    reach = tcodelint.threaded_modules(files, PORT)
    assert "jepsen_tpu_torch.interpreter" in reach
    assert "jepsen_tpu_torch.history" in reach
    assert "jepsen_tpu_torch.checker.rollout" in reach
    assert "jepsen_tpu_torch.os.centos" not in reach


# ---------------------------------------------------------------------------
# python -m jepsen_tpu_torch.lint


def _run_lint(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.lint", "--no-ruff"]
        + args, capture_output=True, text=True, timeout=120, cwd=REPO,
        env=env)


def test_lint_tool_zero_on_shipped_tree():
    r = _run_lint([])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 error(s)" in r.stdout


def test_lint_tool_nonzero_on_seeded_defect(tmp_path):
    p = tmp_path / "defect.py"
    p.write_text(SEEDED_DEFECT)
    r = _run_lint([str(p)])
    assert r.returncode == 1
    assert "CL001" in r.stdout


def test_lint_tool_json_output(tmp_path):
    p = tmp_path / "defect.py"
    p.write_text(SEEDED_DEFECT)
    r = _run_lint(["--json", str(p)])
    report = json.loads(r.stdout)
    assert report["failed"] is True
    assert report["counts"]["error"] == 1
    assert report["ruff"]["output"] == "skipped (--no-ruff)"


def test_lint_tool_audits_and_certifies_as_the_reference(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``--campaign`` and ``--certify`` give the reference's exit code
    where there is nothing to audit (2)."""
    from jepsen_tpu_torch import lint, store
    monkeypatch.setattr(store, "base_dir", str(tmp_path / "store"))
    assert lint.main(["--campaign"]) == 2
    assert lint.main(["--campaign", "nope"]) == 2
    assert lint.main(["--certify"]) == 2
    assert lint.main(["--certify", str(tmp_path / "none")]) == 2
    capsys.readouterr()


def test_cli_lint_dry_run(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "test", "--workload",
         "noop", "--no-ssh", "--lint", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "plan lint" in r.stdout
    assert not (tmp_path / "store").exists()
