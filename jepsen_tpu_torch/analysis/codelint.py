"""codelint: an AST pass over the framework's own source flagging
unsynchronized mutation of shared state reachable from threaded paths
(the port's copy of ``jepsen_tpu/analysis/codelint.py``; its rules are
the reference's, unchanged).

The framework is aggressively threaded -- interpreter workers, checker
competition racers, control-plane pmaps, obs sinks, the web server, the
service's coalescer --
and its shared state is plain module globals and class attributes. A
mutation of one of those without a lock is exactly the class of bug the
framework exists to find in other systems. This analyzer:

1. collects each module's *shared mutable state*: module-level names
   bound to mutable containers (dict/list/set literals and
   constructors) and names rebound via ``global``;
2. flags mutations of that state (item/attr assignment, mutating method
   calls, ``global`` rebinds, class-attribute writes) that are not
   lexically inside a ``with <...lock...>`` block;
3. ranks severity by *thread reachability*: an import-graph walk from
   the modules that spawn threads (``threading.Thread``, thread pools,
   ``ThreadingHTTPServer``) -- mutations in reachable modules are
   errors, elsewhere warnings.

Suppression: any line (or its enclosing function's ``def`` line)
containing ``codelint: ok`` is skipped -- used for import-time-only
registries where the static pass cannot see the single-threaded
context.

Codes:

  CL001  unsynchronized mutation of a module-level mutable global
  CL002  unsynchronized class-attribute write
  CL003  unsynchronized ``global`` rebind
  CL004  campaign-journal write (``append_cell`` / ``append_event``)
         outside the coordinator role -- the journal's single-writer
         invariant (the fleetlint FL004 oracle) enforced at the
         source level: only the designated coordinator modules
         (``campaign/journal.py`` itself, ``campaign/scheduler.py``,
         ``fleet/dispatch.py``, and ``fleet/ha.py`` -- the
         coordinator-role lease/takeover records) may append. Locks
         don't excuse it (a second
         writer under a lock is still a second writer); escape with
         the standard ``# codelint: ok`` pragma.
"""

from __future__ import annotations

import ast
import os
import re

from .diagnostics import ERROR, WARNING, diag

__all__ = ["lint_source", "lint_paths", "threaded_modules",
           "MUTATOR_METHODS", "JOURNAL_METHODS",
           "JOURNAL_WRITER_FILES"]

#: campaign-journal append methods: CL004 flags calls to these from
#: any framework module outside the coordinator role
JOURNAL_METHODS = frozenset({"append_cell", "append_event"})

#: path suffixes of the port's modules that ARE the coordinator role --
#: the only legal journal-append call sites (journal.py holds the
#: implementation; scheduler.py and dispatch.py are the two
#: coordinators; ha.py appends the coordinator's OWN lease renewals
#: and the takeover records that transfer the role, which are exactly
#: the writes that make the role leasable). The port keeps the
#: reference's layout, so the suffixes are the same four files under
#: ``jepsen_tpu_torch/``.
JOURNAL_WRITER_FILES = (
    os.path.join("campaign", "journal.py"),
    os.path.join("campaign", "scheduler.py"),
    os.path.join("fleet", "dispatch.py"),
    os.path.join("fleet", "ha.py"),
)

#: method names that mutate their receiver in place
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "extend", "insert", "clear",
    "__setitem__", "popleft",
})

#: constructors whose results are mutable shared containers
_MUTABLE_CTORS = frozenset({
    "dict", "list", "set", "defaultdict", "OrderedDict", "deque",
    "Counter", "bytearray",
})

#: constructors whose results are safe to share without a lock
_THREADSAFE_CTORS = re.compile(
    r"(Lock|RLock|Semaphore|BoundedSemaphore|Condition|Event|Barrier"
    r"|Queue|SimpleQueue|LifoQueue|PriorityQueue|ContextVar|local"
    r"|getLogger|Logger)$")

_LOCKISH = re.compile(r"(?i)(lock|sem|mutex)")

_PRAGMA = "codelint: ok"

#: AST names whose presence marks a module as a thread *spawner* (a
#: reachability root)
_THREAD_SPAWNERS = frozenset({
    "Thread", "ThreadPoolExecutor", "ThreadingHTTPServer", "Timer",
    "start_new_thread",
})


def _ctor_name(call):
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_mutable_value(node):
    """Is this module-level value a mutable container worth guarding?"""
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = _ctor_name(node)
        if name is None:
            return False
        if _THREADSAFE_CTORS.search(name):
            return False
        return name in _MUTABLE_CTORS
    return False


class _ModuleState:
    def __init__(self, tree):
        self.mutable_globals = set()
        self.classes = set()
        for node in tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) \
                            and _is_mutable_value(node.value):
                        self.mutable_globals.add(t.id)
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name) \
                        and node.value is not None \
                        and _is_mutable_value(node.value):
                    self.mutable_globals.add(node.target.id)
            elif isinstance(node, ast.ClassDef):
                self.classes.add(node.name)


def _local_names(fn):
    """Names bound locally in a function (args, assignments, loop and
    with targets, comprehension targets) minus ``global`` declarations."""
    globals_ = set()
    locals_ = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        locals_.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            locals_.add(node.name)
            continue
        if isinstance(node, ast.Global):
            globals_.update(node.names)
        elif isinstance(node, ast.Name) \
                and isinstance(node.ctx, ast.Store):
            locals_.add(node.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    locals_.add(t.id)
    return locals_ - globals_, globals_


def _base_name(node):
    """The root Name of an attribute/subscript chain, or None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _with_is_locked(node):
    for item in node.items:
        try:
            src = ast.unparse(item.context_expr)
        except Exception:  # noqa: BLE001 - unparse is best-effort
            src = ""
        if _LOCKISH.search(src):
            return True
    return False


def _line_has_pragma(lines, lineno):
    if 1 <= lineno <= len(lines):
        return _PRAGMA in lines[lineno - 1]
    return False


def _pragma_above(lines, lineno):
    """The pragma on the statement's own line or anywhere in the
    comment block directly above it."""
    if _line_has_pragma(lines, lineno):
        return True
    ln = lineno - 1
    while ln >= 1 and lines[ln - 1].lstrip().startswith("#"):
        if _PRAGMA in lines[ln - 1]:
            return True
        ln -= 1
    return False


def _journal_call_diags(tree, lines, filename):
    """CL004: journal-append calls in a non-coordinator module. Always
    error severity -- this is a protocol violation, not a data race,
    and holding a lock doesn't make a second writer legal."""
    diags = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in JOURNAL_METHODS):
            continue
        if _pragma_above(lines, node.lineno):
            continue
        diags.append(diag(
            "CL004", ERROR,
            f"campaign-journal write '{f.attr}' outside the "
            "coordinator role: cells.jsonl has exactly one writer "
            "(the invariant fleetlint FL004 audits from the journal "
            "itself)",
            f"{filename}:{node.lineno}",
            "route the record through the coordinator "
            "(campaign/scheduler.py or fleet/dispatch.py), or mark "
            "a deliberate exception with '# codelint: ok'"))
    return diags


def lint_source(source, filename="<string>", threaded=True,
                journal_calls=False):
    """Lint one module's source. ``threaded`` selects error (module is
    reachable from a threaded path) vs warning severity;
    ``journal_calls=True`` additionally applies the CL004
    coordinator-role check (lint_paths turns it on for package
    modules outside JOURNAL_WRITER_FILES)."""
    sev = ERROR if threaded else WARNING
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [diag("CL000", ERROR, f"syntax error: {e.msg}",
                     f"{filename}:{e.lineno}")]
    lines = source.splitlines()
    mod = _ModuleState(tree)
    diags = []

    def loc(node):
        return f"{filename}:{node.lineno}"

    def suppressed(node, fn):
        # the pragma may sit on the statement itself, anywhere in the
        # comment block directly above it, or on the function's def line
        if _line_has_pragma(lines, node.lineno) \
                or _line_has_pragma(lines, fn.lineno):
            return True
        ln = node.lineno - 1
        while ln >= 1 and lines[ln - 1].lstrip().startswith("#"):
            if _PRAGMA in lines[ln - 1]:
                return True
            ln -= 1
        return False

    def visit_fn(fn, class_name=None):
        locals_, global_decls = _local_names(fn)

        def scan(body, lock_depth):
            for node in body:
                if isinstance(node, ast.With):
                    depth = lock_depth + (1 if _with_is_locked(node)
                                          else 0)
                    scan(node.body, depth)
                    continue
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    visit_fn(node, class_name)
                    continue
                if isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            visit_fn(sub, node.name)
                    continue
                check_stmt(node, lock_depth)
                for attr in ("body", "orelse", "finalbody"):
                    scan(getattr(node, attr, []) or [], lock_depth)
                for handler in getattr(node, "handlers", []) or []:
                    scan(handler.body, lock_depth)

        def check_stmt(node, lock_depth):
            if lock_depth > 0 or suppressed(node, fn):
                return
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = node.targets
            for t in targets:
                if isinstance(t, ast.Name):
                    if t.id in global_decls:
                        diags.append(diag(
                            "CL003", sev,
                            f"'global {t.id}' rebound without holding "
                            "a lock",
                            loc(node),
                            "guard the rebind with a module lock, or "
                            "mark the single-threaded context with "
                            "'# codelint: ok'"))
                elif isinstance(t, (ast.Subscript, ast.Attribute)):
                    base = _base_name(t)
                    if base is None or base in locals_:
                        continue
                    if base in mod.mutable_globals:
                        diags.append(diag(
                            "CL001", sev,
                            f"unsynchronized write to shared module "
                            f"global '{base}'",
                            loc(node),
                            "wrap the mutation in 'with <lock>:'"))
                    elif isinstance(t, ast.Attribute) and (
                            base in mod.classes
                            or base == "cls"
                            or _is_class_ref(t.value, class_name)):
                        diags.append(diag(
                            "CL002", sev,
                            f"unsynchronized write to class attribute "
                            f"'{ast.unparse(t)}'",
                            loc(node),
                            "class attributes are shared across "
                            "threads; guard with a lock or move to "
                            "instance state"))
            # mutating method calls on shared globals
            for call in _calls_in(node):
                f = call.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in MUTATOR_METHODS:
                    base = _base_name(f.value)
                    if base and base not in locals_ \
                            and base in mod.mutable_globals:
                        diags.append(diag(
                            "CL001", sev,
                            f"unsynchronized '{f.attr}' on shared "
                            f"module global '{base}'",
                            loc(node),
                            "wrap the mutation in 'with <lock>:'"))

        scan(fn.body, 0)

    def _calls_in(stmt):
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                yield sub

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_fn(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    visit_fn(sub, node.name)
    if journal_calls:
        diags += _journal_call_diags(tree, lines, filename)
    return diags


def _is_class_ref(node, class_name):
    """``self.__class__`` / ``type(self)`` receivers."""
    if isinstance(node, ast.Attribute) and node.attr == "__class__":
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "type" and len(node.args) == 1:
        return True
    return False


# ---------------------------------------------------------------------------
# package walking + thread reachability

def _module_name(path, root):
    rel = os.path.relpath(path, os.path.dirname(root))
    parts = rel[:-3].split(os.sep)  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports_of(tree, modname, package, is_pkg=False):
    """Package-internal module names imported by this module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == package:
                    out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = modname.split(".")
                # level 1 = the containing package: the module's own
                # name for an __init__, its parent otherwise
                drop = node.level - (1 if is_pkg else 0)
                base = base[:len(base) - drop] if drop else base
                prefix = ".".join(base)
            elif node.module and node.module.split(".")[0] == package:
                prefix = None
            else:
                continue
            if node.level:
                mod = f"{prefix}.{node.module}" if node.module \
                    else prefix
            else:
                mod = node.module
            out.add(mod)
            for alias in node.names:
                out.add(f"{mod}.{alias.name}")
    return out


def _spawns_threads(tree):
    for node in ast.walk(tree):
        name = None
        if isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Name):
            name = node.id
        if name in _THREAD_SPAWNERS:
            return True
    return False


def threaded_modules(files, root):
    """{module_name: path} of modules reachable (via package-internal
    imports) from any module that spawns threads."""
    package = os.path.basename(root)
    trees, imports, roots = {}, {}, set()
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        name = _module_name(path, root)
        trees[name] = path
        imports[name] = _imports_of(
            tree, name, package,
            is_pkg=os.path.basename(path) == "__init__.py")
        if _spawns_threads(tree):
            roots.add(name)
    # BFS over import edges; an import of a package counts as importing
    # its __init__ (same module name here)
    reachable = set()
    stack = list(roots)
    while stack:
        m = stack.pop()
        if m in reachable:
            continue
        reachable.add(m)
        for dep in imports.get(m, ()):
            # resolve "a.b.c" to the longest known module prefix
            parts = dep.split(".")
            while parts and ".".join(parts) not in trees:
                parts.pop()
            if parts:
                tgt = ".".join(parts)
                if tgt not in reachable:
                    stack.append(tgt)
    return {m: trees[m] for m in reachable}


def lint_paths(paths, package_root=None):
    """Lint .py files (or directory trees). ``package_root`` (a package
    directory, e.g. ``jepsen_tpu_torch/``) enables thread-reachability
    ranking; without it every finding is an error."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
        else:
            files.append(p)
    threaded = None
    if package_root:
        pkg_files = [f for f in files
                     if os.path.abspath(f).startswith(
                         os.path.abspath(package_root))]
        threaded = {os.path.abspath(p) for p in
                    threaded_modules(pkg_files, package_root).values()}
    diags = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError as e:
            diags.append(diag("CL000", ERROR, f"unreadable: {e}", path))
            continue
        is_threaded = threaded is None \
            or os.path.abspath(path) in threaded
        # CL004 applies to FRAMEWORK modules only (tests/tools forge
        # journals legitimately), and not to the coordinator-role
        # files themselves
        ap = os.path.abspath(path)
        in_package = bool(package_root) and ap.startswith(
            os.path.abspath(package_root))
        journal_calls = in_package and not any(
            ap.endswith(os.sep + suffix) or ap.endswith(suffix)
            for suffix in JOURNAL_WRITER_FILES)
        diags.extend(lint_source(src, filename=path,
                                 threaded=is_threaded,
                                 journal_calls=journal_calls))
    return diags
