"""Control-node file cache for expensive setup artifacts (reference
jepsen/src/jepsen/fs_cache.clj, 249 LoC).

Cached values are referred to by logical *paths* — sequences of strings,
ints, floats, bools — encoded into filesystem names with a type prefix
(so ``["foo"]`` and ``["foo", "bar"]`` can't collide: directory
components get a ``d`` prefix, the final file component an ``f``).
Writers are atomic (tmp file + rename). A per-path lock keeps concurrent
cache misses from duplicating expensive work. The port's copy of
``jepsen_tpu/fs_cache.py``, with the same name encoding and, where
``TMPDIR`` is unset, the same directory: an artifact either package
cached is a hit for the other."""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import tempfile
import threading

from . import control as c

#: top-level cache directory (fs_cache.clj:57-59): the JAX package's
#: /tmp/jepsen/cache, under the temporary directory the process was given
dir = os.path.join(tempfile.gettempdir(), "jepsen",  # noqa: A001
                   "cache")

DIR_PREFIX = "d"
FILE_PREFIX = "f"


def escape(s: str) -> str:
    """Escape slashes in filename components (fs_cache.clj:71-74)."""
    return re.sub(r"([\\/])", r"\\\1", s)


def encode_path_component(x) -> str:
    """Type-tagged filename encoding (fs_cache.clj:76-99)."""
    if isinstance(x, bool):
        return f"b_{str(x).lower()}"
    if isinstance(x, str):
        return f"s_{escape(x)}"
    if isinstance(x, int):
        return f"l_{x}"
    if isinstance(x, float):
        return f"m_{x}"
    raise TypeError(f"can't encode cache path component {x!r}")


def fs_path(path) -> list:
    """Cache path -> list of filesystem names (fs_cache.clj:101-120)."""
    if isinstance(path, (str, bytes)) or not hasattr(path, "__len__"):
        raise TypeError("cache path must be a sequence")
    if not len(path):
        raise ValueError("cache path must not be empty")
    out = []
    for i, x in enumerate(path):
        prefix = FILE_PREFIX if i == len(path) - 1 else DIR_PREFIX
        out.append(prefix + encode_path_component(x))
    return out


def file(path) -> str:
    """The local file backing a path, whether or not it exists
    (fs_cache.clj:124-127)."""
    return os.path.join(dir, *fs_path(path))


def file_(path) -> str:
    """Like file, but ensures parents exist (fs_cache.clj:129-134)."""
    f = file(path)
    os.makedirs(os.path.dirname(f), exist_ok=True)
    return f


@contextlib.contextmanager
def write_atomic(final: str):
    """Yields a tmp path; on success renames it onto final
    (fs_cache.clj:136-151)."""
    fd, tmp = tempfile.mkstemp(suffix=".tmp",
                               dir=os.path.dirname(final) or ".")
    os.close(fd)
    try:
        yield tmp
        os.replace(tmp, final)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)


def cached(path) -> bool:
    """Is this path cached? (fs_cache.clj:155-158)"""
    return os.path.isfile(file(path))


def clear(path=None):
    """Clear the whole cache, or one path (fs_cache.clj:160-168)."""
    if path is None:
        shutil.rmtree(dir, ignore_errors=True)
    else:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(file(path))


def save_file(src: str, path) -> str:
    """Cache a local file; returns src (fs_cache.clj:172-177)."""
    with write_atomic(file_(path)) as tmp:
        shutil.copyfile(src, tmp)
    return src


def load_file(path) -> str | None:
    """The file backing a path, or None if uncached
    (fs_cache.clj:179-184)."""
    f = file(path)
    return f if os.path.isfile(f) else None


def save_string(s: str, path) -> str:
    with write_atomic(file_(path)) as tmp:
        with open(tmp, "w") as fh:
            fh.write(s)
    return s


def load_string(path) -> str | None:
    f = load_file(path)
    if f is None:
        return None
    with open(f) as fh:
        return fh.read()


def save_data(data, path):
    """JSON-serialized structured data (the reference's save-edn!,
    fs_cache.clj:199-206)."""
    with write_atomic(file_(path)) as tmp:
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=1)
    return data


def load_data(path):
    f = load_file(path)
    if f is None:
        return None
    with open(f) as fh:
        return json.load(fh)


def save_remote(remote_path: str, cache_path) -> str:
    """Cache a remote file by downloading it (fs_cache.clj:215-221).
    Runs inside a control scope (c.on(node))."""
    with write_atomic(file_(cache_path)) as tmp:
        c.download([remote_path], tmp)
    return remote_path


def deploy_remote(cache_path, remote_path: str):
    """Deploy a cached file to a node, replacing what's there
    (fs_cache.clj:223-237)."""
    if not cached(cache_path):
        raise RuntimeError(
            f"path {cache_path!r} is not cached and cannot be deployed")
    if not re.fullmatch(r"/\w+/.+", remote_path):
        raise ValueError(
            f"remote path {remote_path!r} looks relative or suspiciously "
            "short -- this might be dangerous!")
    c.exec_("rm", "-rf", remote_path)
    parent = os.path.dirname(remote_path)
    c.exec_("mkdir", "-p", parent)
    c.upload([file(cache_path)], remote_path)


# -- locks (fs_cache.clj:241-249) -------------------------------------------

_locks: dict = {}
_locks_guard = threading.Lock()


@contextlib.contextmanager
def locking(path):
    """Serialize expensive cache misses per logical path."""
    key = tuple(fs_path(path))
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        yield
