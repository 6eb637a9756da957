"""Artifact sync: mirror a remote worker's run directory into the
coordinator's store over the existing control/remotes scp plane (the
port's copy of ``jepsen_tpu/fleet/sync.py``; host-only).

A fleet worker writes its run artifacts (history.jsonl, results.json,
trace.jsonl, metrics.json, monitor.json, analysis.json, jepsen.log)
into its OWN store directory; the journal record it returns names a
host-local path the coordinator's web UI can't serve. This module is
the download half the ROADMAP called for, built crash-consistent:

* **Manifest first.** Before any byte moves, the worker is asked for
  a file manifest (``find -type f -printf '%P\\t%s\\n'``): relative
  path + size for every artifact. After the download, every manifest
  entry must exist locally with a matching size -- a torn copy (a
  killed scp, a chaos-injected partial download) is *detected*, not
  trusted, and the attempt retries.
* **Atomic visibility.** Downloads land in ``store/.sync-tmp/`` (a
  reserved directory the store browser skips) and are renamed into
  place only after verification: the coordinator store NEVER shows a
  partial run directory, no matter what kills what mid-transfer.
* **Bounded retries.** One `robust.RetryPolicy` drives the attempts,
  with the whole pull bounded by ``timeout_s`` -- a wedged transport
  costs a sync failure, never a wedged coordinator.
* **Download on demand.** Runs whose sync failed terminally register
  here; `fetch_on_demand` pulls one when a browsed path isn't on local
  disk yet (in the JAX package ``web.py`` calls it; the port's viewer
  is ROADMAP.md A.11(d4)), so a run link resolves the moment the
  worker host is reachable again.

The dispatcher journals every outcome as an ``artifact-sync`` event
record, which is what lets ``--resume`` re-sync a terminal cell's
artifacts without re-running the cell.
"""

from __future__ import annotations

import logging
import os
import shlex
import shutil
import threading
import time

from .. import store
from ..robust import RetryPolicy

logger = logging.getLogger(__name__)

__all__ = ["SyncError", "DEFAULT_SYNC_TIMEOUT_S", "manifest",
           "pull_run", "resolve_remote", "register_pending",
           "pending", "fetch_on_demand", "clear_pending"]

#: default wall bound for one whole run-directory pull (manifest +
#: download + verify, retries included). Keep it under the fleet
#: lease TTL: the lease is extended by exactly this much while the
#: coordinator syncs (the JAX package's planlint PL016 warns otherwise;
#: the port's PL016 comes with the service, ROADMAP.md A.11(d4)).
DEFAULT_SYNC_TIMEOUT_S = 120.0


class SyncError(RuntimeError):
    """One sync attempt failed (transport error, manifest mismatch,
    rename race). Retried under the policy; terminal after that.
    ``attempts`` (set by pull_run on the terminal raise) records how
    many attempts were burned, so the journal's ``artifact-sync``
    failure event can account for every injected fault it absorbed."""

    attempts = 0


def resolve_remote(kind):
    """The Remote class for a worker kind, or None for an unknown
    one. THE one worker-kind dispatch table: the fleet dispatcher,
    the on-demand fetch, and Worker.connect all resolve through it,
    so adding a kind (docker, k8s, ...) is one edit."""
    from ..control import remotes
    return {"local": remotes.LocalRemote,
            "ssh": remotes.SSHRemote}.get(str(kind))


def manifest(conn, remote_dir, timeout_s=DEFAULT_SYNC_TIMEOUT_S):
    """``{relative_path: size}`` for every file under ``remote_dir``
    on the worker, via the control plane (GNU find, which every
    supported worker OS ships). Raises SyncError on transport failure
    or an empty directory -- a completed run always has artifacts, so
    an empty manifest means the path is wrong or the host lost it."""
    cmd = (f"find {shlex.quote(str(remote_dir))} -type f "
           f"-printf '%P\\t%s\\n'")
    res = conn.execute({"timeout": timeout_s}, {"cmd": cmd})
    if not isinstance(res, dict) or res.get("exit") != 0:
        raise SyncError(
            f"manifest failed (exit {res.get('exit') if isinstance(res, dict) else res!r}): "
            f"{(res.get('err') or '')[:200] if isinstance(res, dict) else ''}")
    out = {}
    for line in (res.get("out") or "").splitlines():
        rel, sep, size = line.rpartition("\t")
        if not sep:
            continue
        try:
            out[rel] = int(size)
        except ValueError:
            continue
    if not out:
        raise SyncError(f"empty manifest for {remote_dir}: no "
                        "artifacts to sync")
    return out


def _verify(local_dir, man):
    """Every manifest entry must exist locally with a matching size;
    a partial download raises rather than going visible."""
    for rel, size in man.items():
        p = os.path.join(local_dir, rel)
        try:
            got = os.path.getsize(p)
        except OSError:
            raise SyncError(f"partial download: {rel} missing") \
                from None
        if got != size:
            raise SyncError(f"partial download: {rel} is {got} bytes, "
                            f"manifest says {size}")


def pull_run(conn, remote_dir, dest, *, timeout_s=DEFAULT_SYNC_TIMEOUT_S,
             policy=None):
    """Mirror ``remote_dir`` (on the worker behind ``conn``) to the
    local directory ``dest``, atomically: the destination either
    doesn't exist or is a complete, manifest-verified copy. Returns
    ``{"files", "bytes", "attempts", "wall_s"}`` (``"already": True``
    when the destination was mirrored before); raises SyncError after
    the retry budget."""
    dest = os.path.abspath(str(dest)).rstrip(os.sep)
    if os.path.isdir(dest):
        return {"files": 0, "bytes": 0, "attempts": 0, "wall_s": 0.0,
                "already": True}
    policy = policy or RetryPolicy.bounded(timeout_s)
    t0 = time.monotonic()
    deadline = t0 + float(timeout_s)
    attempts = 0

    def left():
        """Remaining wall budget: ONE deadline covers manifest +
        download + retries, so the whole pull really fits inside
        timeout_s (the lease is extended by exactly that much; two
        back-to-back full-timeout transport calls would overrun it)."""
        return max(1.0, deadline - time.monotonic())

    def attempt():
        nonlocal attempts
        attempts += 1
        from .. import obs
        obs.instant("fleet.sync.attempt", cat="fleet",
                    attempt=attempts, dir=str(remote_dir)[-120:])
        if os.path.isdir(dest):     # raced another syncer: their copy won
            return {"files": 0, "bytes": 0, "already": True}
        man = manifest(conn, remote_dir, timeout_s=left())
        tmp_root = store.sync_tmp_path(
            f"{os.getpid()}-{threading.get_ident()}")
        shutil.rmtree(tmp_root, ignore_errors=True)
        os.makedirs(tmp_root, exist_ok=True)
        tmp = os.path.join(tmp_root, os.path.basename(dest))
        try:
            res = conn.download({"timeout": left()}, str(remote_dir),
                                tmp)
            if not isinstance(res, dict) or res.get("exit") != 0:
                raise SyncError(
                    f"download failed (exit "
                    f"{res.get('exit') if isinstance(res, dict) else res!r}): "
                    f"{(res.get('err') or '')[:200] if isinstance(res, dict) else ''}")
            _verify(tmp, man)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            try:
                os.rename(tmp, dest)
            except OSError as e:
                if not os.path.isdir(dest):   # a real rename failure
                    raise SyncError(f"couldn't publish sync: {e}") \
                        from None
            # the manifest rides in the result so the dispatcher can
            # journal it: fleetlint re-verifies the mirrored copy
            # against these sizes post hoc (FL008)
            return {"files": len(man), "bytes": sum(man.values()),
                    "manifest": dict(man)}
        finally:
            shutil.rmtree(tmp_root, ignore_errors=True)

    try:
        out = policy.call(attempt, retry_on_exception=SyncError,
                          site="fleet.artifact_sync")
    except SyncError as e:
        e.attempts = attempts
        raise
    out["attempts"] = attempts
    out["wall_s"] = round(time.monotonic() - t0, 3)
    return out


# ---------------------------------------------------------------------------
# download on demand (the viewer's fallback for not-yet-mirrored runs)

_pending = {}           # store-relative run dir -> how to fetch it
_pending_lock = threading.Lock()
_fetch_locks = {}       # pending key -> its in-flight-pull lock


def register_pending(rel, *, kind, conn_spec, remote_dir,
                     timeout_s=DEFAULT_SYNC_TIMEOUT_S):
    """Remember that the run at store-relative ``rel`` still lives on
    a worker host (sync failed terminally); `fetch_on_demand` pulls it
    on first access."""
    with _pending_lock:
        _pending[str(rel).strip("/")] = {
            "kind": str(kind), "conn_spec": dict(conn_spec or {}),
            "remote_dir": str(remote_dir), "timeout_s": timeout_s,
        }


def pending():
    with _pending_lock:
        return dict(_pending)


def clear_pending():
    with _pending_lock:
        _pending.clear()
        _fetch_locks.clear()


def fetch_on_demand(rel):
    """If ``rel`` (a store-relative path, possibly a file inside a
    run directory) is covered by a pending registration, pull the run
    now. Returns True when the path should exist locally afterwards.
    Serialized PER RUN: two browser tabs racing the same run do one
    pull, while fetches of different runs proceed independently (one
    slow worker host must not queue every other 404-fallback)."""
    rel = str(rel).strip("/")
    with _pending_lock:
        match = next((k for k in _pending
                      if rel == k or rel.startswith(k + "/")), None)
        entry = dict(_pending[match]) if match else None
        lock = _fetch_locks.setdefault(match, threading.Lock()) \
            if match else None
    if entry is None:
        return False
    base = resolve_remote(entry["kind"])
    if base is None:
        return False
    dest = os.path.join(os.path.abspath(store.base_dir), match)
    with lock:
        if not os.path.isdir(dest):
            try:
                conn = base().connect(entry["conn_spec"])
                pull_run(conn, entry["remote_dir"], dest,
                         timeout_s=entry["timeout_s"])
            except Exception as exc:  # noqa: BLE001 - 404 instead
                logger.warning("on-demand artifact fetch of %s "
                               "failed: %s", rel, exc)
                return False
    with _pending_lock:
        _pending.pop(match, None)
        _fetch_locks.pop(match, None)
    from .. import obs
    obs.inc("fleet.artifact_fetch_on_demand")
    return True
