"""The search chunk as replays of a captured CUDA graph: the port's
counterpart of the reference's jitted ``lax.while_loop`` over the search
body (``jepsen_tpu/checker/jax_wgl.py:827-860``).

The reference runs a chunk as one compiled dispatch. ``torch_wgl``'s
eager loop issues every torch call of ``body`` from Python, ~700 an
iteration on a single key and ~11,700 on the key batch's scan rollout,
and each call takes the GIL back from whatever else the process runs.
On the card ``torch_wgl.run_chunk`` instead captures ``body`` applied
once into a ``torch.cuda.CUDAGraph`` and replays it:

* **Capture in place.** The graph runs on the search's own carry. The
  buffers ``body`` writes in place (the stack buffers and the table) are
  static as they are; the functional results are ``copy_``'d back into
  the carry's tensors at the end of the captured region, so the graph
  holds no second carry. It ends by writing the loop's condition (some
  key running) into a pinned host flag with a captured async copy.
* **Replay.** One ``replay()``, one event record, the event's
  ``synchronize()`` (the GIL is released while it waits) and a numpy
  read of the flag: the host issues one launch an iteration, and the
  loop stops exactly where the eager loop stops.
* **Reuse.** A graph belongs to one search at a time, through that
  search's ``Lease``. When the search ends, the graph goes to a cache
  keyed by the search's shape; a later search of that shape copies its
  consts and carry into the graph's static tensors and replays without
  a capture, as the reference's jit cache compiles a shape once per
  process. A concurrent search of a shape whose graph is leased captures
  its own. The cache keeps at most ``CACHE_BYTES`` of idle graphs
  (static carry, consts and the graph's private memory pool) and evicts
  the least recently used first; a graph larger than the bound is freed
  when its search ends. A search that moves to another shape (the key
  batch's compaction) clones whatever its carry still shares with the
  graph it lets go, so an idle graph's static tensors are never part
  of a running search.
* **Counts.** ``rollout.launches`` gets, per replay, the kernel launches
  the capture recorded (``rollout.counting_captured``); ``captures``,
  ``hits``, ``replays`` and ``evictions`` count this module's work.

Captures run on a side stream in ``thread_local`` capture mode, one at a
time (a lock), since competition racers, the service's solo searches and
campaign cells search from several threads at once. Nothing here falls
back: a capture that fails raises. A device-wide
``torch.cuda.synchronize()`` from another thread while a capture is open
fails both (measured on the H100: every other call a search makes from
another thread is legal), so the port synchronizes streams, never the
device, on its search paths.

``GRAPH`` makes the graph object and ``DEVICES`` names the device types
the graph path runs on; the CPU tests put a stub graph and ``"cpu"`` in
them, which drives this module's logic without a card.

The cache's bound counts against the card's memory beside the searches
that a capacity plan counts: a campaign run under a device memory budget
keeps the idle graphs to what its device slots leave of that budget
(``budget_bound``, ``bounded``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading

import torch

from . import rollout

#: byte bound of the idle graphs the cache keeps: 4 GiB, 5% of the
#: H100's 80 GB, room for the main path's graphs (~0.3-0.7 GB each) and
#: a few key-batch widths. Under a device memory budget a campaign
#: lowers it to what its slots leave free (``budget_bound``)
CACHE_BYTES = 4 << 30

#: device types the graph path runs on (the tests add "cpu" with a stub
#: ``GRAPH``)
DEVICES = ("cuda",)

#: module counters, like ``rollout.launches`` (set them to 0 to start a
#: count): graphs captured, searches that took a cached graph, replays,
#: idle graphs evicted or freed over the bound
captures = hits = replays = evictions = 0
#: the node count of each captured graph, in capture order (the last 64)
node_counts = collections.deque(maxlen=64)

_count_lock = threading.Lock()
_capture_lock = threading.Lock()
_side = {}
#: the pinned flags of closed graphs, for new graphs to take
_flags = []
_flags_lock = threading.Lock()


def applies(device):
    """Whether searches on ``device`` run their chunks as graph replays."""
    return torch.device(device).type in DEVICES


def _count(name, n=1):
    with _count_lock:
        globals()[name] += n


def stats():
    """The module's counters and the idle cache's size, as a dict."""
    with _count_lock, _cache.lock:
        return {"captures": captures, "hits": hits, "replays": replays,
                "evictions": evictions, "node_counts": list(node_counts),
                "cached": len(_cache.idle),
                "cached_bytes": sum(e.nbytes for e in _cache.idle.values())}


def _node_count(raw_graph):
    """Nodes of a captured ``cudaGraph_t`` (``cuGraphGetNodes`` of
    ``libcuda``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None,
                             ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return n.value


class CudaGraph:
    """One CUDA graph: captured on a side stream in ``thread_local``
    mode, replayed on the caller's current stream with one event to wait
    on."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.event = torch.cuda.Event()
        self.nodes = None
        self.pool_bytes = 0

    def capture(self, fn):
        """Record ``fn()``'s device work; nothing of it runs."""
        current = torch.cuda.current_stream(self.device)
        with _capture_lock:
            side = _side.get(self.device)
            if side is None:
                side = _side[self.device] = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
            self.graph.instantiate()
        self.nodes = _node_count(self.graph.raw_cuda_graph())
        pool = tuple(self.graph.pool())
        self.pool_bytes = sum(
            s["total_size"] for s in torch.cuda.memory.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == pool)

    def replay(self):
        """Run the graph once and wait for it (the GIL is free while the
        event is waited on)."""
        self.graph.replay()
        self.event.record()
        self.event.synchronize()

    def close(self):
        self.graph.reset()


#: the graph factory, ``GRAPH(device)``; the tests put a stub here
GRAPH = CudaGraph


def _host_flag(device):
    """A one-element bool flag on the host for a graph to write: on the
    card pinned, and taken from the closed graphs' flags where one is
    free. A pinned flag is never freed: PyTorch's host allocator records
    an event on the streams a freed block was used on, here the capture
    stream, and an event recorded while another thread captures on that
    stream cannot be queried afterwards (``cudaErrorCapturedEvent``)."""
    if device.type != "cuda":
        return torch.zeros(1, dtype=torch.bool)
    with _flags_lock:
        if _flags:
            return _flags.pop()
    return torch.zeros(1, dtype=torch.bool).pin_memory()


def _return_flag(flag):
    with _flags_lock:
        if flag.is_pinned():
            _flags.append(flag)


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def budget_bound(budget_bytes, slots, peak_cell_bytes):
    """The idle graphs' bound under a capacity plan: what ``slots``
    searches of the plan's peak cell footprint leave of the device
    memory budget (0 when they fill it: every graph is then freed when
    its search ends), and never more than ``CACHE_BYTES``."""
    return max(0, min(CACHE_BYTES,
                      int(budget_bytes) - int(slots) * int(peak_cell_bytes)))


@contextlib.contextmanager
def bounded(nbytes):
    """Keep the idle graphs to ``nbytes`` while the block runs (evicting
    at once what no longer fits), then restore the bound."""
    global CACHE_BYTES
    with _cache.lock:
        saved, CACHE_BYTES = CACHE_BYTES, int(nbytes)
    _cache.trim()
    try:
        yield
    finally:
        with _cache.lock:
            CACHE_BYTES = saved


def _detach(carry, static):
    """``carry`` with each tensor that shares storage with one of
    ``static`` cloned."""
    ptrs = {s.untyped_storage().data_ptr() for s in static}
    return tuple(x.clone() if x.untyped_storage().data_ptr() in ptrs else x
                 for x in carry)


class Entry:
    """One captured search iteration over its static carry and consts.

    ``body(carry, consts)`` is one search iteration and
    ``flag_fn(carry)`` the loop's condition (a bool tensor): both come
    from ``torch_wgl._build_search`` and stay referenced here, since the
    graph reads the tensors they close over. ``carry`` becomes the
    static carry (the entry owns its tensors from now on); ``consts``
    are cloned."""

    def __init__(self, key, body, flag_fn, carry, consts, device):
        self.key = key
        self.body, self.flag_fn = body, flag_fn
        self.carry = tuple(carry)
        self.consts = tuple(c.clone() for c in consts)
        self.flag = _host_flag(device)
        self.flag_np = self.flag.numpy()
        self.graph = GRAPH(device)

        def step():
            out = body(self.carry, self.consts)
            for s, x in zip(self.carry, out):
                if x is not s:
                    s.copy_(x)
            self.flag.copy_(flag_fn(self.carry).reshape(1),
                            non_blocking=True)

        if not all(x.is_contiguous() for x in self.carry):
            raise ValueError("chunk graph: a carry tensor is not contiguous")
        try:
            with rollout.counting_captured() as launched:
                self.graph.capture(step)
        except BaseException:
            _return_flag(self.flag)
            raise
        #: rollout kernel launches per replay
        self.launches = launched[0]
        self.nodes = self.graph.nodes
        self.nbytes = (_nbytes(self.carry) + _nbytes(self.consts)
                       + self.graph.pool_bytes)
        _count("captures")
        with _count_lock:
            node_counts.append(self.nodes)

    def load(self, carry=None, consts=None):
        """Copy a search's carry and/or consts into the static tensors."""
        for dst, srcs in ((self.carry, carry), (self.consts, consts)):
            if srcs is None:
                continue
            if len(dst) != len(srcs):
                raise ValueError("chunk graph: carry or consts of another "
                                 "layout")
            for s, x in zip(dst, srcs):
                if x is s:
                    continue
                if x.shape != s.shape or x.dtype != s.dtype:
                    raise ValueError(
                        f"chunk graph: {tuple(x.shape)} {x.dtype} into a "
                        f"static {tuple(s.shape)} {s.dtype}")
                s.copy_(x)

    def replay(self):
        """One search iteration; returns whether a key is still running."""
        self.graph.replay()
        rollout.add_replayed(self.launches)
        _count("replays")
        return bool(self.flag_np[0])

    def close(self):
        self.graph.close()
        _return_flag(self.flag)
        self.graph = self.body = self.flag_fn = self.flag = None
        self.flag_np = None
        self.carry = self.consts = ()


class _Cache:
    """Idle graphs by insertion order (least recently released first)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.idle = collections.OrderedDict()

    def acquire(self, key):
        """The most recently released idle graph of ``key``, taken out of
        the cache, or None."""
        with self.lock:
            for eid in reversed(self.idle):
                if self.idle[eid].key == key:
                    entry = self.idle.pop(eid)
                    break
            else:
                return None
        _count("hits")
        return entry

    def release(self, entry):
        """Keep ``entry`` idle, then evict the least recently released
        until the idle graphs fit ``CACHE_BYTES``; a graph larger than the
        bound is freed at once."""
        with self.lock:
            if entry.nbytes > CACHE_BYTES:
                out = [entry]
            else:
                self.idle[id(entry)] = entry
                out = self._over()
        self._close(out)

    def trim(self):
        """Evict the least recently released until the idle graphs fit
        ``CACHE_BYTES``."""
        with self.lock:
            out = self._over()
        self._close(out)

    def _over(self):
        out = []
        total = sum(e.nbytes for e in self.idle.values())
        while total > CACHE_BYTES:
            _, old = self.idle.popitem(last=False)
            total -= old.nbytes
            out.append(old)
        return out

    @staticmethod
    def _close(out):
        for old in out:
            old.close()
        if out:
            _count("evictions", len(out))

    def clear(self):
        """Free every idle graph."""
        with self.lock:
            out = list(self.idle.values())
            self.idle.clear()
        for e in out:
            e.close()


_cache = _Cache()


def clear():
    """Free every idle graph of the cache (graphs held by running
    searches stay theirs)."""
    _cache.clear()


class Lease:
    """One search's hold on at most one graph at a time. Use it as a
    context manager around the search (or call ``release``): its graph
    returns to the cache at the end. ``captured`` counts the graphs this
    lease captured since the caller last reset it (the phase plane's
    compile lap)."""

    def __init__(self):
        self.entry = None
        self.consts = None        # the caller's consts the entry holds
        self.warmed = set()       # shapes this search ran eagerly once
        self.captured = 0

    def holds(self, key, carry, consts):
        """``(entry, carry)``: this lease's graph of ``key`` with
        ``carry`` and ``consts`` in its static tensors, taking an idle one
        from the cache when the lease holds none of that shape (None when
        the cache has none). A graph of another shape goes back to the
        cache, and the returned ``carry`` is the caller's with every
        tensor it shares with that graph cloned first (``compact`` passes
        the table and the counters through as they are): another search
        may take the idle graph and load its own carry into it."""
        entry = self.entry
        if entry is not None and entry.key != key:
            carry = _detach(carry, entry.carry)
            self.release()
            entry = None
        if entry is None:
            entry = _cache.acquire(key)
            if entry is None:
                return None, carry
            self.entry, self.consts = entry, None
        if carry is not entry.carry:
            entry.load(carry=carry)
        if consts is not self.consts:
            entry.load(consts=consts)
            self.consts = consts
        return entry, entry.carry

    def capture(self, key, body, flag_fn, carry, consts, device):
        """Capture ``body`` on ``carry`` (which the new graph owns from
        now on) and hold the graph (``holds`` found none of this shape,
        so the lease holds none)."""
        self.entry = Entry(key, body, flag_fn, carry, consts,
                           torch.device(device))
        self.consts = consts
        self.captured += 1
        return self.entry

    def take_captured(self):
        """The graphs captured since the last call, and reset."""
        n, self.captured = self.captured, 0
        return n

    def release(self):
        if self.entry is not None:
            entry, self.entry, self.consts = self.entry, None, None
            _cache.release(entry)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False
