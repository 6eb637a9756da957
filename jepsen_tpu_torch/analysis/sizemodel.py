"""sizemodel: the one symbolic size model for the port's device searches
(the port's copy of ``jepsen_tpu/analysis/sizemodel.py``).

Every tensor the device search allocates is a function of a few
integers -- op count ``n``, state width ``S``, point concurrency ``C``,
arg width ``A``, key count -- determined before anything runs. The
capacity planner (``capplan``) quotes them per campaign cell, so they
are defined here once:

* ``plan_sizes`` and ``bucket_for`` delegate to the live engine
  (``torch_wgl._plan_sizes``) and to ``campaign.compile_cache``; no
  formula is copied. The chains' shape comes from
  ``torch_wgl._rollout_shape`` and a batch's narrowed per-key sizes from
  ``keyshard.batch_sizes``.
* The int32-wall arithmetic (``history_cells``, ``buffer_cells``,
  ``int32_wall``) is the reference's, so both packages give the same
  CP007/CP008 diagnostics on the same matrix.
* ``hbm_bytes``, ``closure_shape`` and ``stream_frontier_shape`` count
  the port's own buffers, not the JAX engine's 4-byte carry cells: the
  int64 fingerprint pairs and dedup table, the search body's
  per-iteration transients (the (W, n) candidate selection, the
  (W, n, C) one-hot product where n*C <= 32768, the children's bitsets,
  the greedy chains), the bf16 closure on CUDA and the fold's second
  fingerprint pair. Each stays an upper bound on what the search holds
  at once, as the reference's docstring promises; ``chip_smoke.py``'s
  ``capacity`` phase holds the bound against
  ``torch.cuda.max_memory_allocated`` on the card. The field names and
  the ``total`` key are the reference's; only the byte figures differ
  (ROADMAP.md, deliberate divergences).

Dependency-light: the engines are imported lazily inside the
functions, so the analyzer surface loads without a card.
"""

from __future__ import annotations

import math

__all__ = ["INT32_CELL_LIMIT", "BYTES_PER_CELL", "bucket", "n_floor",
           "bucket_for", "plan_sizes", "history_cells", "history_ranks",
           "buffer_cells", "int32_wall", "hbm_bytes", "search_shape",
           "closure_shape", "stream_frontier_shape", "ledger_key_shape"]

#: cells (int32 lanes) addressable before int32 indices overflow: the
#: reference's wall, kept so CP007/CP008 read the same on both packages
INT32_CELL_LIMIT = 2 ** 31

#: an int32 cell: the op columns, bitset words and model states
BYTES_PER_CELL = 4

#: an int64 lane: fingerprint sums, the dedup table, ranks and indices
_I64 = 8


# ---------------------------------------------------------------------------
# delegation: the live implementations, not restatements

def bucket(x, lo=1):
    """Round up to a power of two (>= lo): the shared shape-bucket
    rule (``campaign.compile_cache.bucket``)."""
    from ..campaign import compile_cache
    return compile_cache.bucket(x, lo)


def n_floor():
    """The minimum op-count bucket: a constant in the port
    (``torch_wgl._n_floor``)."""
    from ..checker.torch_wgl import _n_floor
    return _n_floor()


def bucket_for(n_ops):
    """The op-count bucket an ``n_ops``-row encoded history pads to:
    the grouping key every engine, the service coalescer and capplan's
    predictions share."""
    from ..campaign import compile_cache
    return compile_cache.bucket_for(n_ops)


def plan_sizes(n, S, C, frontier_width=None, stack_size=None,
               table_size=None):
    """``(B, W, O, T)`` for an ``n``-op, ``S``-state, ``C``-concurrency
    search: the bitmask word count, frontier width, stack depth and
    dedup-table size the engine allocates. Delegates to
    ``torch_wgl._plan_sizes``."""
    from ..checker import torch_wgl
    return torch_wgl._plan_sizes(n, S, C, frontier_width, stack_size,
                                 table_size)


# ---------------------------------------------------------------------------
# the int32 wall (the reference's arithmetic, unchanged)

def history_cells(n, arg_width=1, keys=1):
    """int32 cells one encoded history occupies on device:
    ``keys * n * (2*A + 4)`` (invoke/return/f/ok lanes plus the args
    and ret vectors)."""
    return int(keys) * int(n) * (2 * int(arg_width) + 4)


def history_ranks(n):
    """Event ranks ``_encode_arrays`` re-ranks into int32: two events
    (invoke + return) per op."""
    return 2 * int(n)


def buffer_cells(n, S, C=None, keys=1, sizes=None):
    """Cells per search buffer for an n-op plan: ``{"stack", "dedup
    table", "frontier step"}``. ``sizes`` may pass a pre-computed
    ``(B, W, O, T)``."""
    C = C if C is not None else max(1, min(int(n), 64))
    B, W, O, T = sizes if sizes is not None else plan_sizes(n, S, C)
    keys = int(keys)
    return {
        "stack": keys * O * (B + S),
        "dedup table": T * 2,
        "frontier step": keys * W * C * S,
    }


def int32_wall(n, arg_width=1, keys=1, S=None, C=None):
    """Proximity to the int32 index wall for one search plan:
    ``{"cells", "which", "frac"}``, ``frac`` the largest extent's
    fraction of 2^31. ``frac >= 1.0`` is CP008, ``>= 0.5`` CP007. The
    port's own indices are int64 (ROADMAP.md C, the int32 wall), so
    this is the reference's wall, kept so both packages diagnose a
    matrix alike."""
    extents = {"encoded history": history_cells(n, arg_width, keys),
               "event ranks": history_ranks(n)}
    if S is not None:
        extents.update(buffer_cells(n, S, C, keys=keys))
    which = max(extents, key=lambda k: extents[k])
    cells = extents[which]
    return {"cells": cells, "which": which,
            "frac": round(cells / INT32_CELL_LIMIT, 6)}


# ---------------------------------------------------------------------------
# the port's bytes

def _unpack_bytes(rows, n):
    """Peak of ``words.unpack_unlin`` over ``rows`` bitsets of n ops:
    the repeated words, the shift and the mask (int32 each), and the
    bool result."""
    return rows * n * (3 * BYTES_PER_CELL + 1)


def _search_transients(n, S, C, A, B, W, NS, R, K, on_card=True):
    """Bytes of one search iteration's transients (``torch_wgl`` body)
    for K keys, counted as if all were live at once: an upper bound on
    the body's peak above its carry."""
    from ..checker import torch_wgl
    M = W * C
    ML = M + NS * R
    KML = K * ML
    # candidate selection: unlin and cand (bool, live for the body),
    # the where over ret, the masks, rank as int64 twice (cast and
    # cumsum) ...
    sel = _unpack_bytes(K * W, n) + K * W * n * (
        2 + BYTES_PER_CELL + 3 + 2 * _I64)
    if n * C <= 32768 and on_card:
        # ... and the card's one-hot product: two bool (W, n, C) masks
        # and their int64 product
        sel += K * W * n * C * (2 + _I64)
    else:
        # ... or the scatter's target: the mask, rank - 1, the where
        sel += K * W * n * (2 + 2 * _I64) + K * W * (C + 1) * _I64
    # the children: op indices and columns, the model step (int64 and
    # int32 planes), the children's bitsets and their fingerprint sums
    kid = K * M * (6 * _I64 + (2 * A + 2) * BYTES_PER_CELL
                   + S * (_I64 + 2 * BYTES_PER_CELL)
                   + B * BYTES_PER_CELL + 4 * _I64)
    roll = 0
    if R:
        rows = K * NS * R
        # the chains' bitsets: the one-hot word masks, their cumsum,
        # after, before (int64) and the int32 copy; the flipped copies
        # and the depth pass (int32 and, through u32, int64 twice)
        roll = rows * B * (4 * _I64 + BYTES_PER_CELL
                           + BYTES_PER_CELL + BYTES_PER_CELL + 2 * _I64)
        roll += rows * (S * 3 * BYTES_PER_CELL + 8 * _I64)
        # the scan's per-step unpack (one step's (K, NS, n) at a time)
        roll += _unpack_bytes(K * NS, n) + K * NS * n * (
            2 + BYTES_PER_CELL + S * _I64 + S * BYTES_PER_CELL)
    # the step's concatenations, the salted fingerprints, the twin
    # dedup and the probe round over all K*ML lanes, and the push
    tail = KML * (B * BYTES_PER_CELL + S * (BYTES_PER_CELL + 2 * _I64)
                  + 16 * _I64
                  + torch_wgl.PROBES * (3 * _I64 + 2 * _I64 + 3))
    return sel + kid + roll + tail


def hbm_bytes(n, S, C=None, keys=1, arg_width=1, sizes=None,
              engine=None, device="cuda"):
    """Device-memory footprint (bytes) of one padded search: the carry
    (the stack's bitsets, states and int64 fingerprint pairs, the int64
    dedup table with its claim row, the TOPK witness slots), the
    encoded history's op columns, and the body's per-iteration
    transients (``frontier``). An upper-bound planning number, not an
    allocator trace: capplan compares it against
    ``--device-mem-budget`` to size device slots.

    ``engine`` names the search: a label ending in ``-batch`` is the
    key batch, whose chains are one scan of <= 256 steps per key and,
    for ``keys`` > 1, whose per-key frontier and stack narrow as
    ``keyshard.batch_sizes`` narrows them; anything else is the solo
    search with its NS deep chains. ``keys`` defaults to 1, one padded
    key lane: the batch's real allocation scales with its pow-2 runtime
    key axis, which is time-limit-bound (capplan's plans carry this
    caveat in ``hbm.note``). ``device`` is where the search runs: the
    card's selection takes the one-hot product, the CPU's the
    scatter."""
    from ..checker import torch_wgl
    C = C if C is not None else max(1, min(int(n), 64))
    n, S, C, keys = int(n), int(S), int(C), int(keys)
    A = int(arg_width)
    B, W, O, T = sizes if sizes is not None else plan_sizes(n, S, C)
    batch = engine is not None and str(engine).endswith("-batch")
    if batch and keys > 1 and sizes is None:
        from ..parallel.keyshard import batch_sizes
        B, W, O, T = batch_sizes(keys, (B, W, O, T))
    R, NS = torch_wgl._rollout_shape(max(keys, 2) if batch else 1, n, S)
    out = {
        # buf_lin (K*O+1, B) int32 + buf_state (K*O+1, S) int32 +
        # buf_fp (K*O+1, 2) int64
        "stack": (keys * O + 1) * ((B + S) * BYTES_PER_CELL + 2 * _I64),
        # tab (T+1, 2) int64 pairs and the claim row (TC,) int64,
        # shared across the key axis
        "dedup": (T + 1) * 2 * _I64 + torch_wgl.TC * _I64,
        # the body's per-iteration transients
        # the body's per-iteration transients, with the last-lane
        # scatters' (T+1,), (K*O+1,) and (TC+1,) int64 winner rows
        "frontier": _search_transients(
            n, S, C, A, B, W, NS, R, keys,
            on_card=str(device).startswith("cuda"))
        + (T + keys * O + torch_wgl.TC + 3) * _I64,
        # best_depth (int64) / best_lin / best_state TOPK slots, per key
        "witness": keys * torch_wgl.TOPK * (
            _I64 + (B + S) * BYTES_PER_CELL),
        # invoke/ret/f + args/rets columns, ok words, salt and n_ok
        "encoded": history_cells(n, A, keys) * BYTES_PER_CELL
        + keys * (B * BYTES_PER_CELL + 2 * _I64),
    }
    out["total"] = sum(out.values())
    return out


def search_shape(model, n_ops, *, keys=1, concurrency=None,
                 engine="torch-wgl-batch"):
    """The full symbolic prediction for one device search of a
    ``model`` history with ``n_ops`` encoded rows (per key): padded
    bucket, plan sizes, device-memory footprint, int32-wall proximity.
    capplan's per-cell unit. ``concurrency`` bounds the point
    concurrency C; ``keys`` scales the per-key buffers.

    Raises (KeyError on an unknown model, TypeError/ValueError on a
    history-dependent state size) rather than guessing: capplan turns
    that into an unknown-shape cell (CP001)."""
    from ..models import model_spec
    spec = model_spec(model)
    n_ops = int(n_ops)
    n_pad = bucket_for(max(1, n_ops))
    # history-dependent state sizes (queues: capacity = #enqueues)
    # cannot be derived without the history; let the TypeError out
    S = int(spec.state_size(None))
    if spec.pad_state is not None:
        S = bucket(S, 2)
    C = min(bucket(max(1, int(concurrency or 4)), 4), n_pad)
    A = int(spec.arg_width)
    B, W, O, T = plan_sizes(n_pad, S, C)
    return {
        "model": spec.name,
        "engine": str(engine),
        "n_ops": n_ops,
        "bucket": n_pad,
        "S": S, "C": C, "A": A,
        "sizes": {"B": B, "W": W, "O": O, "T": T},
        "hbm": hbm_bytes(n_pad, S, C, keys=keys, arg_width=A,
                         engine=engine),
        "int32": int32_wall(n_pad, arg_width=A, keys=keys, S=S, C=C),
    }


def closure_shape(n_txns, *, lo=64, device="cuda"):
    """The symbolic prediction for one transactional cycle probe
    (``cycle.transitive_closure`` / ``IncrementalClosure``): the
    txn-count pads to a pow-2 bucket (floor ``lo``) and the device
    holds the padded 0/1 matrix in the matmul type (bf16 on CUDA,
    float32 elsewhere: ``cycle._dtype``), the bool upload and its
    widened copy, and per squaring the matmul's result and its bool
    threshold. ``passes`` is the fixpoint bound per from-scratch
    closure (ceil(log2 n))."""
    n_txns = int(n_txns)
    n_pad = bucket(max(1, n_txns), lo)
    per = 2 if str(device).startswith("cuda") else 4
    lanes = n_pad * n_pad
    hbm = {
        # the bool upload and its widened copy
        "adjacency": lanes * (1 + per),
        # the padded matrix and the closure being squared
        "frontier": lanes * 2 * per,
        # R + R@R and its > 0 (bool)
        "step": lanes * (per + 1),
    }
    hbm["total"] = sum(hbm.values())
    return {
        "model": "txn-closure",
        "engine": "txn-closure",
        "n_ops": n_txns,
        "bucket": n_pad,
        "passes": max(1, int(math.ceil(math.log2(max(2, n_pad))))),
        "hbm": hbm,
        "int32": {"cells": lanes, "which": "closure frontier",
                  "frac": round(lanes / INT32_CELL_LIMIT, 6)},
    }


#: the CUDA caching allocator's block: requests round up to 512 bytes, and
#: a cached block of the large pool is not split when less than 1 MiB of
#: it would be left, so a request of 1 MiB or more may be charged up to
#: that much beyond its rounded size
_ALLOC_ROUND, _ALLOC_UNSPLIT = 512, 1 << 20


def _charged(nbytes):
    """The most the caching allocator charges for one request."""
    r = -(-int(nbytes) // _ALLOC_ROUND) * _ALLOC_ROUND
    return r + (_ALLOC_UNSPLIT if r >= _ALLOC_UNSPLIT else 0)


def stream_frontier_shape(frontier_cap, window, *, state_size=1,
                          arg_width=2, open_cap=None, events=64,
                          device="cuda"):
    """The symbolic prediction for one monitored stream's
    device-resident frontier (``checker/streamlin`` /
    ``monitor/wgl_stream.StreamCheck``): the frontier rows pad to a
    pow-2 bucket and the device keeps, per stream, the linearized
    bitsets (F x window/32 int32 words), the model states (F x S), the
    open-op bitset and the window's encoded cells. ``pool`` is what one
    fold allocates besides them, C the open-op axis. On CUDA the fold is
    one launch of the fold kernel (``checker/fold_kernel``): its scratch
    (``fold_kernel.plan``: two heaps of F row slots with each slot's four
    fingerprints, two row-to-slot orders, the seen and work lists, the
    open ops, and per pool entry (F + F*C of them) two keys, two indices
    and three fingerprints with its pool index), its outputs,
    the one upload of fingerprint multipliers and events, and the
    results' stack, each allocation as the caching allocator charges
    it. Elsewhere (``device``) the fold is ``fold_kernel.plain``: a
    closure pass's transient pool of (F + F*C) candidate rows, the
    candidates' bitsets, the pool's concatenation, its int64 words and
    the four multiply-shift fingerprints over them (the port's two odd
    ones beside the reference's two, ROADMAP.md C.3), the lexsort keys
    and the sorted and compacted copies. Per-chunk fold cost is
    O(events x passes x F x C), independent of the stream's consumed
    prefix."""
    F = bucket(max(1, int(frontier_cap)), 1)
    NW = bucket(max(1, int(window)), 32)
    B = max(1, NW // 32)
    S = max(1, int(state_size))
    A = max(1, int(arg_width))
    C = bucket(max(1, int(open_cap if open_cap is not None else 8)), 1)
    E = bucket(max(1, int(events)), 1)
    per = BYTES_PER_CELL
    pool = F + F * C
    hbm = {
        "lin": F * B * per,
        "state": F * S * per,
        "window": NW * (1 + 2 * A) * per,
        "open": B * per,
    }
    if str(device).startswith("cuda"):
        from ..checker import fold_kernel
        hbm = {k: _charged(v) for k, v in hbm.items()}
        hbm["window"] = (_charged(NW * per) + 2 * _charged(NW * A * per)
                         + _charged(B * per))        # clear_w beside
        hbm["pool"] = sum(_charged(x) for x in (
            fold_kernel.scratch_bytes(1, F, B, S, A, C),
            F * B * per, F * S * per, F, B * per,      # the outputs
            5 * per, 5 * per,                          # results, stack
            (4 * (B + S) + 2 * E) * per))              # the upload
    else:
        # per word: the candidates (int32 bitsets), the pool's int32
        # concatenation, the fingerprints' concatenation and its int64
        # words with three multiply-shift temporaries, the sorted
        # gather, and one int64 spare for the allocator's order; per row
        # the four hashes, the sort keys, order and the compaction's
        # positions
        hbm["pool"] = pool * (B + S) * (4 * per + 5 * _I64) \
            + pool * 16 * _I64
    hbm["total"] = sum(hbm.values())
    cells = pool * (B + S)
    return {
        "model": "streamlin",
        "engine": "torch-streamlin",
        "frontier_cap": F,
        "bucket": F,
        "window": NW,
        "open_cap": C,
        "events": E,
        "fold_cells": E * F * C,
        "hbm": hbm,
        "int32": {"cells": cells, "which": "closure candidate pool",
                  "frac": round(cells / INT32_CELL_LIMIT, 6)},
    }


# ---------------------------------------------------------------------------
# ledger-key projection: what the engines noted

#: where (model, n_pad) live in each of the port's plan keys
#: (``campaign.compile_cache.note`` call sites: torch_wgl.check_encoded
#: (spec.name, n_pad, B, S, C, A, W, O, T, ...); keyshard
#: check_batch_encoded (spec.name, K, W, n_pad, B, S_pad, C, A, ...);
#: streamlin solo (name, 1, F, B, S, C, E, A) / batch (name, K, F, B,
#: S, C, E, A), whose frontier capacity F is the shape axis). The key
#: tuples are the reference's, under the port's labels (the reference's
#: ``jax-wgl`` is index 1, ``jax-wgl-batch`` 3, ``streamlin*`` 2).
_LEDGER_KEY_BUCKET_INDEX = {"torch-wgl": 1, "torch-wgl-batch": 3,
                            "torch-streamlin": 2,
                            "torch-streamlin-batch": 2}


def ledger_key_shape(engine, key):
    """Project one plan-shape key to ``(model, bucket)`` -- the shape
    capplan predicts -- or None for engines the planner does not
    model. ``key`` is the canonicalized key tuple/list (model name
    first)."""
    engine = str(engine)
    idx = _LEDGER_KEY_BUCKET_INDEX.get(engine)
    if idx is None:
        return None
    try:
        if "streamlin" in engine:
            # fold keys lead with the MODEL spec name but the planner
            # quotes one "streamlin" pseudo-model per cell
            return ("streamlin", int(key[idx]))
        return (str(key[0]), int(key[idx]))
    except (IndexError, TypeError, ValueError):
        return None
