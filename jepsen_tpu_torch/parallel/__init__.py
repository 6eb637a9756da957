"""Key-batched linearizability checking (the counterpart of
``jepsen_tpu.parallel``): ``jepsen.independent`` splits one multi-key
history into per-key subhistories, and here every key's search runs in
one batched device search, the key axis being the search's batch axis.
The mesh batch and the multi-device single search
(``jepsen_tpu.parallel.searchshard``) are not ported yet (ROADMAP.md
queue A)."""

from .keyshard import check_batch_encoded, check_batch_histories

__all__ = ["check_batch_encoded", "check_batch_histories"]
