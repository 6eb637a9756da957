"""Device-mesh parallelism for the checker (the counterpart of
``jepsen_tpu.parallel``): ``jepsen.independent`` splits one multi-key
history into per-key subhistories, and here every key's search runs in
one batched device search, the key axis being the search's batch axis
(``keyshard``), on one card or block-sharded over a 1-D ``DeviceMesh``;
and ONE search can spread over the mesh's ranks (``searchshard``). Both
mesh paths run SPMD over ``torch.distributed``: every rank calls them
with the same arguments and gets the same results."""

from .keyshard import check_batch_encoded, check_batch_histories
from .searchshard import check_encoded_sharded, check_history_sharded

__all__ = ["check_batch_encoded", "check_batch_histories",
           "check_encoded_sharded", "check_history_sharded"]
