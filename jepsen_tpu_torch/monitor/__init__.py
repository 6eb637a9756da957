"""Streaming monitors (the PyTorch port of ``jepsen_tpu.monitor``): online
checking over a run's live op stream, with early abort on violation.

* ``core.Monitor`` consumes the interpreter's op-sink fan-out and, every
  ``chunk`` completions, re-checks the prefix through one engine
  (``engine.check_prefix``: ``jax-wgl``, the device search with the
  rollout kernel, by default); ``StreamCheck`` (``wgl_stream.py``)
  keeps a linearizability frontier on the card across chunks instead
  (engine ``streamlin``).
* ``txn.TxnMonitor`` does the same for the txn family over ``TxnCheck``,
  which keeps a txn dependency closure on the card.
* The first violation flips the run's ``robust.ChainedLatch`` (reason
  ``monitor-violation``); ``install`` and ``finalize`` are the run
  loop's hooks (``core.run``).
"""

from __future__ import annotations

from .core import (DEFAULT_CHUNK, Monitor, config, finalize,  # noqa: F401
                   find_linearizable, install)
from .stream import StreamEncoder  # noqa: F401
from .txn import TxnCheck, TxnMonitor  # noqa: F401
from .wgl_stream import StreamCheck  # noqa: F401

__all__ = ["Monitor", "StreamCheck", "StreamEncoder", "TxnCheck",
           "TxnMonitor", "install", "finalize", "config",
           "find_linearizable", "DEFAULT_CHUNK"]
