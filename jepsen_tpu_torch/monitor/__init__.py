"""Streaming checks (the PyTorch port of ``jepsen_tpu.monitor``'s
synchronous cores): ``StreamCheck`` keeps a linearizability frontier on
the card across chunks (``wgl_stream.py``), ``TxnCheck`` keeps a txn
dependency closure there (``txn.py``), and ``engine`` dispatches a
prefix check to one engine. ``config``, ``install`` and ``finalize``
(``core.py``) are the run loop's hooks and exist with monitoring off:
``install`` returns None then. The monitor thread, its latch and
``TxnMonitor`` are still ROADMAP.md A.11(c): with ``test["monitor"]``
set, ``install`` raises ``NotImplementedError``."""

from __future__ import annotations

from .core import (DEFAULT_CHUNK, config, finalize,  # noqa: F401
                   find_linearizable, install)
from .stream import StreamEncoder  # noqa: F401
from .txn import TxnCheck  # noqa: F401
from .wgl_stream import StreamCheck  # noqa: F401

__all__ = ["StreamCheck", "StreamEncoder", "TxnCheck", "install",
           "finalize", "config", "find_linearizable", "DEFAULT_CHUNK"]
