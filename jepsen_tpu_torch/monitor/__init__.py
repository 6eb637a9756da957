"""Streaming checks (the PyTorch port of ``jepsen_tpu.monitor``'s
synchronous cores): ``StreamCheck`` keeps a linearizability frontier on
the card across chunks (``wgl_stream.py``), ``TxnCheck`` keeps a txn
dependency closure there (``txn.py``), and ``engine`` dispatches a
prefix check to one engine. The monitor thread, its latch and the
harness wiring (``Monitor``, ``TxnMonitor``, ``install``) come with the
host harness (ROADMAP.md queue A.11)."""

from __future__ import annotations

from .stream import StreamEncoder  # noqa: F401
from .txn import TxnCheck  # noqa: F401
from .wgl_stream import StreamCheck  # noqa: F401

__all__ = ["StreamCheck", "StreamEncoder", "TxnCheck"]
