"""Serializes and deserializes values to/from bytes (reference
jepsen/src/jepsen/codec.clj, 29 LoC; JSON instead of EDN, like the
store; the port's copy of ``jepsen_tpu/codec.py``)."""

from __future__ import annotations

import json


def encode(o) -> bytes:
    """Serialize a value to bytes; None becomes empty
    (codec.clj:9-15)."""
    if o is None:
        return b""
    return json.dumps(o).encode()


def decode(data):
    """Deserialize bytes to a value; empty/None becomes None
    (codec.clj:17-29)."""
    if data is None or len(data) == 0:
        return None
    if isinstance(data, (bytes, bytearray)):
        data = data.decode()
    return json.loads(data)
