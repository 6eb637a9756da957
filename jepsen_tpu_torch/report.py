"""Report helper: redirect printed output to a file (reference
jepsen/src/jepsen/report.clj, 16 LoC; the port's copy of
``jepsen_tpu/report.py``)."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def to(filename):
    """Binds stdout to a file for the duration of the block
    (report.clj `to`)."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as f:
        with contextlib.redirect_stdout(f):
            yield
    print(f"Report written to {filename}")
