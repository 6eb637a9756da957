"""The output-path helper of the performance plots (reference
jepsen/src/jepsen/checker/perf.clj; ``jepsen_tpu/checker/perf.py``).

Only ``_out_path`` is ported so far: the failure render
(``linear_report``) writes ``linear.png`` through it. The latency and
rate plots themselves wait for the host harness (ROADMAP.md A.11(b)).
"""

from __future__ import annotations


def _out_path(test, opts, filename):
    """Resolve the output path BEFORE building any figure, so a missing
    store directory can't leak matplotlib figures."""
    from .. import store
    return store.make_path(test, (opts or {}).get("subdirectory"), filename)
