"""shapelint: the search-plan shape check of ``jepsen_tpu/analysis/
jaxlint.py`` (JX007), the one part of jaxlint the plan report of record
needs. The rest of jaxlint traces JAX programs and has no counterpart
here.

  JX007 warning  sub-search shape proliferation: a SearchPlan whose
                 segments pad to more than MAX_PLAN_SHAPES distinct
                 op-count buckets defeats reuse across its searches

The buckets are the port's search padding: ``util.bucket`` over the
op-count floor ``util.DEFAULT_N_FLOOR`` (the JAX package reads a
settable floor from its campaign compile cache; the port's floor is
that cache's default, fixed until the campaign layer is ported).
"""

from __future__ import annotations

from ..util import DEFAULT_N_FLOOR, bucket
from .diagnostics import WARNING, diag

__all__ = ["lint_searchplan_shapes", "MAX_PLAN_SHAPES"]

#: the most distinct op-count buckets a plan's sub-searches may pad to
#: before JX007 warns
MAX_PLAN_SHAPES = 4


def lint_searchplan_shapes(op_counts, max_shapes=MAX_PLAN_SHAPES,
                           where="search-plan"):
    """JX007: how many distinct padded op-count buckets a SearchPlan's
    sub-searches land in. Buckets mirror the engines' padding, so the
    count is the number of search shapes the plan will demand along the
    n axis."""
    buckets = sorted({bucket(int(n), DEFAULT_N_FLOOR)
                      for n in op_counts if int(n) > 0})
    if len(buckets) <= max_shapes:
        return []
    shown = str(buckets[:8]) + ("..." if len(buckets) > 8 else "")
    # the message and hint are the JAX package's, word for word: the
    # plan report of record is compared across the two packages
    return [diag(
        "JX007", WARNING,
        f"{len(op_counts)} sub-search(es) pad to {len(buckets)} "
        f"distinct op-count buckets {shown}: more than {max_shapes} "
        "shapes defeats compile reuse",
        where,
        "raise the shared op-count bucket floor "
        "(campaign.compile_cache.set_n_floor / bucket_floor) so "
        "segments land in one padded shape")]
