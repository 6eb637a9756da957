"""Sweep matrices -> test cells (the port's copy of
``jepsen_tpu/campaign/plan.py``, host-only).

A campaign plan is a declarative matrix::

    {"base": {"time-limit": 5},                 # shared cell params
     "axes": {"workload": ["register", "bank"],
              "concurrency": [2, 4],
              "seed": [0, 1, 2]}}

``expand`` takes the cartesian product of the axes (in sorted axis
order, so cell order is deterministic) and merges each combination
over ``base`` into a *cell*: ``{"id": "concurrency=2,seed=0,"
"workload=register", "params": {...}}``. Cell ids are the campaign's
unit of identity -- the journal keys resume on them, the report groups
flakes by them -- so they are derived purely from the axis values,
never from wall clock or ordering.

Validation is the planlint PL012 pass (analysis/planlint.py):
empty matrices, duplicate cell ids, seed collisions, and per-cell
robustness-knob inconsistencies (the PL011 rules applied per cell) all
surface before any cell runs.
"""

from __future__ import annotations

import itertools

__all__ = ["CampaignPlanError", "normalize", "cell_id", "group_id",
           "expand", "lint", "validate"]


class CampaignPlanError(ValueError):
    """A campaign matrix failed PL012 validation."""

    def __init__(self, diags):
        from ..analysis import render_text
        self.diagnostics = diags
        super().__init__(render_text(diags,
                                     title="campaign plan invalid:"))


def normalize(matrix):
    """Canonical {"base": {...}, "axes": {name: [values...]}} form.

    Accepts the canonical form, or a plain ``{name: values}`` dict
    (every list-valued entry becomes an axis, scalars go to base), and
    the ``"seeds": N`` shorthand for ``axes["seed"] = [0..N-1]``."""
    matrix = dict(matrix or {})
    base = dict(matrix.pop("base", None) or {})
    axes = matrix.pop("axes", None)
    if axes is None:
        axes = {}
        for k, v in matrix.items():
            if k == "seeds":
                continue
            if isinstance(v, (list, tuple)):
                axes[k] = list(v)
            else:
                base[k] = v
    else:
        axes = {k: list(v) for k, v in dict(axes).items()}
    seeds = matrix.get("seeds")
    if seeds and "seed" not in axes:
        axes["seed"] = list(range(int(seeds)))
    return {"base": base, "axes": axes}


def _fmt(v):
    """Compact, filesystem/journal-safe value rendering for cell ids."""
    s = str(v)
    return "".join(c if c.isalnum() or c in "._+-" else "_" for c in s)


def cell_id(params, axis_names):
    """Deterministic id from the cell's axis values alone (base params
    are shared, so they carry no identity)."""
    return ",".join(f"{a}={_fmt(params[a])}" for a in sorted(axis_names)
                    if a in params)


def group_id(params, axis_names):
    """The cell id with the seed axis stripped: cells sharing a group
    differ only by seed, which is exactly the population flake
    detection compares (report.py)."""
    return ",".join(f"{a}={_fmt(params[a])}" for a in sorted(axis_names)
                    if a in params and a != "seed") or "<all>"


def expand(matrix):
    """Expand a matrix into an ordered list of cells:
    ``[{"id", "group", "params"}, ...]``. Never raises on semantic
    problems -- run ``lint``/``validate`` for those -- but the result
    is [] for an empty matrix."""
    norm = normalize(matrix)
    axes = norm["axes"]
    names = sorted(axes)
    if not names or any(not axes[a] for a in names):
        return []
    cells = []
    for combo in itertools.product(*(axes[a] for a in names)):
        params = dict(norm["base"])
        params.update(dict(zip(names, combo)))
        cells.append({"id": cell_id(params, names),
                      "group": group_id(params, names),
                      "params": params})
    return cells


def lint(matrix):
    """PL012 diagnostics for a matrix (see analysis/planlint.py)."""
    from ..analysis import planlint
    norm = normalize(matrix)
    return planlint.lint_campaign(norm, expand(norm))


def validate(matrix):
    """Expand + lint; raise CampaignPlanError on PL012 errors, return
    (cells, diagnostics) otherwise."""
    from ..analysis import errors
    cells = expand(matrix)
    diags = lint(matrix)
    if errors(diags):
        raise CampaignPlanError(diags)
    return cells, diags
