"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each a gap that a limit of its own bounds.

- ``map_gap``: the widest gap of a depth map (a served one, or a train
  step's prediction) from the reference's, over the reference map's largest
  value; the worst map counts.
- ``median_gap``: the median pixel's gap of a map from the reference's, over
  the median pixel's magnitude: a train step's prediction.
- ``loss_gap``: a train step's loss against the reference's, relative.
- ``leaf_gaps``: per-leaf norms (a gradient's or a change's), the program's
  norm against the reference's: the gap of the two norms (not the norm of
  their difference) over the larger of the reference leaf's norm and the
  median leaf's; the worst leaf, or the median leaf.
- ``leaf_distances``: per-leaf tensors (the first gradient, the change),
  the norm of their difference over the same: unlike a gap of norms it
  sees a direction (an ascent reads 2); the median leaf, or the worst.
- ``part_distances``: the same over each top-level part of the model (the
  first name of a leaf's path) taken whole: the norm of the part's
  difference over the norm of the reference's part; the worst part.

Leaves whose first reference gradient is under a thousandth of the median
leaf's are left out: they move by round-off alone (a key's bias under
softmax).
"""

from __future__ import annotations

import statistics

import torch

LEAF_FLOOR = 1e-3  # of the median leaf's first gradient norm


def map_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """inf where the shapes differ (a row left out)."""
    if got.shape != want.shape:
        return float("inf")
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def median_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The median pixel's gap over the median pixel's magnitude; inf where
    the shapes differ."""
    if got.shape != want.shape:
        return float("inf")
    got, want = got.double(), want.double()
    return float((got - want).abs().median() / want.abs().median().clamp_min(1e-30))


def loss_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def moving_leaves(ref_grad_norms: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= LEAF_FLOOR * median}


def leaf_gaps(got: dict, want: dict, leaves: set) -> dict:
    """Each leaf's gap. A leaf the program lacks reads 1."""
    median = statistics.median(want[k] for k in leaves)
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], median, 1e-30) for k in leaves}


def leaf_distances(got: dict, want: dict, leaves: set) -> dict:
    """Each leaf's distance, the norm of the difference of the program's
    tensor and the reference's, over the larger of the reference leaf's norm
    and the median leaf's. A leaf the program lacks reads 1."""
    norms = {k: float(want[k].double().norm()) for k in leaves}
    median = statistics.median(norms.values())
    out = {}
    for k in leaves:
        diff = (got[k].double() - want[k].double()).norm() if k in got else norms[k]
        out[k] = float(diff) / max(norms[k], median, 1e-30)
    return out


def part_distances(got: dict, want: dict, leaves: set) -> dict:
    """Each top-level part's distance. A leaf the program lacks counts as
    nought."""
    diff, norm = {}, {}
    for k in leaves:
        part = k.split(".", 1)[0]
        w = want[k].double()
        d = (got[k].double() - w) if k in got else w
        diff[part] = diff.get(part, 0.0) + float(d.pow(2).sum())
        norm[part] = norm.get(part, 0.0) + float(w.pow(2).sum())
    return {p: (diff[p] / max(norm[p], 1e-60)) ** 0.5 for p in diff}


def worst(gaps: dict) -> tuple:
    """(the worst leaf's gap, that leaf)."""
    return max((v, k) for k, v in gaps.items())


def median(gaps: dict) -> float:
    """The median leaf's gap."""
    return statistics.median(gaps.values())
