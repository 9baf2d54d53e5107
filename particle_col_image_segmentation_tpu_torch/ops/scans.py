"""Segmented scans along one axis — the plain CCL's propagation step and the
plain local maxima's plateau flood.

Counterpart of ``particle_col_image_segmentation_tpu/ops/scans.py``
(``seg_min_scan``, ``seg_min_scan_bidi``, ``seg_or_scan_bidi``,
``_flip_same``).  Where JAX runs an
associative scan over (value, boundary) pairs, this uses one ``cummin`` over
int64 keys: ``key = value - segment_number·2³²``.  Segment numbers grow along
the axis, so every key of an earlier segment exceeds every key of the
current one, and the running minimum never reaches back past a segment
start.  Exact for any int32 values.
"""

from __future__ import annotations

import torch

__all__ = ["seg_min_scan", "seg_min_scan_bidi", "seg_or_scan_bidi"]


def seg_min_scan(vals: torch.Tensor, boundary: torch.Tensor, axis: int) -> torch.Tensor:
    """Running min within segments along ``axis``.

    ``boundary[..., i]`` True means element i starts a new segment (is not
    connected to element i-1 along the axis).
    """
    shift = torch.cumsum(boundary.to(torch.int64), dim=axis) << 32
    keys = vals.to(torch.int64) - shift
    return (torch.cummin(keys, dim=axis).values + shift).to(vals.dtype)


def seg_min_scan_bidi(vals: torch.Tensor, same_prev: torch.Tensor, axis: int) -> torch.Tensor:
    """Min over each element's whole segment (forward + backward scans).

    ``same_prev[..., i]`` True when element i is connected to element i-1
    along ``axis`` (first element must be False).
    """
    fwd = seg_min_scan(vals, ~same_prev, axis)
    rev = torch.flip(
        seg_min_scan(torch.flip(vals, (axis,)), ~_flip_same(same_prev, axis), axis),
        (axis,),
    )
    return torch.minimum(fwd, rev)


def seg_or_scan_bidi(vals: torch.Tensor, same_prev: torch.Tensor, axis: int) -> torch.Tensor:
    """OR of a bool ``vals`` over each element's whole segment: a segment
    holds a True exactly when the min of ``~vals`` over it is 0."""
    return seg_min_scan_bidi((~vals).to(torch.int32), same_prev, axis) == 0


def _flip_same(same_prev: torch.Tensor, axis: int) -> torch.Tensor:
    """same_prev of the flipped array: flip, then shift by one (the first
    element of the flipped order has no previous, so it starts a segment)."""
    rolled = torch.roll(torch.flip(same_prev, (axis,)), 1, axis)
    rolled.select(axis, 0).fill_(False)
    return rolled
