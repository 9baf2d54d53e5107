"""Per-region area and class tables (the K4 kernel's plain version).

Counterpart of ``region_counts`` in
``particle_col_image_segmentation_tpu/ops/regionprops.py``.  Tables have
``max_regions + 1`` rows, row 0 being the background segment.
"""

from __future__ import annotations

import torch

__all__ = ["region_counts"]

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def region_counts(seg: torch.Tensor, img: torch.Tensor, max_regions: int):
    """(area [..., R+1], class_id [..., R+1]) int32 from compact ids ``seg``
    and the class image ``img``, over any leading batch axes.

    Ids outside [0, R+1) are dropped.  ``class_id = ⌊Σvalues / max(area, 1)⌋``
    with the value sum saturated to the int32 range — the TPU table kernel's
    contract (``region_counts_mxu``): it equals the JAX scatter path's
    per-region max wherever a region is value-homogeneous (every CCL
    component is) and its sum fits int32, and empty rows hold 0 where the
    scatter path holds INT32_MIN.
    """
    R1 = max_regions + 1
    lead = seg.shape[:-2]
    ids = seg.reshape(-1, seg.shape[-2] * seg.shape[-1]).to(torch.int64)
    vals = img.reshape(ids.shape).to(torch.int64)
    B = ids.shape[0]
    keep = (ids >= 0) & (ids < R1)
    # dropped ids go to one spare bin past the last plane's table
    bins = torch.where(
        keep, ids + R1 * torch.arange(B, device=seg.device)[:, None], B * R1
    ).flatten()
    area = torch.zeros(B * R1 + 1, dtype=torch.int64, device=seg.device)
    area.index_add_(0, bins, torch.ones_like(bins))
    sums = torch.zeros(B * R1 + 1, dtype=torch.int64, device=seg.device)
    sums.index_add_(0, bins, vals.flatten())
    area, sums = area[:-1], sums[:-1].clamp(_I32_MIN, _I32_MAX)
    cls = torch.div(sums, area.clamp(min=1), rounding_mode="floor")
    shape = lead + (R1,)
    return area.to(torch.int32).reshape(shape), cls.to(torch.int32).reshape(shape)
