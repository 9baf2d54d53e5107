"""Disk dilation (counterpart of ``dilate_disk`` in
``particle_col_image_segmentation_tpu/ops/morphology.py``).

``binary_dilation(mask, disk(r))`` is exactly ``EDT(mask) ≤ r`` for the
capped transform with cap = r, so dilation rides K9 on a CUDA tensor for
every radius.  The module's other operators (erosion, opening, closing, hole
filling, local maxima, boundaries) serve the refine pipeline and are not
ported yet.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_auto

__all__ = ["dilate_disk"]


def dilate_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """binary_dilation(mask, disk(radius)) of a [..., H, W] mask → bool."""
    return edt_sq_auto(mask, radius) <= radius * radius
