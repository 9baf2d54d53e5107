"""Nearest-neighbour distances between point sets, in tensor code.

Counterpart of ``particle_col_image_segmentation_tpu/ops/pairwise.py``
(``min_dist_to_set``, ``nearest_neighbor_dists``; the JAX package has no
kernel here).  Distances are direct coordinate differences, Σ(aᵢ − bᵢ)² in
float32, blocked over the second set with a running minimum so the full
matrix is never held.  Deliberately not ``torch.cdist``: above 25 rows it
switches to the ‖a‖² + ‖b‖² − 2abᵀ matrix product, which cancels
catastrophically for nearby points with coordinates near 2000 (terms of
~|a||b| round at ~0.5 px², swamping a 1 px distance).

Each d² is rounded as XLA's CPU code rounds the JAX package's
``jnp.sum(diff * diff, axis=-1)``: the first coordinate's square rounded
alone, the second's fused with it, ``fma(d₁, d₁, fl(d₀·d₀))``
(``ops.rounding.fma_f32``), and the root is the correctly rounded
``ops.edt.sqrt_f32``.  So the distances equal the JAX package's bit for bit
on every device, a NaN row gives NaN and a set with no valid row +inf.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch.ops.edt import sqrt_f32
from particle_col_image_segmentation_tpu_torch.ops.rounding import fma_f32

__all__ = ["min_dist_to_set", "nearest_neighbor_dists"]


def _min_d2(a: torch.Tensor, b: torch.Tensor, keep, block: int) -> torch.Tensor:
    """min over the rows j of ``b`` [M, 2] where ``keep(j0, j1)`` ([N, j1-j0]
    bool) holds of the squared distance to each row of ``a`` [N, 2]."""
    out = torch.full((a.shape[0],), float("inf"), dtype=torch.float32, device=a.device)
    for j0 in range(0, b.shape[0], block):
        bb = b[j0:j0 + block]
        diff = a[:, None, :] - bb[None, :, :]
        d0, d1 = diff.unbind(-1)
        d2 = fma_f32(d1, d1, d0 * d0)
        d2 = torch.where(keep(j0, j0 + bb.shape[0]), d2, float("inf"))
        out = torch.minimum(out, d2.amin(dim=1))
    return out


def min_dist_to_set(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
                    block: int = 1024) -> torch.Tensor:
    """For each row of ``a`` [N, 2], the least Euclidean distance to a valid
    row of ``b`` [M, 2] (float32); +inf where ``b`` has no valid row."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    valid = b_valid.to(torch.bool)
    d2 = _min_d2(a, b, lambda j0, j1: valid[None, j0:j1], block)
    return sqrt_f32(torch.clamp(d2, min=0.0))


def nearest_neighbor_dists(pts: torch.Tensor, valid: torch.Tensor,
                           block: int = 1024) -> torch.Tensor:
    """Within-set nearest-neighbour distance of every point of ``pts``
    [N, 2] (self excluded; invalid points are never neighbours)."""
    pts = pts.to(torch.float32)
    valid = valid.to(torch.bool)
    own = torch.arange(pts.shape[0], device=pts.device)

    def keep(j0, j1):
        idx = torch.arange(j0, j1, device=pts.device)
        return valid[None, j0:j1] & (idx[None, :] != own[:, None])

    d2 = _min_d2(pts, pts, keep, block)
    return sqrt_f32(torch.clamp(d2, min=0.0))
