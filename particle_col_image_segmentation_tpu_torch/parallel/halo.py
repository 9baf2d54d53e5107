"""Halo rows along the space axis: the rows a band needs from its neighbours.

Counterpart of ``particle_col_image_segmentation_tpu/parallel/halo.py``.  A
plane's rows are split into ``n`` contiguous bands of ``h`` rows, one a mesh
position along "space", each band a tensor on its position's device.  Where
the JAX package ``ppermute``s boundary rows inside ``shard_map``, the caller
here holds every band and copies a neighbour's rows to the band's device
(``non_blocking``; a same-device copy where the mesh repeats a device).
Halos taller than a band gather from several bands (the JAX package's
multi-hop exchange).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["exchange_rows", "pad_with_halo"]


def _check_bands(bands: Sequence[torch.Tensor]) -> Tuple[int, int]:
    if not bands:
        raise ValueError("no bands")
    shape = bands[0].shape
    if len(shape) < 2 or any(b.shape != shape for b in bands):
        raise ValueError(f"bands must share one [..., h, W] shape, got {[tuple(b.shape) for b in bands]}")
    return len(bands), shape[-2]


def _plane_rows(bands, lo: int, hi: int, like: torch.Tensor, fill) -> torch.Tensor:
    """Plane rows [lo, hi) on ``like``'s device; ``fill`` outside the plane."""
    n, h = len(bands), like.shape[-2]
    out = torch.full(like.shape[:-2] + (hi - lo, like.shape[-1]), fill,
                     dtype=like.dtype, device=like.device)
    for k in range(max(lo, 0) // h, min(hi, n * h) // h + 1):
        a, b = max(lo, k * h), min(hi, (k + 1) * h, n * h)
        if a < b:
            out[..., a - lo:b - lo, :].copy_(bands[k][..., a - k * h:b - k * h, :],
                                            non_blocking=True)
    return out


def exchange_rows(bands: Sequence[torch.Tensor], halo: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """For each band [..., h, W]: (top, bottom), the ``halo`` plane rows
    directly above and below it, on the band's device; zeros where the plane
    has no such rows (its true edges)."""
    n, h = _check_bands(bands)
    return [
        (_plane_rows(bands, j * h - halo, j * h, x, 0),
         _plane_rows(bands, (j + 1) * h, (j + 1) * h + halo, x, 0))
        for j, x in enumerate(bands)
    ]


def pad_with_halo(
    bands: Sequence[torch.Tensor],
    halo: int,
    edge_mode: str = "symmetric",
    fill=0,
) -> List[torch.Tensor]:
    """[..., h, W] bands → [..., h + 2·halo, W]: neighbour rows where the
    plane has them, and at its true edges ``edge_mode``'s rows: 'symmetric'
    (scipy 'reflect' of the band's own rows; needs halo ≤ h) or 'constant'
    (``fill``; any halo, several bands deep)."""
    if edge_mode not in ("symmetric", "constant"):
        # silently zero-filling for a typo'd numpy-style mode ("reflect",
        # "mirror") would corrupt edge rows with no error
        raise ValueError(f"edge_mode must be 'symmetric' or 'constant', got {edge_mode!r}")
    n, h = _check_bands(bands)
    if halo == 0:
        return list(bands)
    if edge_mode == "symmetric" and halo > h:
        raise ValueError(
            f"a 'symmetric' halo reflects the band's own rows: halo {halo} > band height {h}"
        )
    out = []
    for j, x in enumerate(bands):
        top = _plane_rows(bands, j * h - halo, j * h, x, fill)
        bottom = _plane_rows(bands, (j + 1) * h, (j + 1) * h + halo, x, fill)
        if edge_mode == "symmetric":
            if j == 0:
                top = torch.flip(x[..., :halo, :], (-2,))
            if j == n - 1:
                bottom = torch.flip(x[..., h - halo:, :], (-2,))
        out.append(torch.cat([top, x, bottom], dim=-2))
    return out
