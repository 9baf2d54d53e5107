"""Disk dilation and plateau-aware local maxima.

Counterpart of ``dilate_disk``, ``local_maxima`` and ``local_maxima_auto``
in ``particle_col_image_segmentation_tpu/ops/morphology.py``.

``binary_dilation(mask, disk(r))`` is exactly ``EDT(mask) ≤ r`` for the
capped transform with cap = r, so dilation rides K9 on a CUDA tensor for
every radius.

A pixel is a local maximum iff its equal-value plateau (4- or 8-connected)
has no pixel with a strictly higher neighbour.  The plain version floods
that "bad" status through each plateau by a fixpoint (the JAX XLA loop, step
for step).  On a CUDA tensor the plateaus are K2's components of the value
image, and a component is bad iff any of its pixels has a higher neighbour:
``flag[root[has_higher]] = True`` marks it with an idempotent store (no
atomics and no reduce, whose serialisation on the plane's largest plateau
would dominate), and each pixel reads its root's mark back.  Same fixpoint,
same maxima.  The module's other operators (erosion, opening, closing, hole
filling, boundaries) are not ported yet.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.ccl_tiles import ccl_cuda
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_auto
from particle_col_image_segmentation_tpu_torch.ops.scans import seg_or_scan_bidi

__all__ = ["dilate_disk", "local_maxima", "local_maxima_auto"]

_OFFSETS4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_OFFSETS8 = _OFFSETS4 + [(-1, -1), (-1, 1), (1, -1), (1, 1)]


def dilate_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """binary_dilation(mask, disk(radius)) of a [..., H, W] mask → bool."""
    return edt_sq_auto(mask, radius) <= radius * radius


def _slices(H: int, W: int, dy: int, dx: int):
    """(source, destination) windows of the shift by (dy, dx)."""
    src = (..., slice(max(0, -dy), H - max(0, dy)), slice(max(0, -dx), W - max(0, dx)))
    dst = (..., slice(max(0, dy), H - max(0, -dy)), slice(max(0, dx), W - max(0, -dx)))
    return src, dst


def _has_higher(img: torch.Tensor, offsets) -> torch.Tensor:
    """Pixels with a strictly higher neighbour at one of ``offsets``."""
    H, W = img.shape[-2:]
    out = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    for dy, dx in offsets:
        src, dst = _slices(H, W, dy, dx)
        out[dst] |= img[src] > img[dst]
    return out


def local_maxima(img: torch.Tensor, connectivity: int = 2, max_iters: int = 256,
                 with_flag: bool = False):
    """skimage.morphology.local_maxima parity (plateau-aware, borders
    allowed), the plain fixpoint.  ``with_flag=True`` appends a per-plane
    ``converged`` bool (False: the plateau flood budget ran out)."""
    H, W = img.shape[-2:]
    offsets = _OFFSETS8 if connectivity == 2 else _OFFSETS4
    bad = _has_higher(img, offsets)
    eq_masks = []
    for dy, dx in offsets:
        src, dst = _slices(H, W, dy, dx)
        eq = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        eq[dst] = img[src] == img[dst]
        eq_masks.append(eq)
    same_row = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    same_row[..., :, 1:] = img[..., :, 1:] == img[..., :, :-1]
    same_col = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    same_col[..., 1:, :] = img[..., 1:, :] == img[..., :-1, :]

    changed = torch.ones(img.shape[:-2], dtype=torch.bool, device=img.device)
    i = 0
    while i < max_iters and bool(changed.any()):
        new = bad.clone()
        for (dy, dx), eq in zip(offsets, eq_masks):
            src, dst = _slices(H, W, dy, dx)
            shifted = torch.zeros_like(bad)
            shifted[dst] = bad[src]
            new |= shifted & eq
        new = new | seg_or_scan_bidi(new, same_row, axis=-1)
        new = new | seg_or_scan_bidi(new, same_col, axis=-2)
        changed = (new != bad).flatten(-2).any(-1)
        bad = new
        i += 1
    return (~bad, ~changed) if with_flag else ~bad


def _local_maxima_ccl(img: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Local maxima of a CUDA uint8/int32 [..., H, W] stack through K2."""
    H, W = img.shape[-2:]
    planes = img.reshape(-1, H, W).contiguous()
    root = ccl_cuda(planes, connectivity=8 if connectivity == 2 else 4)
    higher = _has_higher(planes, _OFFSETS8 if connectivity == 2 else _OFFSETS4)
    plane_off = (torch.arange(planes.shape[0], device=img.device, dtype=torch.int64)
                 * (H * W))[:, None, None]
    key = root.to(torch.int64) + plane_off  # a plateau's id across the stack
    flag = torch.zeros(planes.numel(), dtype=torch.bool, device=img.device)
    flag[key[higher]] = True  # idempotent store: any order gives one answer
    return (~flag[key]).reshape(img.shape)


def local_maxima_auto(img: torch.Tensor, connectivity: int = 2, max_iters: int = 256,
                      with_flag: bool = False):
    """K2 for a CUDA tensor (uint8 or int32 values; other types raise), the
    plain fixpoint for a CPU tensor; the same maxima.  With ``with_flag``
    the kernel path reports every plane converged: it is not iterative."""
    if use_kernel(img):
        if img.dtype not in (torch.uint8, torch.int32):
            raise ValueError(
                f"local_maxima_auto: the CUDA path takes uint8 or int32 values, got {img.dtype}"
            )
        out = _local_maxima_ccl(img, connectivity)
        if with_flag:
            return out, torch.ones(img.shape[:-2], dtype=torch.bool, device=img.device)
        return out
    return local_maxima(img, connectivity, max_iters, with_flag)
