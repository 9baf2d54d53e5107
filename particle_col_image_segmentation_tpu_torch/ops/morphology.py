"""Disk morphology, hole filling, boundaries and plateau-aware local maxima.

Counterpart of ``particle_col_image_segmentation_tpu/ops/morphology.py``
(``dilate_disk``, ``erode_disk``, ``open_disk``, ``close_disk``,
``fill_holes``, ``local_maxima``, ``local_maxima_auto``, ``boundary_mask``).

``binary_dilation(mask, disk(r))`` is exactly ``EDT(mask) ≤ r`` for the
capped transform with cap = r, so dilation, and erosion, opening and closing
built on it, ride K9 on a CUDA tensor for every radius.

A pixel is a local maximum iff its equal-value plateau (4- or 8-connected)
has no pixel with a strictly higher neighbour.  The plain version floods
that "bad" status through each plateau by a fixpoint (the JAX XLA loop, step
for step).  On a CUDA tensor the plateaus are K2's components of the value
image, and a component is bad iff any of its pixels has a higher neighbour:
the plateau maxima pair (``ops.maxima_tiles``, ``csrc/maxima.cu``) sets the
component's bit where a pixel has a higher neighbour, and each pixel reads
its root's bit back, with no host sync.  Same fixpoint, same maxima.  The
space axis (``parallel.sharded``) keeps its own route on bands with halo
rows: ``_has_higher`` and ``_marked_components``, the marking by an
idempotent store ``flag[root[seeds]] = True``.

Hole filling is the same pattern on the mask itself: background pixels
4-connected to the image border stay background, every other background
pixel is a hole.  The plain version (``fill_holes_fixpoint``) floods the
border inwards by the JAX fixpoint, step for step, budget and flag
included.  On a CUDA tensor K2 labels the mask's 4-connected equal-value
components, the components holding a border background pixel are marked by
the idempotent store, and every unmarked background pixel is a hole.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.ccl_tiles import ccl_cuda
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_auto
from particle_col_image_segmentation_tpu_torch.ops.maxima_tiles import plateau_maxima_cuda
from particle_col_image_segmentation_tpu_torch.ops.scans import seg_or_scan_bidi
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

__all__ = [
    "dilate_disk",
    "erode_disk",
    "open_disk",
    "close_disk",
    "fill_holes",
    "fill_holes_fixpoint",
    "local_maxima",
    "local_maxima_auto",
    "boundary_mask",
]

_OFFSETS4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_OFFSETS8 = _OFFSETS4 + [(-1, -1), (-1, 1), (1, -1), (1, 1)]


def _as_mask(mask: torch.Tensor) -> torch.Tensor:
    """A contiguous bool or uint8 mask (nonzero = True), as K9 reads it."""
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return mask.contiguous()


def dilate_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """binary_dilation(mask, disk(radius)) of a [..., H, W] mask → bool."""
    return edt_sq_auto(_as_mask(mask), radius) <= radius * radius


def erode_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """binary_erosion with disk(radius), True border (skimage semantics)."""
    return ~dilate_disk(~(mask != 0), radius)


def open_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """binary_opening (erode, then dilate) with disk(radius)."""
    return dilate_disk(erode_disk(mask, radius), radius)


def close_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """binary_closing (dilate, then erode) with disk(radius)."""
    return erode_disk(dilate_disk(mask, radius), radius)


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


def _marked_components(root: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """For K2's labels ``root`` of a [B, H, W] stack: whether each pixel's
    component holds a pixel of ``seeds``."""
    B, H, W = root.shape
    plane_off = (torch.arange(B, device=root.device, dtype=torch.int64) * (H * W))[:, None, None]
    key = root.to(torch.int64) + plane_off  # a component's id across the stack
    flag = torch.zeros(root.numel(), dtype=torch.bool, device=root.device)
    with stage("pcis.sync.mark_index"):
        marked = key[seeds]  # a mask's index: its count read back
    with stage("pcis.sync.mark_store"):
        flag[marked] = True  # idempotent store: any order gives one answer
    return flag[key]


def _local_maxima_ccl(img: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Local maxima of a CUDA uint8/int32 [..., H, W] stack through K2 and
    the plateau maxima pair."""
    H, W = img.shape[-2:]
    planes = img.reshape(-1, H, W).contiguous()
    conn = 8 if connectivity == 2 else 4
    root = ccl_cuda(planes, connectivity=conn)
    return plateau_maxima_cuda(planes, root, conn).reshape(img.shape)


def local_maxima_auto(img: torch.Tensor, connectivity: int = 2, max_iters: int = 256,
                      with_flag: bool = False, max_sweeps: int = 16):
    """K2 and the plateau maxima pair for a CUDA tensor (uint8 or int32
    values; other types raise), the plain fixpoint for a CPU tensor; the
    same maxima.  With ``with_flag`` the kernel path reports every plane
    converged: it is not iterative.  ``max_sweeps`` is the JAX package's TPU
    band-sweep budget, accepted and not read."""
    del max_sweeps
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


def _neighbor_or(x: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """One 4-connected propagation step of x through ``allowed`` pixels."""
    H, W = x.shape[-2:]
    out = x.clone()
    for dy, dx in _OFFSETS4:
        src, dst = _slices(H, W, dy, dx)
        out[dst] |= x[src]
    return out & allowed


def _propagate_fixpoint(seed, allowed, same_row, same_col, max_iters: int):
    """OR-propagate ``seed`` through ``allowed`` by the scan-accelerated
    fixpoint.  Returns (out, converged): False means ``max_iters`` ran out
    with propagation still spreading (the result is NOT the fixpoint)."""
    x = seed & allowed
    changed = True
    i = 0
    while changed and i < max_iters:
        new = _neighbor_or(x, allowed)
        new = seg_or_scan_bidi(new, same_row, axis=-1) & allowed
        new = seg_or_scan_bidi(new, same_col, axis=-2) & allowed
        changed = bool((new != x).any())
        x = new
        i += 1
    return x, torch.tensor(not changed, device=x.device)


def _run_masks(allowed: torch.Tensor):
    """same_prev connectivity masks for runs of ``allowed`` along rows and
    columns."""
    same_row = torch.zeros(allowed.shape, dtype=torch.bool, device=allowed.device)
    same_row[..., :, 1:] = allowed[..., :, 1:] & allowed[..., :, :-1]
    same_col = torch.zeros(allowed.shape, dtype=torch.bool, device=allowed.device)
    same_col[..., 1:, :] = allowed[..., 1:, :] & allowed[..., :-1, :]
    return same_row, same_col


def _border(shape, device) -> torch.Tensor:
    border = torch.zeros(shape, dtype=torch.bool, device=device)
    border[..., 0, :] = border[..., -1, :] = True
    border[..., :, 0] = border[..., :, -1] = True
    return border


def fill_holes_fixpoint(mask: torch.Tensor, max_iters: int = 256, with_flag: bool = False):
    """scipy.ndimage.binary_fill_holes parity (4-connected background flood),
    the plain fixpoint on any device.  ``with_flag=True`` appends a 0-d
    ``converged`` bool for the whole batch: False means the flood budget ran
    out and unreached corridors were WRONGLY filled, as in the JAX package."""
    bg = mask == 0
    same_row, same_col = _run_masks(bg)
    reach, conv = _propagate_fixpoint(_border(bg.shape, bg.device) & bg, bg, same_row,
                                      same_col, max_iters)
    return (~reach, conv) if with_flag else ~reach


def _fill_holes_ccl(mask: torch.Tensor) -> torch.Tensor:
    """fill_holes of a CUDA [..., H, W] mask through K2."""
    H, W = mask.shape[-2:]
    planes = (mask != 0).to(torch.uint8).reshape(-1, H, W)
    bg = planes == 0
    open_bg = bg & _marked_components(ccl_cuda(planes, connectivity=4),
                                      bg & _border(bg.shape, bg.device))
    return ~open_bg.reshape(mask.shape)


def fill_holes(mask: torch.Tensor, max_iters: int = 256, with_flag: bool = False):
    """scipy.ndimage.binary_fill_holes parity: background 4-connected to the
    border stays background, every other background pixel is filled.  K2
    for a CUDA tensor (exact, every plane converged), the plain fixpoint
    (``fill_holes_fixpoint``) for a CPU tensor.  ``with_flag=True`` appends
    a 0-d ``converged`` bool, False only where the plain flood ran out of
    ``max_iters`` and wrongly filled unreached corridors."""
    if use_kernel(mask):
        out = _fill_holes_ccl(mask)
        return (out, torch.tensor(True, device=mask.device)) if with_flag else out
    return fill_holes_fixpoint(mask, max_iters, with_flag)


def boundary_mask(mask: torch.Tensor) -> torch.Tensor:
    """Mask pixels with a 4-neighbour outside the mask or on the image edge
    (the bwboundaries pixel set)."""
    m = mask != 0
    H, W = m.shape[-2:]
    interior = m.clone()
    for dy, dx in _OFFSETS4:
        src, dst = _slices(H, W, dy, dx)
        shifted = torch.zeros_like(m)
        shifted[dst] = m[src]
        interior &= shifted
    return m & ~interior
