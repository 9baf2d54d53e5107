"""Connected-component labelling and label compaction (plain versions and
their dispatch).

Counterpart of ``particle_col_image_segmentation_tpu/ops/ccl.py``.  The
plain ``connected_components`` is the same fixpoint as the JAX one, step for
step, so labels agree even when ``max_iters`` runs out:

  label₀ = per-plane linear pixel index
  repeat until no plane changes (or max_iters rounds):
    1. min over same-valued neighbours (8 or 4) and self
    2. row + column segmented min scans (whole runs at once)
    3. every 4th round, pointer jumping  lab ← min(lab, lab[lab])

At the fixpoint every pixel holds the minimum linear index of its component,
and compacting those roots in raster order gives skimage's label ids.  The
``*_auto`` functions launch the CUDA kernels K2/K3 on a Hopper card
(``ops/ccl_tiles.py``) and run these plain versions on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.ccl_tiles import ccl_cuda, compact_labels_cuda
from particle_col_image_segmentation_tpu_torch.ops.scans import seg_min_scan_bidi

__all__ = [
    "connected_components",
    "compact_labels",
    "connected_components_auto",
    "compact_labels_auto",
    "label_image",
]

_INF = torch.iinfo(torch.int32).max
_OFFSETS8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
_OFFSETS4 = ((-1, 0), (0, -1), (0, 1), (1, 0))


def _linear_index(shape, device) -> torch.Tensor:
    H, W = shape[-2:]
    lin = torch.arange(H * W, dtype=torch.int32, device=device).reshape(H, W)
    return lin.expand(shape)


def _neighbor_min(lab, img, connectivity: int, num_classes: int):
    """Min label over same-valued neighbours (and self).  Pixels whose value
    is outside [0, num_classes) — the unique background sentinels — take no
    neighbours and keep their own label."""
    H, W = lab.shape[-2:]
    labp = F.pad(lab, (1, 1, 1, 1), value=_INF)
    imgp = F.pad(img, (1, 1, 1, 1), value=-1)  # never equal to a valid value
    takes = (img >= 0) & (img < num_classes)
    out = lab
    for dy, dx in _OFFSETS8 if connectivity == 8 else _OFFSETS4:
        nl = labp[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        nv = imgp[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        out = torch.where(takes & (nv == img), torch.minimum(out, nl), out)
    return out


def _pointer_jump(lab):
    flat = lab.flatten(-2)
    idx = flat.clamp(0, flat.shape[-1] - 1).to(torch.int64)
    return torch.minimum(flat, torch.gather(flat, -1, idx)).reshape(lab.shape)


def connected_components(
    img: torch.Tensor,
    background: Optional[int] = None,
    connectivity: int = 8,
    max_iters: int = 64,
    num_classes: int = 8,
    with_flag: bool = False,
):
    """Label components of equal-valued pixels (plain fixpoint).

    Args:
      img: [..., H, W] integer class image with values in [0, num_classes).
      background: optional scalar — pixels with this value get label -1.
        None labels every pixel.
      connectivity: 8 or 4.
      max_iters: bound on the fixpoint rounds.
      num_classes: exclusive upper bound on linking pixel values.
      with_flag: also return a per-plane bool ``converged`` ([...] batch
        shape); False means ``max_iters`` ran out with labels still changing
        and the labels are NOT a valid CCL.

    Returns:
      [..., H, W] int32; each foreground pixel holds the minimum per-plane
      linear index of its component; background pixels hold -1.
    """
    H, W = img.shape[-2:]
    img = img.to(torch.int32)
    lin = _linear_index(img.shape, img.device)
    if background is not None:
        fg = img != background
        # unique negative value per background pixel prevents bg-bg merging
        img = torch.where(fg, img, -2 - lin)
    else:
        fg = torch.ones(img.shape, dtype=torch.bool, device=img.device)

    same_row = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    same_row[..., :, 1:] = img[..., :, 1:] == img[..., :, :-1]
    same_col = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    same_col[..., 1:, :] = img[..., 1:, :] == img[..., :-1, :]

    lab = lin.clone()
    changed = torch.ones(img.shape[:-2], dtype=torch.bool, device=img.device)
    i = 0
    while i < max_iters and bool(changed.any()):
        new = _neighbor_min(lab, img, connectivity, num_classes)
        new = seg_min_scan_bidi(new, same_row, axis=-1)
        new = seg_min_scan_bidi(new, same_col, axis=-2)
        # pointer jumping only speeds the fixpoint up; every 4th round, as
        # in the JAX loop, so partial results agree round for round
        if i % 4 == 3:
            new = _pointer_jump(new)
        changed = (new != lab).flatten(-2).any(-1)
        lab = new
        i += 1
    out = torch.where(fg, lab, -1)
    if with_flag:
        return out, ~changed
    return out


def compact_labels(raw: torch.Tensor, max_regions: int):
    """Compact root labels to skimage-style ids (plain version).

    A component's label is the linear index of its root (first) pixel, so its
    compact id is the number of roots at or before the root: one prefix sum
    over the root indicator plus one gather.

    Args:
      raw: [..., H, W] output of connected_components (batched over any
        leading axes).
      max_regions: capacity of the caller's tables (kept for API parity;
        ``num`` is always the true count, which may exceed it).

    Returns:
      seg: [..., H, W] int32 — 0 for background (-1), 1..N in raster order of
        each component's first pixel.
      num: [...] int32 true number of components.
    """
    del max_regions
    H, W = raw.shape[-2:]
    flat = raw.flatten(-2)
    lin = torch.arange(H * W, dtype=flat.dtype, device=raw.device)
    fg = flat >= 0
    is_root = (flat == lin) & fg
    prefix = torch.cumsum(is_root.to(torch.int32), dim=-1, dtype=torch.int32)
    num = prefix[..., -1]
    ranks = torch.gather(prefix, -1, flat.clamp(0, H * W - 1).to(torch.int64))
    seg = torch.where(fg, ranks, 0)
    return seg.reshape(raw.shape), num


def compact_labels_auto(
    raw: torch.Tensor, max_regions: int, val: Optional[torch.Tensor] = None,
    with_flag: bool = False, max_sweeps: int = 16,
):
    """K3 for a CUDA tensor, the plain compaction for a CPU tensor.

    ``with_flag=True`` appends a per-plane ``converged`` bool; both paths are
    one pass and always converged.  ``val`` and ``max_sweeps`` are the JAX
    package's knobs of its TPU band sweeps, accepted and not read."""
    del val, max_sweeps
    if use_kernel(raw):
        seg, num = compact_labels_cuda(raw, max_regions)
    else:
        seg, num = compact_labels(raw, max_regions)
    if with_flag:
        return seg, num, torch.ones(raw.shape[:-2], dtype=torch.bool, device=raw.device)
    return seg, num


def connected_components_auto(
    img: torch.Tensor,
    background: Optional[int] = None,
    connectivity: int = 8,
    num_classes: int = 8,
    with_flag: bool = False,
    max_iters: int = 64,
    max_sweeps: int = 16,
):
    """K2 for a CUDA tensor, the plain fixpoint for a CPU tensor; identical
    labels.  ``with_flag=True`` appends a per-plane ``converged`` bool
    (always True for the kernel, which is not iterative).  ``max_sweeps``
    is the JAX package's TPU band-sweep budget, accepted and not read."""
    del max_sweeps
    if use_kernel(img):
        return ccl_cuda(
            img, background=background, connectivity=connectivity,
            with_flag=with_flag,
        )
    return connected_components(
        img, background=background, connectivity=connectivity,
        max_iters=max_iters, num_classes=num_classes, with_flag=with_flag,
    )


def label_image(
    img: torch.Tensor,
    background: Optional[int] = None,
    connectivity: int = 8,
    max_regions: int = 16384,
    num_classes: int = 8,
):
    """skimage.measure.label parity: (ids [H,W], num_components)."""
    raw = connected_components(
        img, background=background, connectivity=connectivity, num_classes=num_classes
    )
    return compact_labels(raw, max_regions)
