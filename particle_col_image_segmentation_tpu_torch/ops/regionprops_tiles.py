"""K4: the region-table kernel's wrapper and the tables' dispatch.

Counterpart of ``region_counts_mxu`` / ``region_counts_auto`` in
``particle_col_image_segmentation_tpu/ops/regionprops_tiles.py``.  The TPU
built these tables from one-hot int8 matmuls with base-128 digit splits;
``csrc/counts.cu`` keeps shared-memory histograms with an int64 sum instead,
and its tables equal the plain ``ops.regionprops.region_counts`` exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_counts

__all__ = ["region_counts_cuda", "region_counts_auto"]


def region_counts_cuda(seg: torch.Tensor, img: torch.Tensor, max_regions: int):
    """K4 on contiguous CUDA int32 ids and uint8/int32 values, [H,W] or
    [B,H,W] → (area, class_id) int32 [..., R+1]."""
    _kernels.require_cuda("region_counts_cuda", seg, img)
    if seg.dtype != torch.int32 or img.dtype not in (torch.uint8, torch.int32):
        raise ValueError(
            f"region_counts_cuda: expected int32 ids and uint8/int32 values, got "
            f"{seg.dtype} and {img.dtype}"
        )
    if seg.shape != img.shape or seg.ndim not in (2, 3) or seg.numel() == 0:
        raise ValueError(
            f"region_counts_cuda: expected equal non-empty [H,W] or [B,H,W] "
            f"shapes, got {tuple(seg.shape)} and {tuple(img.shape)}"
        )
    if not 0 <= max_regions < 2**31 - 1:
        raise ValueError(f"region_counts_cuda: max_regions {max_regions} out of range")
    B = seg.shape[0] if seg.ndim == 3 else 1
    H, W = seg.shape[-2:]
    R1 = max_regions + 1
    area = torch.empty(seg.shape[:-2] + (R1,), dtype=torch.int32, device=seg.device)
    cls = torch.empty_like(area)
    sums = torch.empty(B * R1, dtype=torch.int64, device=seg.device)
    lib = _kernels.library()
    with torch.cuda.device(seg.device):
        err = lib.pcis_region_counts(
            seg.data_ptr(), img.data_ptr(), int(img.dtype == torch.uint8),
            area.data_ptr(), cls.data_ptr(), sums.data_ptr(), B, H, W, R1,
            _kernels.stream_of(seg),
        )
    _kernels.check(err, "region_counts_cuda")
    region_counts_cuda.launches += 1
    return area, cls


region_counts_cuda.launches = 0


def region_counts_auto(
    seg: torch.Tensor, img: torch.Tensor, max_regions: int,
    val_bound: Optional[int] = None,
):
    """K4 for CUDA tensors, the plain tables for CPU tensors.

    ``val_bound`` (a caller's promise that |values| ≤ val_bound) is accepted
    for parity with the JAX dispatch; neither path needs it, since both sum
    in int64."""
    del val_bound
    if use_kernel(seg, img):
        return region_counts_cuda(seg, img, max_regions)
    return region_counts(seg, img, max_regions)
