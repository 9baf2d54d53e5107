"""K1: the median filter kernel's wrapper and the filter's dispatch.

Counterpart of ``particle_col_image_segmentation_tpu/ops/filters_tiles.py``.
The kernel (``csrc/median.cu``) has none of the TPU kernel's alignment
preconditions (H % tile, W % 128): it takes any plane size.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.filters import median_label_filter

__all__ = ["median_label_filter_cuda", "median_label_filter_auto"]


def median_label_filter_cuda(
    img: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """K1 on a contiguous CUDA uint8 [H, W] or [B, H, W] plane → uint8."""
    _kernels.require_cuda("median_label_filter_cuda", img)
    if img.dtype != torch.uint8 or img.ndim not in (2, 3):
        raise ValueError(
            f"median_label_filter_cuda: expected uint8 [H,W] or [B,H,W], got "
            f"{img.dtype} {tuple(img.shape)}"
        )
    if size % 2 == 0 or not 3 <= size <= 9:
        raise ValueError(f"median_label_filter_cuda: size must be odd in [3, 9], got {size}")
    if not 1 <= num_classes <= 8:
        raise ValueError(
            f"median_label_filter_cuda: num_classes must be in [1, 8], got {num_classes}"
        )
    B = img.shape[0] if img.ndim == 3 else 1
    H, W = img.shape[-2:]
    out = torch.empty_like(img)
    lib = _kernels.library()
    with torch.cuda.device(img.device):
        err = lib.pcis_median_u8(
            img.data_ptr(), out.data_ptr(), B, H, W, size, num_classes,
            _kernels.stream_of(img),
        )
    _kernels.check(err, "median_label_filter_cuda")
    _kernels.count_launch(median_label_filter_cuda)
    return out


median_label_filter_cuda.launches = 0


def median_label_filter_auto(
    img: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain filter for a CPU tensor."""
    if use_kernel(img):
        return median_label_filter_cuda(img, size, num_classes)
    return median_label_filter(img, size, num_classes)
