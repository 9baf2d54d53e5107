"""K1: the median filter kernel's wrapper and the filter's dispatch.

Counterpart of ``particle_col_image_segmentation_tpu/ops/filters_tiles.py``.
The kernel (``csrc/median.cu``) has none of the TPU kernel's alignment
preconditions (H % tile, W % 128): it takes any plane size.  Its band mode
(``median_label_filter_rows_padded_cuda``) filters one row band of a plane
split over a mesh, from the band and its halo rows.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.filters import (
    median_label_filter,
    median_label_filter_rows_padded,
)

__all__ = [
    "median_label_filter_cuda",
    "median_label_filter_auto",
    "median_label_filter_rows_padded_cuda",
    "median_label_filter_rows_padded_auto",
]


def _median(name: str, img: torch.Tensor, size: int, num_classes: int, row_padded: bool):
    _kernels.require_cuda(name, img)
    if img.dtype != torch.uint8 or img.ndim not in (2, 3):
        raise ValueError(
            f"{name}: expected uint8 [H,W] or [B,H,W], got {img.dtype} {tuple(img.shape)}"
        )
    if size % 2 == 0 or not 3 <= size <= 9:
        raise ValueError(f"{name}: size must be odd in [3, 9], got {size}")
    if not 1 <= num_classes <= 8:
        raise ValueError(f"{name}: num_classes must be in [1, 8], got {num_classes}")
    B = img.shape[0] if img.ndim == 3 else 1
    H, W = img.shape[-2:]
    if row_padded:
        H -= 2 * (size // 2)
        if H <= 0:
            raise ValueError(f"{name}: {img.shape[-2]} rows hold no band inside a {size // 2}-row halo")
    out = torch.empty(img.shape[:-2] + (H, W), dtype=img.dtype, device=img.device)
    lib = _kernels.library()
    with torch.cuda.device(img.device):
        err = lib.pcis_median_u8(
            img.data_ptr(), out.data_ptr(), B, H, W, size, num_classes, int(row_padded),
            _kernels.stream_of(img),
        )
    _kernels.check(err, name)
    return out


def median_label_filter_cuda(
    img: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """K1 on a contiguous CUDA uint8 [H, W] or [B, H, W] plane → uint8."""
    out = _median("median_label_filter_cuda", img, size, num_classes, False)
    _kernels.count_launch(median_label_filter_cuda)
    return out


median_label_filter_cuda.launches = 0


def median_label_filter_rows_padded_cuda(
    xp: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """K1's band mode on a contiguous CUDA uint8 band with ``size // 2`` halo
    rows above and below, [(B,) h + 2·half, W] → [(B,) h, W]: the halo rows
    are read as given, the columns reflect.  Equal to
    ``ops.filters.median_label_filter_rows_padded``."""
    out = _median("median_label_filter_rows_padded_cuda", xp, size, num_classes, True)
    _kernels.count_launch(median_label_filter_rows_padded_cuda)
    return out


median_label_filter_rows_padded_cuda.launches = 0


def median_label_filter_auto(
    img: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain filter for a CPU tensor."""
    if use_kernel(img):
        return median_label_filter_cuda(img, size, num_classes)
    return median_label_filter(img, size, num_classes)


def median_label_filter_rows_padded_auto(
    xp: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """K1's band mode for a CUDA tensor, its plain version for a CPU one."""
    if use_kernel(xp):
        return median_label_filter_rows_padded_cuda(xp, size, num_classes)
    return median_label_filter_rows_padded(xp, size, num_classes)
