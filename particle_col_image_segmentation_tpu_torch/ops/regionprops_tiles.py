"""K4, K5, K6 and K7: the region-table, table-lookup and centroid-table
kernels' wrappers and their dispatch.

Counterpart of ``particle_col_image_segmentation_tpu/ops/regionprops_tiles.py``
(``region_counts_mxu``, ``region_sums_mxu``, ``region_table_mxu``,
``table_lookup_mxu``, ``centroid_sums_mxu`` and their ``*_auto`` dispatch).  The TPU built these
tables from one-hot int8 matmuls with base-128 digit splits and two passes
(the second over the transposed plane for the column extremes).  Here
``csrc/counts.cu`` (K4) and ``csrc/table.cu`` (K5, and K7 as the same run
walk's instance for the five centroid columns) add 16-px runs to
shared-memory tables, and ``csrc/lookup.cu`` (K6) is a bounds-checked gather; their outputs equal the plain versions in
``ops.regionprops`` and ``table_lookup`` exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.regionprops import (
    CentroidTable,
    RegionTable,
    centroid_sums,
    region_counts,
    region_props,
    region_sums,
)

__all__ = [
    "region_counts_cuda",
    "region_counts_auto",
    "region_sums_cuda",
    "region_sums_auto",
    "region_table_cuda",
    "region_props_auto",
    "table_lookup",
    "table_lookup_cuda",
    "table_lookup_auto",
    "centroid_sums_cuda",
    "centroid_sums_auto",
]


def _check_table_inputs(name: str, seg: torch.Tensor, img: torch.Tensor, max_regions: int):
    _kernels.require_cuda(name, seg, img)
    if seg.dtype != torch.int32 or img.dtype not in (torch.uint8, torch.int32):
        raise ValueError(
            f"{name}: expected int32 ids and uint8/int32 values, got "
            f"{seg.dtype} and {img.dtype}"
        )
    if seg.shape != img.shape or seg.ndim not in (2, 3) or seg.numel() == 0:
        raise ValueError(
            f"{name}: expected equal non-empty [H,W] or [B,H,W] shapes, got "
            f"{tuple(seg.shape)} and {tuple(img.shape)}"
        )
    if seg.shape[-2] * seg.shape[-1] >= 2**31:
        raise ValueError(f"{name}: plane of {tuple(seg.shape[-2:])} exceeds int32 indices")
    if not 0 <= max_regions < 2**31 - 1:
        raise ValueError(f"{name}: max_regions {max_regions} out of range")
    return (seg.shape[0] if seg.ndim == 3 else 1), seg.shape[-2], seg.shape[-1]


def _counts(seg: torch.Tensor, img: torch.Tensor, max_regions: int, name: str):
    """Launch K4 → (area, class_id, int64 value sums), all [..., R+1]."""
    B, H, W = _check_table_inputs(name, seg, img, max_regions)
    R1 = max_regions + 1
    area = torch.empty(seg.shape[:-2] + (R1,), dtype=torch.int32, device=seg.device)
    cls = torch.empty_like(area)
    sums = torch.empty(area.shape, dtype=torch.int64, device=seg.device)
    lib = _kernels.library()
    with torch.cuda.device(seg.device):
        err = lib.pcis_region_counts(
            seg.data_ptr(), img.data_ptr(), int(img.dtype == torch.uint8),
            area.data_ptr(), cls.data_ptr(), sums.data_ptr(), B, H, W, R1,
            _kernels.stream_of(seg),
        )
    _kernels.check(err, name)
    return area, cls, sums


def region_counts_cuda(seg: torch.Tensor, img: torch.Tensor, max_regions: int):
    """K4 on contiguous CUDA int32 ids and uint8/int32 values, [H,W] or
    [B,H,W] → (area, class_id) int32 [..., R+1]."""
    area, cls, _ = _counts(seg, img, max_regions, "region_counts_cuda")
    _kernels.count_launch(region_counts_cuda)
    return area, cls


region_counts_cuda.launches = 0


def region_sums_cuda(seg: torch.Tensor, vals: torch.Tensor, max_regions: int):
    """K4 again, returning (area, Σvals saturated to int32) [..., R+1]: the
    int64 sums the kernel keeps for the class division, clamped as the TPU
    kernel's ``_recombine_saturating`` does."""
    area, _, sums = _counts(seg, vals, max_regions, "region_sums_cuda")
    _kernels.count_launch(region_sums_cuda)
    return area, sums.clamp(-(2**31), 2**31 - 1).to(torch.int32)


region_sums_cuda.launches = 0


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


def region_sums_auto(seg: torch.Tensor, vals: torch.Tensor, max_regions: int):
    """(area, Σvals) per region: K4 for CUDA tensors, plain for CPU ones."""
    if use_kernel(seg, vals):
        return region_sums_cuda(seg, vals, max_regions)
    return region_sums(seg, vals, max_regions)


def region_table_cuda(
    seg: torch.Tensor, img: torch.Tensor, max_regions: int, row_offset: int = 0,
    with_sums: bool = False,
):
    """K5: the full RegionTable of contiguous CUDA int32 ids and uint8/int32
    values, [H,W] or [B,H,W].  Equal to ``ops.regionprops.region_props`` on
    every row, empty rows (all zeros) included, with the same ``row_offset``
    (K5's band mode) and ``with_sums``."""
    B, H, W = _check_table_inputs("region_table_cuda", seg, img, max_regions)
    if not 0 <= row_offset < 2**31 - H:
        raise ValueError(f"region_table_cuda: row_offset {row_offset} out of range")
    R1 = max_regions + 1
    lead = seg.shape[:-2]
    n = B * R1
    # one buffer, 49 B a row: area | sr_hi | sr_lo | sc_hi | sc_lo | class_id
    # (int32 [6, n]), bbox (int32 [n, 4]), the kernel's int64 value sums, valid
    buf = torch.empty(49 * n, dtype=torch.uint8, device=seg.device)
    lib = _kernels.library()
    with torch.cuda.device(seg.device):
        err = lib.pcis_region_table(
            seg.data_ptr(), img.data_ptr(), int(img.dtype == torch.uint8),
            buf.data_ptr(), B, H, W, R1, row_offset, _kernels.stream_of(seg),
        )
    _kernels.check(err, "region_table_cuda")
    _kernels.count_launch(region_table_cuda)
    cols = buf[: 24 * n].view(torch.int32).view((6,) + lead + (R1,))
    area, sr_hi, sr_lo, sc_hi, sc_lo, class_id = cols.unbind(0)
    table = RegionTable(
        area=area, sr_hi=sr_hi, sr_lo=sr_lo, sc_hi=sc_hi, sc_lo=sc_lo,
        bbox=buf[24 * n : 40 * n].view(torch.int32).view(lead + (R1, 4)),
        class_id=class_id,
        valid=buf[48 * n :].view(torch.bool).view(lead + (R1,)),
    )
    if with_sums:
        return table, buf[40 * n : 48 * n].view(torch.int64).view(lead + (R1,))
    return table


region_table_cuda.launches = 0


def region_props_auto(
    seg: torch.Tensor, img: torch.Tensor, max_regions: int, val_bound: Optional[int] = None,
    row_offset: int = 0, with_sums: bool = False,
):
    """K5 for CUDA tensors, the plain table for CPU tensors.  ``val_bound``
    is the JAX package's MXU channel knob, accepted and not read."""
    del val_bound
    if use_kernel(seg, img):
        return region_table_cuda(seg, img, max_regions, row_offset, with_sums)
    return region_props(seg, img, max_regions, row_offset, with_sums)


def _check_lookup(seg: torch.Tensor, table: torch.Tensor) -> None:
    if seg.ndim not in (2, 3) or seg.numel() == 0:
        raise ValueError(f"table_lookup: expected non-empty [H,W] or [B,H,W] ids, got {tuple(seg.shape)}")
    per_plane = table.ndim == 2
    if table.ndim not in (1, 2) or table.shape[-1] == 0 or (
        per_plane and (seg.ndim != 3 or table.shape[0] != seg.shape[0])
    ):
        raise ValueError(
            f"table_lookup: expected a [R] table, or [B,R] for [B,H,W] ids, got "
            f"{tuple(table.shape)} for {tuple(seg.shape)}"
        )


def table_lookup(seg: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[seg]`` as int32, the plain version of K6: ids outside
    [0, R) read 0 (clip, gather, mask).  ``table`` is [R], or [B, R] with
    one row per plane of a [B, H, W] ``seg``."""
    _check_lookup(seg, table)
    R = table.shape[-1]
    idx = seg.clamp(0, R - 1).to(torch.int64)
    tab = table.to(torch.int32)
    if tab.ndim == 2:
        out = torch.gather(tab, 1, idx.reshape(seg.shape[0], -1)).reshape(seg.shape)
    else:
        out = tab[idx]
    return torch.where((seg >= 0) & (seg < R), out, 0)


def table_lookup_cuda(seg: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K6 on contiguous CUDA int32 ids and an int32 table; same contract as
    ``table_lookup`` (exact for any int32 table value)."""
    _kernels.require_cuda("table_lookup_cuda", seg, table)
    if seg.dtype != torch.int32 or table.dtype != torch.int32:
        raise ValueError(
            f"table_lookup_cuda: expected int32 ids and table, got {seg.dtype} "
            f"and {table.dtype}"
        )
    _check_lookup(seg, table)
    if seg.shape[-2] * seg.shape[-1] >= 2**31 or table.shape[-1] >= 2**31:
        raise ValueError("table_lookup_cuda: sizes exceed int32 indices")
    B = seg.shape[0] if seg.ndim == 3 else 1
    H, W = seg.shape[-2:]
    out = torch.empty_like(seg)
    lib = _kernels.library()
    with torch.cuda.device(seg.device):
        err = lib.pcis_table_lookup(
            seg.data_ptr(), table.data_ptr(), out.data_ptr(), B, H, W,
            table.shape[-1], int(table.ndim == 2), _kernels.stream_of(seg),
        )
    _kernels.check(err, "table_lookup_cuda")
    _kernels.count_launch(table_lookup_cuda)
    return out


table_lookup_cuda.launches = 0


def table_lookup_auto(seg: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K6 for CUDA tensors, the plain gather for CPU tensors."""
    if use_kernel(seg, table):
        return table_lookup_cuda(seg, table)
    return table_lookup(seg, table)


def centroid_sums_cuda(seg: torch.Tensor, max_regions: int, row_offset: int = 0) -> CentroidTable:
    """K7: the CentroidTable of contiguous CUDA int32 ids, [H,W] or [B,H,W],
    rows counted from ``row_offset`` (K7's band mode).  Equal to
    ``ops.regionprops.centroid_sums`` on every row."""
    _kernels.require_cuda("centroid_sums_cuda", seg)
    if seg.dtype != torch.int32:
        raise ValueError(f"centroid_sums_cuda: expected int32 ids, got {seg.dtype}")
    if seg.ndim not in (2, 3) or seg.numel() == 0:
        raise ValueError(
            f"centroid_sums_cuda: expected non-empty [H,W] or [B,H,W] ids, got {tuple(seg.shape)}"
        )
    if (seg.shape[-2] * seg.shape[-1] >= 2**31 or not 0 <= max_regions < 2**31 - 1
            or not 0 <= row_offset < 2**31 - seg.shape[-2]):
        raise ValueError("centroid_sums_cuda: sizes exceed int32 indices")
    B = seg.shape[0] if seg.ndim == 3 else 1
    H, W = seg.shape[-2:]
    R1 = max_regions + 1
    # area | sr_hi | sr_lo | sc_hi | sc_lo, one buffer
    cols = torch.empty((5,) + seg.shape[:-2] + (R1,), dtype=torch.int32, device=seg.device)
    lib = _kernels.library()
    with torch.cuda.device(seg.device):
        err = lib.pcis_centroid_sums(
            seg.data_ptr(), cols.data_ptr(), B, H, W, R1, row_offset, _kernels.stream_of(seg),
        )
    _kernels.check(err, "centroid_sums_cuda")
    _kernels.count_launch(centroid_sums_cuda)
    area, sr_hi, sr_lo, sc_hi, sc_lo = cols.unbind(0)
    return CentroidTable(area=area, sr_hi=sr_hi, sr_lo=sr_lo, sc_hi=sc_hi, sc_lo=sc_lo)


centroid_sums_cuda.launches = 0


def centroid_sums_auto(seg: torch.Tensor, max_regions: int, row_offset: int = 0) -> CentroidTable:
    """K7 for a CUDA tensor, the plain table for a CPU tensor; rows counted
    from ``row_offset``."""
    if use_kernel(seg):
        return centroid_sums_cuda(seg, max_regions, row_offset)
    return centroid_sums(seg, max_regions, row_offset)
