"""Per-region tables: the plain versions behind K4, K5 and K7.

Counterpart of ``particle_col_image_segmentation_tpu/ops/regionprops.py``
(``region_counts``, ``RegionTable``, ``region_props``, ``CentroidTable``,
``centroid_sums``, ``centroids_int``, ``centroids_f64``).  Tables have
``max_regions + 1`` rows, row 0 being the background segment, and are
batched over any leading axes of ``seg``.

Coordinate sums stay exact (hi, lo) int32 digit pairs at the API boundary,
``Σrow = HILO_BASE·sr_hi + sr_lo``, as in the JAX package.  The two digits
are summed separately — ``sr_hi = Σ(r // 128)``, ``sr_lo = Σ(r % 128)`` —
so they are NOT the canonical split of the total: ``sr_lo`` may exceed 127.
Only the total is meaningful downstream, but the pairs themselves are what
the JAX tables hold, and the port's tables equal them digit for digit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "HILO_BASE",
    "RegionTable",
    "CentroidTable",
    "region_counts",
    "centroid_sums",
    "region_sums",
    "region_props",
    "centroids_int",
    "centroids_f64",
]

HILO_BASE = 128  # (hi, lo) digit base of the coordinate sums

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


class RegionTable(NamedTuple):
    """Fixed-size per-region property table; row 0 = background/padding.

    Empty rows (no pixel with that id) hold 0 in every column, bbox
    included, and ``valid`` False — on the plain path and the kernel alike.
    The JAX scatter path holds segment-max identities there instead, so
    comparisons with it mask by ``valid`` (``area`` agrees on every row).
    """

    area: torch.Tensor  # [..., R+1] int32
    sr_hi: torch.Tensor  # [..., R+1] int32   Σrow = HILO_BASE*sr_hi + sr_lo
    sr_lo: torch.Tensor  # [..., R+1] int32
    sc_hi: torch.Tensor  # [..., R+1] int32   Σcol = HILO_BASE*sc_hi + sc_lo
    sc_lo: torch.Tensor  # [..., R+1] int32
    bbox: torch.Tensor  # [..., R+1, 4] int32 (minr, minc, maxr, maxc) half-open
    class_id: torch.Tensor  # [..., R+1] int32 pixel value of the component
    valid: torch.Tensor  # [..., R+1] bool (area > 0 and not background row)


class CentroidTable(NamedTuple):
    """Area and the exact (hi, lo) coordinate digit sums only: the five
    columns the refine pipeline reads (``centroids_f64`` reads them by
    name).  Row 0 is the background segment; empty rows hold 0."""

    area: torch.Tensor  # [..., R+1] int32
    sr_hi: torch.Tensor  # [..., R+1] int32   Σrow = HILO_BASE*sr_hi + sr_lo
    sr_lo: torch.Tensor  # [..., R+1] int32
    sc_hi: torch.Tensor  # [..., R+1] int32   Σcol = HILO_BASE*sc_hi + sc_lo
    sc_lo: torch.Tensor  # [..., R+1] int32


def _bins(seg: torch.Tensor, R1: int) -> torch.Tensor:
    """Flat bin of every pixel of a [B, N] id array: ``b·R1 + id``, and the
    one spare bin ``B·R1`` for ids outside [0, R1), which are dropped."""
    B = seg.shape[0]
    ids = seg.to(torch.int64)
    keep = (ids >= 0) & (ids < R1)
    plane = R1 * torch.arange(B, device=seg.device)[:, None]
    return torch.where(keep, ids + plane, B * R1).flatten()


def _binned_sum(bins: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n + 1, dtype=torch.int64, device=bins.device)
    out.index_add_(0, bins, src.flatten().to(torch.int64))
    return out[:-1]


def _area_and_sums(seg: torch.Tensor, vals: torch.Tensor, max_regions: int):
    """(area int32, Σvals saturated to the int32 range as int64), both
    [..., R+1]."""
    R1 = max_regions + 1
    lead = seg.shape[:-2]
    ids = seg.reshape(-1, seg.shape[-2] * seg.shape[-1])
    bins = _bins(ids, R1)
    n = ids.shape[0] * R1
    area = _binned_sum(bins, torch.ones_like(bins), n)
    sums = _binned_sum(bins, vals, n).clamp(_I32_MIN, _I32_MAX)
    return area.to(torch.int32).reshape(lead + (R1,)), sums.reshape(lead + (R1,))


def _class_of(area: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    return torch.div(sums, area.clamp(min=1), rounding_mode="floor").to(torch.int32)


def region_counts(seg: torch.Tensor, img: torch.Tensor, max_regions: int):
    """(area [..., R+1], class_id [..., R+1]) int32 from compact ids ``seg``
    and the class image ``img``, over any leading batch axes.

    Ids outside [0, R+1) are dropped.  ``class_id = ⌊Σvalues / max(area, 1)⌋``
    with the value sum saturated to the int32 range — the TPU table kernel's
    contract (``region_counts_mxu``): it equals the JAX scatter path's
    per-region max wherever a region is value-homogeneous (every CCL
    component is) and its sum fits int32, and empty rows hold 0 where the
    scatter path holds INT32_MIN.
    """
    area, sums = _area_and_sums(seg, img, max_regions)
    return area, _class_of(area, sums)


def region_sums(seg: torch.Tensor, vals: torch.Tensor, max_regions: int):
    """(area [..., R+1], Σvals [..., R+1]) int32 per region — the sums
    ``region_counts`` divides, saturated to the int32 range (the contract of
    the JAX package's ``region_sums_mxu``)."""
    area, sums = _area_and_sums(seg, vals, max_regions)
    return area, sums.to(torch.int32)


def region_props(
    seg: torch.Tensor, img: torch.Tensor, max_regions: int, row_offset: int = 0,
    with_sums: bool = False,
):
    """RegionTable from compact ids ``seg`` [..., H, W] (0 = background) and
    the class image ``img`` — the plain version of kernel K5.

    Columns as the JAX ``region_props``; ``class_id`` as ``region_counts``
    (the saturated value sum over the area, which is the segment max on
    every value-homogeneous region).  Ids outside [0, R+1) are dropped.

    ``row_offset`` is the plane row of ``seg``'s first row: a row band of a
    plane split over a mesh gets its row digits and bbox rows in the plane's
    rows.  ``with_sums=True`` returns ``(table, sums)``, ``sums`` the int64
    value sum of each row (not saturated), which bands add before the class
    division.
    """
    R1 = max_regions + 1
    H, W = seg.shape[-2:]
    lead = seg.shape[:-2]
    ids = seg.reshape(-1, H * W)
    B = ids.shape[0]
    bins = _bins(ids, R1)
    n = B * R1
    pix = torch.arange(H * W, device=seg.device)
    rows = (pix // W + row_offset).expand(B, -1)
    cols = (pix % W).expand(B, -1)
    area = _binned_sum(bins, torch.ones_like(bins), n)
    digits = [
        _binned_sum(bins, d, n).to(torch.int32)
        for d in _pixel_digits(B, H, W, seg.device, row_offset)
    ]
    raw_sums = _binned_sum(bins, img.reshape(B, H * W), n)
    sums = raw_sums.clamp(_I32_MIN, _I32_MAX)

    def extreme(src, reduce, init):
        out = torch.full((n + 1,), init, dtype=torch.int64, device=seg.device)
        return out.scatter_reduce_(0, bins, src.flatten(), reduce)[:-1]

    bbox = torch.stack(
        [extreme(rows, "amin", _I32_MAX), extreme(cols, "amin", _I32_MAX),
         extreme(rows, "amax", -1) + 1, extreme(cols, "amax", -1) + 1],
        dim=-1,
    )
    bbox = torch.where((area > 0)[:, None], bbox, 0).to(torch.int32)
    class_id = _class_of(area, sums)
    area = area.to(torch.int32)
    valid = (area > 0) & (torch.arange(n, device=seg.device) % R1 > 0)

    def shaped(t):
        return t.reshape(lead + (R1,) + t.shape[1:])

    table = RegionTable(
        area=shaped(area),
        sr_hi=shaped(digits[0]),
        sr_lo=shaped(digits[1]),
        sc_hi=shaped(digits[2]),
        sc_lo=shaped(digits[3]),
        bbox=shaped(bbox),
        class_id=shaped(class_id),
        valid=shaped(valid),
    )
    return (table, shaped(raw_sums)) if with_sums else table


def _pixel_digits(B: int, H: int, W: int, device, row_offset: int = 0):
    """The four base-128 coordinate digits of every pixel, each [B, H·W]:
    r // 128, r % 128, c // 128, c % 128 (rows from ``row_offset``)."""
    pix = torch.arange(H * W, device=device)
    rows = (pix // W + row_offset).expand(B, -1)
    cols = (pix % W).expand(B, -1)
    return (rows // HILO_BASE, rows % HILO_BASE, cols // HILO_BASE, cols % HILO_BASE)


def centroid_sums(seg: torch.Tensor, max_regions: int, row_offset: int = 0) -> CentroidTable:
    """CentroidTable of compact ids ``seg`` [..., H, W] (0 = background),
    batched over any leading axes — the plain version of kernel K7.  Each
    digit column is summed on its own, as in ``region_props``; ids outside
    [0, R+1) are dropped.  ``row_offset`` is the plane row of ``seg``'s
    first row, as in ``region_props``: a row band's sums in the plane's
    rows."""
    R1 = max_regions + 1
    H, W = seg.shape[-2:]
    lead = seg.shape[:-2]
    ids = seg.reshape(-1, H * W)
    B = ids.shape[0]
    bins = _bins(ids, R1)
    n = B * R1
    area = _binned_sum(bins, torch.ones_like(bins), n)
    sr_hi, sr_lo, sc_hi, sc_lo = (
        _binned_sum(bins, d, n) for d in _pixel_digits(B, H, W, seg.device, row_offset)
    )

    def shaped(t):
        return t.to(torch.int32).reshape(lead + (R1,))

    return CentroidTable(
        area=shaped(area), sr_hi=shaped(sr_hi), sr_lo=shaped(sr_lo),
        sc_hi=shaped(sc_hi), sc_lo=shaped(sc_lo),
    )


def _exact_floor_div(hi: torch.Tensor, lo: torch.Tensor, d: torch.Tensor):
    """⌊(HILO_BASE·hi + lo) / d⌋ in int32 (d ≥ 1): no intermediate leaves
    int32 for planes up to 16383² (the JAX package's overflow argument)."""
    q1 = torch.div(hi, d, rounding_mode="floor")
    t = HILO_BASE * (hi - q1 * d) + lo
    return HILO_BASE * q1 + torch.div(t, d, rounding_mode="floor")


def centroids_int(table: RegionTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact truncated centroids ⌊Σrow/area⌋, ⌊Σcol/area⌋ (int32, on the
    table's device) — the reference's ``int(r.centroid[...])`` lookup
    coordinates.  Empty rows give (0, 0)."""
    d = table.area.clamp(min=1)
    return (
        _exact_floor_div(table.sr_hi, table.sr_lo, d),
        _exact_floor_div(table.sc_hi, table.sc_lo, d),
    )


def centroids_f64(table) -> Tuple[np.ndarray, np.ndarray]:
    """Exact float64 centroids from a host table (NumPy arrays)."""
    area = np.maximum(np.asarray(table.area, dtype=np.int64), 1)
    sr = HILO_BASE * np.asarray(table.sr_hi, np.int64) + np.asarray(table.sr_lo, np.int64)
    sc = HILO_BASE * np.asarray(table.sc_hi, np.int64) + np.asarray(table.sc_lo, np.int64)
    return sr / area, sc / area
