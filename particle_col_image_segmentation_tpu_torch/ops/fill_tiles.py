"""K8: one strain's particle-fill step — kernel wrapper, plain version and
dispatch.

Counterpart of ``particle_col_image_segmentation_tpu/ops/fill_tiles.py``
(``particle_fill_step_pallas``, ``particle_fill_step_auto``).  One step of
the reference's fill loop (tiff_analysis.py:982-1015): the capped EDT of the
particle mask (``plane == particle_val``); the cell pixels (``== sval``) with
``d² < dt2`` or ``d² ≤ dr2`` become ``particle_val``; the count of those
pixels per plane.  The step reads the plane it is given and writes a fresh
one (Jacobi); callers loop over strains for the cumulative semantics.

``count_rows=(lo, hi)`` counts the filled pixels of rows [lo, hi) alone: a
row band of a plane split over a mesh is filled with ``cap`` halo rows above
and below it, and only its own rows count (K8's band mode).
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.edt import edt_sq
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import as_planes, check_cap

__all__ = [
    "particle_fill_step", "particle_fill_step_cuda", "particle_fill_step_auto", "max_fused_cap",
]


def _count_rows(count_rows, H: int):
    lo, hi = (0, H) if count_rows is None else count_rows
    if not 0 <= lo <= hi <= H:
        raise ValueError(f"count_rows {count_rows} is not a row window of {H} rows")
    return lo, hi


def particle_fill_step(
    filled: torch.Tensor, particle_val: int, sval: int, cap: int, dt2: int, dr2: int,
    count_rows=None,
):
    """Plain fill step of an [H, W] or [B, H, W] plane → (plane, count):
    ``count`` is an int32 scalar for [H, W] and int32 [B] for [B, H, W]."""
    lo, hi = _count_rows(count_rows, filled.shape[-2])
    d2 = edt_sq(filled == particle_val, cap)
    overlap = (filled == sval) & ((d2 < dt2) | (d2 <= dr2))
    count = overlap[..., lo:hi, :].sum(dim=(-2, -1), dtype=torch.int32)
    return torch.where(overlap, particle_val, filled), count


def max_fused_cap() -> int:
    """The largest cap K8's one-kernel route takes (its tile and halo fit a
    block's shared memory); larger caps take the two-kernel route."""
    return _kernels.library().pcis_fill_max_fused_cap()


def particle_fill_step_cuda(
    filled: torch.Tensor, particle_val: int, sval: int, cap: int, dt2: int, dr2: int,
    count_rows=None,
):
    """K8 on a contiguous CUDA uint8 [H, W] or [B, H, W] plane; same results
    as ``particle_fill_step``.  The route follows from ``cap`` alone: one
    kernel up to ``max_fused_cap()``, else the row pass and column tiles
    through an int32 scratch plane (``particle_fill_step_cuda.last_route``)."""
    _kernels.require_cuda("particle_fill_step_cuda", filled)
    if filled.dtype != torch.uint8 or filled.ndim not in (2, 3):
        raise ValueError(
            f"particle_fill_step_cuda: expected uint8 [H,W] or [B,H,W], got "
            f"{filled.dtype} {tuple(filled.shape)}"
        )
    if not (0 <= particle_val <= 255 and 0 <= sval <= 255):
        raise ValueError(
            f"particle_fill_step_cuda: class values must be uint8, got "
            f"{particle_val} and {sval}"
        )
    if not all(-(2**31) <= t < 2**31 for t in (dt2, dr2)):
        raise ValueError(f"particle_fill_step_cuda: dt2 {dt2} and dr2 {dr2} must be int32")
    check_cap("particle_fill_step_cuda", cap)
    B, H, W = as_planes("particle_fill_step_cuda", filled)
    lo, hi = _count_rows(count_rows, H)
    out = torch.empty_like(filled)
    count = torch.empty(B, dtype=torch.int32, device=filled.device)
    lib = _kernels.library()
    fused = cap <= max_fused_cap()
    args = (B, H, W, cap, particle_val, sval, dt2, dr2, lo, hi, _kernels.stream_of(filled))
    with torch.cuda.device(filled.device):
        if fused:
            err = lib.pcis_particle_fill_fused(
                filled.data_ptr(), out.data_ptr(), count.data_ptr(), *args
            )
        else:
            scratch = torch.empty(filled.shape, dtype=torch.int32, device=filled.device)
            err = lib.pcis_particle_fill(
                filled.data_ptr(), out.data_ptr(), count.data_ptr(), scratch.data_ptr(), *args
            )
    _kernels.check(err, "particle_fill_step_cuda")
    _kernels.count_launch(particle_fill_step_cuda)
    particle_fill_step_cuda.last_route = "fused" if fused else "two-kernel"
    return out, (count if filled.ndim == 3 else count[0])


particle_fill_step_cuda.launches = 0
particle_fill_step_cuda.last_route = None


def particle_fill_step_auto(
    filled: torch.Tensor, particle_val: int, sval: int, cap: int, dt2: int, dr2: int,
    count_rows=None,
):
    """K8 for a CUDA tensor, the plain step for a CPU tensor."""
    if use_kernel(filled):
        return particle_fill_step_cuda(filled, particle_val, sval, cap, dt2, dr2, count_rows)
    return particle_fill_step(filled, particle_val, sval, cap, dt2, dr2, count_rows)
