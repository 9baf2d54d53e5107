"""K8: one strain's particle-fill step — kernel wrapper, plain version and
dispatch.

Counterpart of ``particle_col_image_segmentation_tpu/ops/fill_tiles.py``
(``particle_fill_step_pallas``, ``particle_fill_step_auto``).  One step of
the reference's fill loop (tiff_analysis.py:982-1015): the capped EDT of the
particle mask (``plane == particle_val``); the cell pixels (``== sval``) with
``d² < dt2`` or ``d² ≤ dr2`` become ``particle_val``; the count of those
pixels per plane.  The step reads the plane it is given and writes a fresh
one (Jacobi); callers loop over strains for the cumulative semantics.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.edt import edt_sq
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import as_planes, check_cap

__all__ = ["particle_fill_step", "particle_fill_step_cuda", "particle_fill_step_auto"]


def particle_fill_step(
    filled: torch.Tensor, particle_val: int, sval: int, cap: int, dt2: int, dr2: int
):
    """Plain fill step of an [H, W] or [B, H, W] plane → (plane, count):
    ``count`` is an int32 scalar for [H, W] and int32 [B] for [B, H, W]."""
    d2 = edt_sq(filled == particle_val, cap)
    overlap = (filled == sval) & ((d2 < dt2) | (d2 <= dr2))
    count = overlap.sum(dim=(-2, -1), dtype=torch.int32)
    return torch.where(overlap, particle_val, filled), count


def particle_fill_step_cuda(
    filled: torch.Tensor, particle_val: int, sval: int, cap: int, dt2: int, dr2: int
):
    """K8 on a contiguous CUDA uint8 [H, W] or [B, H, W] plane; same results
    as ``particle_fill_step``."""
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
    check_cap("particle_fill_step_cuda", cap)
    B, H, W = as_planes("particle_fill_step_cuda", filled)
    out = torch.empty_like(filled)
    count = torch.empty(B, dtype=torch.int32, device=filled.device)
    scratch = torch.empty(filled.shape, dtype=torch.int32, device=filled.device)
    lib = _kernels.library()
    with torch.cuda.device(filled.device):
        err = lib.pcis_particle_fill(
            filled.data_ptr(), out.data_ptr(), count.data_ptr(), scratch.data_ptr(),
            B, H, W, cap, particle_val, sval, dt2, dr2, _kernels.stream_of(filled),
        )
    _kernels.check(err, "particle_fill_step_cuda")
    particle_fill_step_cuda.launches += 1
    return out, (count if filled.ndim == 3 else count[0])


particle_fill_step_cuda.launches = 0


def particle_fill_step_auto(
    filled: torch.Tensor, particle_val: int, sval: int, cap: int, dt2: int, dr2: int
):
    """K8 for a CUDA tensor, the plain step for a CPU tensor."""
    if use_kernel(filled):
        return particle_fill_step_cuda(filled, particle_val, sval, cap, dt2, dr2)
    return particle_fill_step(filled, particle_val, sval, cap, dt2, dr2)
