"""K10 and K11: the watershed's two CUDA tile passes and the loop that drives
them.

Counterpart of ``particle_col_image_segmentation_tpu/ops/watershed_tiles.py``
(``watershed_sweeps`` and its ``_cost_kernel`` / ``_label_kernel`` band
sweeps).  ``csrc/watershed.cu`` relaxes 32×32 tiles with a one-pixel halo in
shared memory; the host repeats a phase's pass until no plane changed, then
runs the other phase the same way.  Both phases have a unique fixpoint, so
the labels equal the plain ``ops.watershed.watershed`` exactly wherever both
report ``converged``.
"""

from __future__ import annotations

from typing import Optional

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import as_planes

__all__ = [
    "watershed_cuda", "minimax_costs_cuda", "claim_labels_cuda",
    "watershed_cost_pass_cuda", "watershed_label_pass_cuda",
]

_INF = 3.4e38  # rounds to the float32 the kernels write as 3.4e38f
_BIG_LAB = torch.iinfo(torch.int32).max
_MASK_BIT = 1
_SEED_BIT = 2


def watershed_cost_pass_cuda(img, flags, cost, changed, connectivity: int) -> None:
    """K10: one phase-1 pass over [B, H, W] planes, ``cost`` relaxed in
    place; ``changed[b]`` set to 1 for each plane b that changed (the caller
    zeroes it first)."""
    B, H, W = as_planes("watershed_cost_pass_cuda", cost)
    lib = _kernels.library()
    with torch.cuda.device(cost.device):
        err = lib.pcis_watershed_cost(
            img.data_ptr(), flags.data_ptr(), cost.data_ptr(), changed.data_ptr(),
            B, H, W, connectivity, _kernels.stream_of(cost),
        )
    _kernels.check(err, "watershed_cost_pass_cuda")
    watershed_cost_pass_cuda.launches += 1


watershed_cost_pass_cuda.launches = 0


def watershed_label_pass_cuda(cost, img, flags, lab, dist, eimg, changed,
                              connectivity: int) -> None:
    """K11: one phase-2 pass, (``lab``, ``dist``, ``eimg``) relaxed in place
    against the converged ``cost``; ``changed`` as for K10."""
    B, H, W = as_planes("watershed_label_pass_cuda", lab)
    lib = _kernels.library()
    with torch.cuda.device(lab.device):
        err = lib.pcis_watershed_label(
            cost.data_ptr(), img.data_ptr(), flags.data_ptr(), lab.data_ptr(),
            dist.data_ptr(), eimg.data_ptr(), changed.data_ptr(), B, H, W,
            connectivity, _kernels.stream_of(lab),
        )
    _kernels.check(err, "watershed_label_pass_cuda")
    watershed_label_pass_cuda.launches += 1


watershed_label_pass_cuda.launches = 0


def _run(pass_fn, changed: torch.Tensor, max_iters: int) -> int:
    """Repeat ``pass_fn`` until a pass changes no plane or ``max_iters``
    passes ran; returns the pass count and leaves ``changed`` holding the
    last pass's per-plane flags."""
    if max_iters < 1:
        raise ValueError(f"watershed: max_iters must be >= 1, got {max_iters}")
    passes = 0
    while passes < max_iters:
        changed.zero_()
        pass_fn()
        passes += 1
        if not bool(changed.any()):
            break
    return passes


def _flags(m: torch.Tensor, seeded: torch.Tensor) -> torch.Tensor:
    return (m.to(torch.uint8) * _MASK_BIT + seeded.to(torch.uint8) * _SEED_BIT).contiguous()


def minimax_costs_cuda(img, m, seeded, connectivity: int = 1, max_iters: int = 1024):
    """Phase 1 on K10, for CUDA [B, H, W] float32 ``img`` and bool ``m`` and
    ``seeded``: (cost, per-plane bool still changing, passes).  The costs
    equal ``ops.watershed.minimax_costs``'s wherever both converge."""
    img = img.contiguous()
    flags = _flags(m, seeded)
    _kernels.require_cuda("minimax_costs_cuda", img, flags)
    inf = torch.tensor(_INF, dtype=torch.float32, device=img.device)
    cost = torch.where(seeded, img, inf).contiguous()
    changed = torch.zeros(img.shape[0], dtype=torch.int32, device=img.device)
    passes = _run(lambda: watershed_cost_pass_cuda(img, flags, cost, changed, connectivity),
                  changed, max_iters)
    return cost, changed != 0, passes


def claim_labels_cuda(cost, img, lab0, m, seeded, connectivity: int = 1,
                      max_iters: int = 1024):
    """Phase 2 on K11 against a converged ``cost``: (labels, per-plane bool
    still changing, passes), as ``ops.watershed.claim_labels``."""
    img = img.contiguous()
    flags = _flags(m, seeded)
    _kernels.require_cuda("claim_labels_cuda", cost, img, flags)
    inf = torch.tensor(_INF, dtype=torch.float32, device=img.device)
    big = torch.full(img.shape, _BIG_LAB, dtype=torch.int32, device=img.device)
    lab = torch.where(seeded, lab0, big).contiguous()
    dist = torch.where(seeded, 0, big).contiguous()
    eimg = torch.where(seeded, -inf, inf).contiguous()
    changed = torch.zeros(img.shape[0], dtype=torch.int32, device=img.device)
    passes = _run(lambda: watershed_label_pass_cuda(cost, img, flags, lab, dist, eimg,
                                                    changed, connectivity),
                  changed, max_iters)
    reached = m & (cost < inf) & (lab != _BIG_LAB)
    return torch.where(reached, lab, 0), changed != 0, passes


def watershed_cuda(
    image: torch.Tensor,
    markers: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    connectivity: int = 1,
    max_iters: int = 1024,
    with_flag: bool = False,
):
    """The watershed of CUDA [..., H, W] planes on K10 and K11.

    Same arguments and result as ``ops.watershed.watershed``, except that
    ``max_iters`` bounds the passes of each phase (one pass relaxes every
    32×32 tile to its local fixpoint).  A plane still changing when a
    phase's budget runs out reports ``converged`` False; phase 2 starts once
    phase 1 has stopped on every plane.  The pass counts of the last call
    are kept in ``watershed_cuda.last_passes`` as (phase 1, phase 2)."""
    if connectivity not in (1, 2):
        raise ValueError(f"watershed_cuda: connectivity must be 1 or 2, got {connectivity}")
    for t in (markers, mask):
        if t is not None and t.shape != image.shape:
            raise ValueError(
                f"watershed_cuda: shapes differ: {tuple(t.shape)} and {tuple(image.shape)}"
            )
    B, H, W = as_planes("watershed_cuda", image)
    img = image.to(torch.float32).reshape(B, H, W)
    lab0 = markers.to(torch.int32).reshape(B, H, W)
    m = (torch.ones_like(lab0, dtype=torch.bool) if mask is None
         else mask.to(torch.bool).reshape(B, H, W))
    seeded = (lab0 > 0) & m
    cost, c_changed, p1 = minimax_costs_cuda(img, m, seeded, connectivity, max_iters)
    out, l_changed, p2 = claim_labels_cuda(cost, img, lab0, m, seeded, connectivity, max_iters)
    watershed_cuda.last_passes = (p1, p2)
    out = out.reshape(image.shape)
    if with_flag:
        return out, ~(c_changed | l_changed).reshape(image.shape[:-2])
    return out


watershed_cuda.last_passes = (0, 0)
