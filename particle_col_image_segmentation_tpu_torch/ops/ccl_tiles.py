"""K2 (union-find CCL) and K3 (raster-rank compaction) kernel wrappers.

Counterpart of ``particle_col_image_segmentation_tpu/ops/ccl_tiles.py``,
whose band sweeps (``_band_kernel``) and fused rank seeding
(``_rank_init_kernel``) these kernels replace.  The outputs equal the plain
``ops.ccl.connected_components`` / ``compact_labels`` exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from particle_col_image_segmentation_tpu_torch import _kernels

__all__ = ["ccl_cuda", "compact_labels_cuda"]


def _planes(name: str, t: torch.Tensor):
    if t.ndim not in (2, 3) or t.numel() == 0:
        raise ValueError(f"{name}: expected non-empty [H,W] or [B,H,W], got {tuple(t.shape)}")
    H, W = t.shape[-2:]
    if H * W >= 2**31:
        raise ValueError(f"{name}: plane of {H}x{W} px exceeds int32 linear indices")
    return (t.shape[0] if t.ndim == 3 else 1), H, W


def ccl_cuda(
    img: torch.Tensor,
    background: Optional[int] = None,
    connectivity: int = 8,
    with_flag: bool = False,
):
    """K2: connected_components of a contiguous CUDA uint8/int32 [H,W] or
    [B,H,W] plane.  Returns int32 labels (and an all-True per-plane
    ``converged`` flag when ``with_flag``: union-find is not iterative).
    Any two equal values link, so labels equal the plain fixpoint's for
    values in [0, num_classes)."""
    _kernels.require_cuda("ccl_cuda", img)
    if img.dtype == torch.uint8:
        fn = "pcis_ccl_u8"
    elif img.dtype == torch.int32:
        fn = "pcis_ccl_i32"
    else:
        raise ValueError(f"ccl_cuda: expected uint8 or int32 values, got {img.dtype}")
    if connectivity not in (4, 8):
        raise ValueError(f"ccl_cuda: connectivity must be 4 or 8, got {connectivity}")
    B, H, W = _planes("ccl_cuda", img)
    has_bg = background is not None
    if has_bg and not -(2**31) <= background < 2**31:
        raise ValueError(f"ccl_cuda: background {background} is not an int32")
    lab = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    lib = _kernels.library()
    scratch_len = lib.pcis_ccl_scratch_len(B, H, W)  # the tile-root bit mask
    scratch = torch.empty(scratch_len, dtype=torch.int32, device=img.device)
    with torch.cuda.device(img.device):
        err = getattr(lib, fn)(
            img.data_ptr(), lab.data_ptr(), scratch.data_ptr(), scratch_len,
            B, H, W, connectivity, int(has_bg),
            int(background) if has_bg else 0, _kernels.stream_of(img),
        )
    _kernels.check(err, "ccl_cuda")
    _kernels.count_launch(ccl_cuda)
    if with_flag:
        return lab, torch.ones(img.shape[:-2], dtype=torch.bool, device=img.device)
    return lab


ccl_cuda.launches = 0


def compact_labels_cuda(raw: torch.Tensor, max_regions: int):
    """K3: compact_labels of a contiguous CUDA int32 [H,W] or [B,H,W] label
    plane → (seg int32 like raw, num int32 [B] or scalar)."""
    del max_regions  # num is the true count; callers check it
    _kernels.require_cuda("compact_labels_cuda", raw)
    if raw.dtype != torch.int32:
        raise ValueError(f"compact_labels_cuda: expected int32 labels, got {raw.dtype}")
    B, H, W = _planes("compact_labels_cuda", raw)
    lib = _kernels.library()
    seg = torch.empty_like(raw)
    num = torch.empty(B, dtype=torch.int32, device=raw.device)
    # the root bits with their in-tile word prefixes, then the tile counts
    scratch_len = lib.pcis_compact_scratch_len(B, H, W)
    scratch = torch.empty(scratch_len, dtype=torch.int64, device=raw.device)
    with torch.cuda.device(raw.device):
        err = lib.pcis_compact(
            raw.data_ptr(), seg.data_ptr(), num.data_ptr(), scratch.data_ptr(),
            scratch_len, B, H, W, _kernels.stream_of(raw),
        )
    _kernels.check(err, "compact_labels_cuda")
    _kernels.count_launch(compact_labels_cuda)
    return seg, (num if raw.ndim == 3 else num[0])


compact_labels_cuda.launches = 0
