"""The plateau maxima kernel pair (``csrc/maxima.cu``) after K2.

No TPU kernel's counterpart: the JAX package's ``local_maxima_auto`` rides
K2's band sweeps.  Given K2's labels of a value stack, the pair marks every
component (plateau) with a strictly higher neighbour in a bitset and writes
the unmarked pixels as maxima: ``ops.morphology.local_maxima``'s answer,
bit for bit, with no host sync.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch.ops.ccl_tiles import _planes

__all__ = ["plateau_maxima_cuda"]


def plateau_maxima_cuda(img: torch.Tensor, root: torch.Tensor, connectivity: int = 8):
    """Local maxima of a contiguous CUDA uint8/int32 [H,W] or [B,H,W] stack
    from its K2 labels ``root`` (``ccl_cuda(img, connectivity=connectivity)``):
    a pixel is a maximum iff no pixel of its plateau has a strictly higher
    4- or 8-neighbour.  Returns bool like ``img``."""
    _kernels.require_cuda("plateau_maxima_cuda", img, root)
    if img.dtype == torch.uint8:
        fn = "pcis_plateau_maxima_u8"
    elif img.dtype == torch.int32:
        fn = "pcis_plateau_maxima_i32"
    else:
        raise ValueError(f"plateau_maxima_cuda: expected uint8 or int32 values, got {img.dtype}")
    if root.dtype != torch.int32 or root.shape != img.shape:
        raise ValueError("plateau_maxima_cuda: root must be int32 labels shaped like img")
    if connectivity not in (4, 8):
        raise ValueError(f"plateau_maxima_cuda: connectivity must be 4 or 8, got {connectivity}")
    B, H, W = _planes("plateau_maxima_cuda", img)
    lib = _kernels.library()
    words = lib.pcis_maxima_scratch_len(B, H, W)  # a bit a pixel of the stack
    bits = torch.empty(words, dtype=torch.int32, device=img.device)
    out = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    with torch.cuda.device(img.device):
        err = getattr(lib, fn)(
            img.data_ptr(), root.data_ptr(), bits.data_ptr(), words, out.data_ptr(),
            B, H, W, connectivity, _kernels.stream_of(img),
        )
    _kernels.check(err, "plateau_maxima_cuda")
    _kernels.count_launch(plateau_maxima_cuda, 2)  # mark, then resolve
    return out


plateau_maxima_cuda.launches = 0
