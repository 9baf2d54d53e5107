"""The Gaussian blur's kernel wrapper and its taps.

``csrc/blur.cu`` runs both forms of ``ops.filters.gaussian_blur`` on the
card, chosen by ``fma``: the op-by-op form (eager JAX) and the contracted
form (``jax.jit`` on XLA's CPU code).  It ports no TPU kernel: the JAX
package leaves the blur to XLA.  It equals its plain version
(``filters.blur_plain``) bit for bit in both forms.  The C entry picks its
route from the half-width ceil(2σ) alone: a register ring up to 5 (σ ≤
2.5, config #2's and NanoSIMS's σ), a shared-memory window past it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch import _kernels

__all__ = ["MAX_HALF", "gaussian_blur_cuda", "gaussian_taps"]

# the widest kernel the shared window's tile takes: half = ceil(2σ) ≤ 64,
# σ ≤ 32, 129 taps (csrc/blur.cu kMaxHalf)
MAX_HALF = 64


@functools.lru_cache(maxsize=64)
def gaussian_taps(sigma: float) -> np.ndarray:
    """MATLAB imgaussfilt's 2·ceil(2σ)+1 taps: float64 ``exp``, normalised,
    then rounded to float32 (a read-only array)."""
    half = int(np.ceil(2 * sigma))
    xs = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    k.setflags(write=False)
    return k


def gaussian_blur_cuda(img: torch.Tensor, sigma: float, *, fma: bool = False) -> torch.Tensor:
    """The blur kernel on a contiguous uint16 or float32 [..., H, W] CUDA
    tensor → float32 [..., H, W] on its device, equal to
    ``filters.blur_plain(img, gaussian_taps(sigma), fma)`` bit for bit.
    uint16 pixels are read as they lie (2 B a pixel); any other dtype goes
    through ``as_float32`` first (``gaussian_blur`` does that).  Raises a
    ValueError past ``MAX_HALF``: ceil(2σ) ≤ 64, i.e. σ ≤ 32."""
    if img.dtype not in (torch.uint16, torch.float32):
        raise ValueError(f"gaussian_blur_cuda: expected uint16 or float32, got {img.dtype}")
    if img.ndim < 2 or img.numel() == 0:
        raise ValueError(
            f"gaussian_blur_cuda: expected a non-empty [..., H, W] tensor, got {tuple(img.shape)}"
        )
    if not (sigma > 0 and math.isfinite(sigma)):
        raise ValueError(f"gaussian_blur_cuda: sigma must be finite and > 0, got {sigma}")
    k = gaussian_taps(sigma)
    half = len(k) // 2
    if half > MAX_HALF:
        raise ValueError(
            f"gaussian_blur_cuda: sigma {sigma} needs ceil(2·sigma) = {half} > {MAX_HALF}, "
            f"the tile's limit (sigma ≤ {MAX_HALF // 2})"
        )
    H, W = img.shape[-2:]
    B = img.numel() // (H * W)
    if H * W >= 2**31 or B >= 2**31:
        raise ValueError(
            f"gaussian_blur_cuda: {tuple(img.shape)} exceeds int32 planes or plane indices"
        )
    _kernels.require_cuda("gaussian_blur_cuda", img)
    out = torch.empty(img.shape, dtype=torch.float32, device=img.device)
    # uint16 through its int16 view: the kernel reads the bits as unsigned
    src = img.view(torch.int16) if img.dtype == torch.uint16 else img
    taps = (ctypes.c_float * len(k))(*k.tolist())
    lib = _kernels.library()
    with torch.cuda.device(img.device):
        err = lib.pcis_gaussian_blur(
            src.data_ptr(), int(img.dtype == torch.uint16), out.data_ptr(), B, H, W, taps,
            len(k), int(bool(fma)), _kernels.stream_of(img),
        )
    _kernels.check(err, "gaussian_blur_cuda")
    _kernels.count_launch(gaussian_blur_cuda)
    return out


gaussian_blur_cuda.launches = 0
