"""Plain median filter of label planes (the K1 kernel's reference version),
and the Gaussian blur: its two forms (op by op as eager JAX rounds it, or
contracted into FMAs as ``jax.jit``'s XLA code rounds it), their plain
version and the dispatch to the blur kernel (``blur_tiles``).

Counterpart of ``particle_col_image_segmentation_tpu/ops/filters.py``
(``median_label_filter``, ``median_label_filter_padded`` and the
threshold-packing helpers, ``gaussian_blur``).  The median of
an integer window with values < K comes from cumulative class counts:

    median = #{ v < K-1 : count(window ≤ v) < ⌈n/2⌉ }

so values ≥ K-1 clamp to K-1.  Thresholds are bit-packed several to an int32
plane (fields of ⌈log2(size²+1)⌉ bits, which no window count can overflow),
and one separable box sum counts a whole group.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.blur_tiles import (
    gaussian_blur_cuda,
    gaussian_taps,
)
from particle_col_image_segmentation_tpu_torch.ops.rounding import fma_f32

__all__ = [
    "as_float32",
    "blur_plain",
    "gaussian_blur",
    "median_label_filter",
    "median_label_filter_padded",
    "median_label_filter_rows_padded",
]

# dtypes the float32 cast takes: those the JAX package's astype(jnp.float32)
# takes without x64, plus torch.uint16
_REAL = (torch.uint8, torch.int8, torch.int16, torch.uint16, torch.int32,
         torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _threshold_packing(size: int, num_classes: int):
    """(bits per field, threshold groups per int32 plane)."""
    bits = max(1, (size * size).bit_length())
    per = max(1, 31 // bits)
    thresholds = list(range(num_classes - 1))
    groups = [thresholds[i : i + per] for i in range(0, len(thresholds), per)]
    return bits, groups


def pack_thresholds(x: torch.Tensor, group, bits: int) -> torch.Tensor:
    """One packed indicator plane: ``Σ_pos (x ≤ v_pos) << (bits·pos)``."""
    packed = torch.zeros_like(x, dtype=torch.int32)
    for pos, v in enumerate(group):
        packed += (x <= v).to(torch.int32) << (bits * pos)
    return packed


def median_from_counts(med, counts: torch.Tensor, group, bits: int, half_rank: int):
    """Fold one group's packed window counts into the median accumulator:
    median = #{v : count(window ≤ v) < half_rank}."""
    fmask = (1 << bits) - 1
    for pos in range(len(group)):
        t = (((counts >> (bits * pos)) & fmask) < half_rank).to(torch.int32)
        med = t if med is None else med + t
    return med


def reflect_index(n: int, half: int, device) -> torch.Tensor:
    """Source index of each position of a ``half``-padded axis of length n
    under scipy 'reflect' (numpy 'symmetric': -1 → 0, -2 → 1, n → n-1),
    periodic with period 2n so any ``half`` works."""
    i = torch.arange(-half, n + half, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def _valid_window_sum(xp: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Windowed sum of a padded array: length shrinks by size-1 along axis."""
    n = xp.shape[axis] - (size - 1)
    out = xp.narrow(axis, 0, n).clone()
    for o in range(1, size):
        out += xp.narrow(axis, o, n)
    return out


def median_label_filter(img: torch.Tensor, size: int = 5, num_classes: int = 8) -> torch.Tensor:
    """scipy.ndimage.median_filter(img, size, mode='reflect') for integer
    planes with values in [0, num_classes), on any [..., H, W] batch and any
    odd ``size``; same dtype and device as ``img``."""
    H = img.shape[-2]
    x = img.index_select(-2, reflect_index(H, size // 2, img.device))
    return median_label_filter_rows_padded(x, size, num_classes)


def median_label_filter_padded(
    xp: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """Median filter of an input already padded by size//2 on both trailing
    axes: [..., H + 2·half, W + 2·half] → [..., H, W], same dtype."""
    half_rank = (size * size) // 2 + 1
    bits, groups = _threshold_packing(size, num_classes)
    x = xp.to(torch.int32)
    med = None
    for group in groups:
        packed = pack_thresholds(x, group, bits)
        counts = _valid_window_sum(_valid_window_sum(packed, size, -1), size, -2)
        med = median_from_counts(med, counts, group, bits, half_rank)
    if med is None:  # one class: every median is 0
        half = size // 2
        shape = xp.shape[:-2] + (xp.shape[-2] - 2 * half, xp.shape[-1] - 2 * half)
        return torch.zeros(shape, dtype=xp.dtype, device=xp.device)
    return med.to(xp.dtype)


def median_label_filter_rows_padded(
    xp: torch.Tensor, size: int = 5, num_classes: int = 8
) -> torch.Tensor:
    """The plain version of K1's band mode: a band padded by size//2 rows
    above and below (its neighbours' rows, or reflected rows at the plane's
    edges), [..., h + 2·half, W] → [..., h, W]; the columns reflect as
    scipy's 'reflect'."""
    W = xp.shape[-1]
    return median_label_filter_padded(
        xp.index_select(-1, reflect_index(W, size // 2, xp.device)), size, num_classes
    )


def as_float32(img: torch.Tensor) -> torch.Tensor:
    """``img.astype(jnp.float32)``: uint8, int8, int16, uint16, int32,
    float16, bfloat16, float32 or float64, on img's device (exact for every
    integer value here).  A torch.uint16 tensor is read through its int16
    view, since few ops take uint16 on the card."""
    if img.dtype not in _REAL:
        raise ValueError(f"expected one of {[str(d) for d in _REAL]}, got {img.dtype}")
    if img.dtype == torch.uint16:
        return img.view(torch.int16).to(torch.int32).bitwise_and_(0xFFFF).to(torch.float32)
    return img.to(torch.float32)


def _taps(xp: torch.Tensor, k, axis: int, n: int) -> torch.Tensor:
    """Σ_o xp[o : o + n] · k[o] along axis, in tap order: one float32
    multiply and one add a tap."""
    out = xp.narrow(axis, 0, n) * float(k[0])
    for o in range(1, len(k)):
        out += xp.narrow(axis, o, n) * float(k[o])
    return out


def _taps_fma(xp: torch.Tensor, k, axis: int, n: int) -> torch.Tensor:
    """The same sum as XLA's CPU code contracts it: fma(x₀, k₀, fl(x₁·k₁)),
    then fma(x_o, k_o, acc) for every tap o ≥ 2, each rounded once."""
    out = fma_f32(xp.narrow(axis, 0, n), k[0], xp.narrow(axis, 1, n) * float(k[1]))
    for o in range(2, len(k)):
        out = fma_f32(xp.narrow(axis, o, n), k[o], out)
    return out


def blur_plain(x: torch.Tensor, k, fma: bool = False) -> torch.Tensor:
    """The plain version of the blur kernel: float32 [..., H, W] x through
    the taps k, replicate padding, columns (axis -2) first, then rows, with
    float32 between the passes; each tap sum op by op, or contracted into
    FMAs (``_taps_fma``) where ``fma``."""
    taps = _taps_fma if fma else _taps
    half = len(k) // 2
    H, W = x.shape[-2:]
    # edge replication commutes with the per-axis sums: pad each axis just
    # before its own pass
    rows = torch.arange(-half, H + half, device=x.device).clamp_(0, H - 1)
    x = taps(x.index_select(-2, rows), k, -2, H)
    cols = torch.arange(-half, W + half, device=x.device).clamp_(0, W - 1)
    return taps(x.index_select(-1, cols), k, -1, W)


def gaussian_blur(img: torch.Tensor, sigma: float, *, fma: bool = False) -> torch.Tensor:
    """MATLAB imgaussfilt parity: separable Gaussian, kernel 2·ceil(2σ)+1,
    replicate ('nearest') padding; float32 [..., H, W] on img's device (any
    dtype ``as_float32`` takes).

    Both forms take normalised float64 taps rounded to float32
    (``gaussian_taps``) and sum columns (axis -2) first, then rows, each
    output the taps in order, with float32 between the two passes.  They
    differ in how a tap's multiply meets the add:

    - ``fma=False`` (the default) rounds every product and every sum on its
      own: the JAX package's ``gaussian_blur`` called op by op, as
      ``models/nanosims.py`` calls it, bit for bit.  NanoSIMS takes it.
    - ``fma=True`` rounds as ``jax.jit(gaussian_blur)`` on the CPU, whose
      XLA code contracts the chain into FMAs:
      ``acc = fma(x₀, k₀, fl(x₁·k₁))``, then ``acc = fma(x_o, k_o, acc)``
      for every tap o ≥ 2, bit for bit.  Config #2 takes it, as bench.py
      jits its ``stack_stats``.

    A CUDA tensor on a Hopper card takes the blur kernel
    (``blur_tiles.gaussian_blur_cuda``, uint16 and float32 read as they
    lie, other dtypes cast first), which holds ceil(2σ) ≤ 64 (σ ≤ 32) and
    raises a ValueError past it; any other GPU raises.  A CPU tensor takes
    the plain version (``blur_plain``, the contracted form through
    ``ops.rounding.fma_f32``)."""
    if use_kernel(img):
        x = img if img.dtype in (torch.uint16, torch.float32) else as_float32(img)
        if not x.is_contiguous():  # uint16 through its int16 view: few ops take uint16
            x = (x.view(torch.int16).contiguous().view(torch.uint16)
                 if x.dtype == torch.uint16 else x.contiguous())
        return gaussian_blur_cuda(x, sigma, fma=fma)
    return blur_plain(as_float32(img), gaussian_taps(sigma), fma)
