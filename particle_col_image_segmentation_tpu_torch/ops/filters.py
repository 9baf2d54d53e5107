"""Plain median filter of label planes (the K1 kernel's reference version).

Counterpart of ``particle_col_image_segmentation_tpu/ops/filters.py``
(``median_label_filter`` and its threshold-packing helpers).  The median of
an integer window with values < K comes from cumulative class counts:

    median = #{ v < K-1 : count(window ≤ v) < ⌈n/2⌉ }

so values ≥ K-1 clamp to K-1.  Thresholds are bit-packed several to an int32
plane (fields of ⌈log2(size²+1)⌉ bits, which no window count can overflow),
and one separable box sum counts a whole group.
"""

from __future__ import annotations

import torch

__all__ = ["median_label_filter"]


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
    H, W = img.shape[-2:]
    half = size // 2
    half_rank = (size * size) // 2 + 1
    bits, groups = _threshold_packing(size, num_classes)
    x = img.to(torch.int32)
    x = x.index_select(-2, reflect_index(H, half, img.device))
    x = x.index_select(-1, reflect_index(W, half, img.device))
    med = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    for group in groups:
        packed = pack_thresholds(x, group, bits)
        counts = _valid_window_sum(_valid_window_sum(packed, size, -1), size, -2)
        med = median_from_counts(med, counts, group, bits, half_rank)
    return med.to(img.dtype)
