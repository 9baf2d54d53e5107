"""Bounded exact squared Euclidean distance transform (the K9 kernel's plain
version).

Counterpart of ``edt_sq`` and ``_doubling_dist`` in
``particle_col_image_segmentation_tpu/ops/edt.py``, phase for phase:

  phase 1, within each row: capped distance to the nearest feature pixel of
    the same row — 2·cap+1 direct column taps for cap ≤ 8, bounded
    log-doubling min-plus in both directions above that (the two give the
    same ``min(d, cap+1)``);
  phase 2, across rows: ``d²(r, c) = min over |dy| ≤ cap of dy² + dh(r+dy, c)²``,
    rows outside the plane being featureless.

Exact wherever the true distance ≤ cap; larger distances give a value in
(cap², (cap+1)²], (cap+1)² where no feature is within cap rows.  So ``edt_sq(mask, r) ≤ r²`` is exactly ``binary_dilation(mask,
disk(r))``, and any threshold ≤ cap² is exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["edt_sq"]


def edt_sq(feature: torch.Tensor, cap: int) -> torch.Tensor:
    """Squared distance to the nearest True pixel of ``feature`` [..., H, W]
    as int32; exact for distances ≤ cap, larger ones give a value in
    (cap², (cap+1)²]."""
    if cap < 0:
        raise ValueError(f"edt_sq: cap must be >= 0, got {cap}")
    feature = feature != 0
    c1 = cap + 1
    H, W = feature.shape[-2:]
    if cap <= 8:
        fpad = F.pad(feature.to(torch.uint8), (cap, cap)).bool()
        dh = torch.full(feature.shape, c1, dtype=torch.int32, device=feature.device)
        for dx in range(-cap, cap + 1):
            tap = fpad[..., cap + dx : cap + dx + W]
            dh = torch.where(tap, torch.clamp(dh, max=abs(dx)), dh)
    else:
        d0 = torch.where(feature, 0, c1).to(torch.int32)
        dh = torch.minimum(
            _doubling_dist(d0, c1, backward=False),
            _doubling_dist(d0, c1, backward=True),
        )
    inf = c1 * c1
    dp = F.pad(dh * dh, (0, 0, cap, cap), value=inf)
    out = torch.full(feature.shape, inf, dtype=torch.int32, device=feature.device)
    for dy in range(-cap, cap + 1):
        out = torch.minimum(out, dp[..., cap + dy : cap + dy + H, :] + dy * dy)
    return torch.clamp(out, max=inf)


def _doubling_dist(d0: torch.Tensor, c1: int, backward: bool) -> torch.Tensor:
    """Bounded 1-D distance along the last axis by log-doubling min-plus:
    after the round with shift s, ``d[i] = min_{0 ≤ t < 2s} d0[i∓t] + t``,
    so ⌈log2 c1⌉ rounds cover every offset < c1; the clamp does the rest."""
    W = d0.shape[-1]
    d = d0
    s = 1
    while s < c1:
        if backward:
            shifted = F.pad(d, (0, s), value=c1)[..., s : W + s]
        else:
            shifted = F.pad(d, (s, 0), value=c1)[..., :W]
        d = torch.minimum(d, shifted + s)
        s *= 2
    return torch.clamp(d, max=c1)
