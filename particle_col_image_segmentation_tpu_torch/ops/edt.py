"""Squared Euclidean distance transforms: the bounded one (the K9 kernel's
plain version) and the exact one.

Counterpart of ``edt_sq``, ``_doubling_dist``, ``row_dh2_exact``,
``minplus_rows``, ``edt_sq_exact`` and ``edt_exact`` in
``particle_col_image_segmentation_tpu/ops/edt.py``.  The bounded transform,
phase for phase:

  phase 1, within each row: capped distance to the nearest feature pixel of
    the same row — 2·cap+1 direct column taps for cap ≤ 8, bounded
    log-doubling min-plus in both directions above that (the two give the
    same ``min(d, cap+1)``);
  phase 2, across rows: ``d²(r, c) = min over |dy| ≤ cap of dy² + dh(r+dy, c)²``,
    rows outside the plane being featureless.

Exact wherever the true distance ≤ cap; larger distances give a value in
(cap², (cap+1)²], (cap+1)² where no feature is within cap rows.  So ``edt_sq(mask, r) ≤ r²`` is exactly ``binary_dilation(mask,
disk(r))``, and any threshold ≤ cap² is exact.

The exact transform takes each row's exact distance to its nearest feature,
then the full min-plus over all source rows, ``out[r, c] = min_j dh²(j, c) +
(r − j)²`` — O(H²·W), in tensor code chunked over source rows on every
device (the JAX package, too, leaves it to XLA).  ``ops.edt_tiles.
edt_sq_exact_auto`` runs it only where the capped transform cannot certify
itself exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["edt_sq", "edt", "row_dh2_exact", "minplus_rows", "edt_sq_exact", "edt_exact",
           "sqrt_f32"]


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


def edt(feature: torch.Tensor, cap: int) -> torch.Tensor:
    """Float32 distance to the nearest nonzero pixel of ``feature``, exact up
    to ``cap`` (past it, a value in (cap, cap + 1]): the root of the capped
    int32 d², so K9 on a CUDA tensor and the plain transform on the CPU."""
    # ops.edt_tiles imports this module, so it is imported here
    from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_auto

    if feature.dtype not in (torch.bool, torch.uint8):
        feature = feature != 0
    return sqrt_f32(edt_sq_auto(feature.contiguous(), cap))


def row_dh2_exact(feature: torch.Tensor, inf: int) -> torch.Tensor:
    """Per-row squared distance to the nearest feature pixel of the same row
    (int32); ``inf`` on featureless rows, so that they add +inf to the
    min-plus and never a finite (W+1)² candidate."""
    feature = feature != 0
    W = feature.shape[-1]
    capw = W + 1
    idx = torch.arange(W, dtype=torch.int32, device=feature.device)
    last = torch.cummax(torch.where(feature, idx, -capw), dim=-1).values
    nxt = torch.flip(
        torch.cummin(torch.flip(torch.where(feature, idx, 2 * capw), (-1,)), dim=-1).values,
        (-1,),
    )
    dh = torch.minimum(idx - last, nxt - idx).clamp(max=capw)
    return torch.where(dh >= capw, inf, dh * dh).to(torch.int32)


def minplus_rows(dh2_src: torch.Tensor, r_idx: torch.Tensor, inf: int,
                 rows_per_step: int = 8) -> torch.Tensor:
    """``out[..., i, c] = min_j dh2_src[..., j, c] + (r_idx[i] − j)²`` over
    ALL source rows j, ``rows_per_step`` source rows at a time."""
    Hs, W = dh2_src.shape[-2:]
    r_idx = r_idx.to(torch.int32)
    out = torch.full(dh2_src.shape[:-2] + (r_idx.shape[0], W), inf,
                     dtype=torch.int32, device=dh2_src.device)
    for j0 in range(0, Hs, rows_per_step):
        rows = dh2_src[..., j0:j0 + rows_per_step, :]  # [..., C, W]
        j = torch.arange(j0, j0 + rows.shape[-2], dtype=torch.int32, device=dh2_src.device)
        dy = r_idx[None, :] - j[:, None]  # [C, Hout]
        cand = rows[..., :, None, :] + (dy * dy)[:, :, None]  # [..., C, Hout, W]
        out = torch.minimum(out, cand.amin(dim=-3))
    return out


def edt_sq_exact(feature: torch.Tensor, rows_per_step: int = 8) -> torch.Tensor:
    """Exact (uncapped) squared EDT of [..., H, W] as int32.  Pixels of a
    plane without any feature get (H+W+2)²."""
    H, W = feature.shape[-2:]
    inf = (H + W + 2) * (H + W + 2)
    dh2 = row_dh2_exact(feature, inf)
    return minplus_rows(
        dh2, torch.arange(H, dtype=torch.int32, device=feature.device), inf,
        rows_per_step,
    )


def sqrt_f32(d2: torch.Tensor) -> torch.Tensor:
    """``sqrt(float32(d2))`` as float32, correctly rounded: the value
    ``jnp.sqrt(d2.astype(float32))`` gives, on every device.

    ``d2`` is rounded to float32 first, so a d² past 2²⁴ rounds as it does
    in the JAX package.  PyTorch's float32 square root on the CPU is not
    correctly rounded on every build (its vectorised kernel can miss by one
    ulp, e.g. √19 and √37), so there the root is taken in float64 and
    rounded once to float32.  That is exact: float64 carries 53 ≥ 2·24 + 2
    bits, so the double rounding of the square root of a float32 can never
    differ from the correctly rounded float32 root.  On the card float32
    ``torch.sqrt`` is IEEE round-to-nearest (``sqrt.rn``), one elementwise
    pass, and ``chip_smoke.py`` holds it to numpy's root for every d² below
    2²⁴."""
    x = d2.to(torch.float32)
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def edt_exact(feature: torch.Tensor) -> torch.Tensor:
    """Exact float32 EDT (scipy.ndimage.distance_transform_edt parity)."""
    return sqrt_f32(edt_sq_exact(feature))
