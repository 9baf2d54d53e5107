"""Float32 multiply-adds rounded once, as a fused multiply-add rounds them.

The JAX package's jitted CPU code is compiled by XLA, which contracts a
float32 multiply feeding an add into one fused multiply-add (FMA): the
nearest-neighbour distances' ``Σ diff²`` comes out as
``fma(d₁, d₁, fl(d₀·d₀))`` and the Otsu bin centres' ``lo + t / bins`` as
``fma(t, fl(1 / bins), lo)``.  Eager PyTorch rounds the product and the sum
separately on every device, so the port computes such a value with
``fma_f32``: tensor code in float64 and int64, one elementwise op at a time,
which no device contracts, so the card gives the CPU's bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma_f32"]


def _wide(v):
    """A float32 operand, exactly, in float64: a tensor stays on its device,
    a number becomes a Python float (a scalar operand, where a tensor made
    from it on the card would cost a copy that waits for the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).to(torch.float64)
    return float(np.float32(v))


def fma_f32(a, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once to nearest even, broadcast, on the
    device of the tensors given (at least one operand is a tensor; each is
    cast to float32 first).

    ``a·b`` is exact in float64 (24 + 24 significant bits), and the float64
    sum ``s`` with its exact error ``e`` (TwoSum) is rounded to odd: where
    ``e`` is not 0 and ``s``'s last bit is even, ``s`` steps one float64 ulp
    toward ``e``.  A value rounded to odd with 53 ≥ 24 + 2 bits rounds to
    float32 as the exact sum would; a plain float64 sum rounds twice, which
    goes wrong where it lands on a float32 midpoint.  Where ``s`` is not
    finite (an infinite or NaN operand), ``e`` is NaN and ``s`` is the
    FMA's result already: ±inf, or NaN for inf·0, inf − inf and NaN."""
    a, b, c = _wide(a), _wide(b), _wide(c)
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    step = (e.abs() > 0) & ((s.view(torch.int64) & 1) == 0)  # NaN compares false
    s = torch.where(step, torch.nextafter(s, e * math.inf), s)
    return s.to(torch.float32)
