"""Antialiased cubic resize of a stack of planes: the port's counterpart of
``jax.image.resize(x, (n, n), method="cubic", antialias=True)``.

The JAX package resizes each painted NanoSIMS ROI mask to the acquisition's
size with that call (``models/nanosims.py _resize_acq``), which XLA computes
as an einsum with one weight matrix an axis, outside any Pallas kernel.  So
this is plain PyTorch and no kernel.

**The weights** are ``jax/_src/image/scale.py compute_weight_mat`` for the
Keys cubic (a = −0.5), the kernel widened by in/out when downsampling,
``sample_f = (i + 0.5)·in/out − 0.5``, columns normalised by their sum under
the ``1000·eps`` guard, zeros where ``sample_f`` lies outside
``[−0.5, in − 0.5]``.  They are the bits XLA's CPU compiler makes of that
function, which differ from its op-by-op value in the last place: the
division by the kernel scale becomes a multiply by its float32 reciprocal,
whose products with the kernel's constants are folded; every multiply
feeding an add becomes a fused multiply-add; and the column sums run in
blocks of 32 rows (the middle of the padded range), the block sums in turn.
``weight_matrix`` computes exactly that on the host, in float32 with each
fused multiply-add rounded once (``_fma32``), so the weights are JAX's bit
for bit (``tests/test_torch_nanosims.py`` holds them to ``jax.image.resize``
of an identity).

**The product** follows the einsum's: one axis at a time, each output
sums its taps in increasing input index as a chain of multiply-adds, each
rounded once to float32 as XLA's CPU matmul does with a fused multiply-add.
Here each is separate float64 tensor operations (the float32 product is
exact in float64, the sum is rounded to float64 and then to float32), with
no matmul and no hardware FMA, so the card and the CPU give the same bits.
The rounding through float64 differs from a fused multiply-add's only where
the float64 sum lies exactly on a float32 midpoint.  The axis order is the
einsum's contraction order: rows (axis −2) first unless the plane is wider
than tall.  Against ``jax.image.resize`` a value can still differ in its
last bits (XLA's matmul blocks its sums in ways not reproduced here), within
3.6e-7 for a one-hot mask; ``tests/test_torch_nanosims.py`` counts such
pixels for both axis orders.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["weight_matrix", "axis_order", "resize_cubic"]

def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once, as a fused multiply-add gives it.

    a·b is exact in float64 and the sum's float64 rounding error ``e`` is
    recovered exactly (TwoSum); rounding to float32 then differs from the
    single rounding only when the float64 sum lies on a float32 midpoint,
    where the sign of ``e`` decides."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    up = np.nextafter(r, np.float32(np.inf)).astype(np.float64)
    dn = np.nextafter(r, np.float32(-np.inf)).astype(np.float64)
    rr = r.astype(np.float64)
    r = np.where((d > 0) & (d == (up - rr) / 2) & (e > 0), up.astype(np.float32), r)
    r = np.where((d < 0) & (-d == (rr - dn) / 2) & (e < 0), dn.astype(np.float32), r)
    return r.astype(np.float32)


def _xla_sum(w: np.ndarray) -> np.ndarray:
    """Sum of float32 ``w`` [n, m] over axis 0 in the order of XLA's CPU
    reduction: up to 32 rows in turn; past that, zero-padded to whole blocks
    of 32 rows (the padding split evenly, the extra row at the end), each
    block summed in turn, then the block sums the same way."""
    n = w.shape[0]
    if n <= 32:
        tot = np.zeros(w.shape[1:], np.float32)
        for k in range(n):
            tot = tot + w[k]
        return tot
    pad = -n % 32
    wp = np.concatenate([np.zeros((pad // 2,) + w.shape[1:], np.float32), w,
                         np.zeros((pad - pad // 2,) + w.shape[1:], np.float32)])
    return _xla_sum(np.stack([_xla_sum(blk) for blk in wp.reshape(-1, 32, *w.shape[1:])]))


@functools.lru_cache(maxsize=16)
def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_in, n_out] weights of the antialiased cubic resize of one
    axis, ``out[i] = Σ_j w[j, i]·x[j]``: jax.image.resize's, bit for bit."""
    inv = np.float32(1.0 / (n_out / n_in))  # 1 / scale in float64, then float32
    ks = max(inv, np.float32(1.0))  # the kernel's widening when downsampling
    rcp = np.float32(1.0) / ks
    c_hi = np.float32(1.5) * rcp  # the cubic's constants times 1/ks, folded
    c_lo = np.float32(-0.5) * rcp
    i = np.arange(n_out, dtype=np.float32)
    sample_f = _fma32(i + np.float32(0.5), inv, -0.5)
    d = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    x = d * rcp
    near = _fma32((_fma32(d, c_hi, -2.5) * x).astype(np.float32), x, 1.0)  # |x| < 1
    far = _fma32(_fma32(_fma32(d, c_lo, 2.5), x, -4.0), x, 2.0)  # 1 ≤ |x| < 2
    w = np.where(x >= 2, np.float32(0), np.where(x >= 1, far, near)).astype(np.float32)
    tot = _xla_sum(w)[None, :]
    guard = np.abs(tot) > np.float32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(guard, w / np.where(tot != 0, tot, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(n_in - 0.5))
    w = np.where(inside[None, :], w, np.float32(0)).astype(np.float32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=16)
def _taps(n_in: int, n_out: int):
    """(index [T, n_out] int64, weight [T, n_out] float32): each output's
    taps from its first to its last nonzero weight, in input order; shorter
    runs end in zero weights on the last input."""
    w = weight_matrix(n_in, n_out)
    nz = w != 0
    any_nz = nz.any(axis=0)
    first = np.where(any_nz, nz.argmax(axis=0), 0)
    last = np.where(any_nz, n_in - 1 - nz[::-1].argmax(axis=0), 0)
    T = int((last - first).max()) + 1
    pos = first[None, :] + np.arange(T)[:, None]
    live = pos <= last[None, :]
    idx = np.minimum(pos, n_in - 1)
    tw = np.where(live, w[idx, np.arange(n_out)[None, :]], np.float32(0)).astype(np.float32)
    return idx.astype(np.int64), tw


def _resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = x.shape[axis]
    if n_in == n_out:  # jax.image.resize leaves such an axis alone
        return x
    idx_np, tw_np = _taps(n_in, n_out)
    idx = torch.from_numpy(idx_np).to(x.device)
    tw = torch.from_numpy(tw_np).to(x.device)
    if axis == -2:
        tw = tw[:, :, None]
    tw64 = tw.to(torch.float64)
    out = x.index_select(axis, idx[0]) * tw[0]
    for t in range(1, idx.shape[0]):
        out = (x.index_select(axis, idx[t]).to(torch.float64) * tw64[t]
               + out.to(torch.float64)).to(torch.float32)
    return out


def axis_order(h: int, w: int, size: int):
    """The einsum's contraction order for an [h, w] → [size, size] resize:
    the cheaper first, rows (axis −2) on a tie; an axis left alone costs
    nothing."""
    if h == size or w == size:
        return (-2, -1)
    return (-2, -1) if w <= h else (-1, -2)


def resize_cubic(x: torch.Tensor, size: int, axes=None) -> torch.Tensor:
    """``jax.image.resize(x, (..., size, size), "cubic", antialias=True)`` of
    a float32 [..., H, W] stack, on x's device: weights bit for bit, the
    product in the einsum's order (the same bits on the card and the CPU).
    ``axes`` overrides the order the axes are resized in."""
    if x.dtype != torch.float32:
        raise ValueError(f"resize_cubic: expected float32, got {x.dtype}")
    for axis in axes or axis_order(x.shape[-2], x.shape[-1], size):
        x = _resize_axis(x, axis, size)
    return x
