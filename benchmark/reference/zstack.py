"""Plain reference of config #2's call (``models.zstack.zstack_stats_device``).

From the staged uint16 [P, H, W] stack alone, in blocks of ``BLOCK``
planes, on any device:

- Taps: MATLAB imgaussfilt's 2·ceil(2σ) + 1 Gaussian taps, normalised in
  float64, then rounded to float32.
- Blur: replicate padding; columns (axis −2) first, then rows, float32
  between the passes; each output the tap chain as ``jax.jit`` of the
  upstream recipe's blur contracts it on the CPU, ``fma(x₀, k₀, fl(x₁·k₁))``,
  then ``fma(x_o, k_o, acc)`` for every tap o ≥ 2.  The FMA (``fma``) is
  built here from its definition: the product exact in float64, the
  float64 sum rounded to odd, then one rounding to float32.
- Histogram: ``bins`` bins over each plane's [min, max], span = max(max −
  min, 1e-12); a pixel's bin clip(int32((x − lo) / span · bins), 0,
  bins − 1), each step in float32; bin centres
  fma(fl((i + 0.5)·span), fl(1 / bins), lo).
- Otsu: the first bin whose centre maximises the between-class variance
  (w₀·w₁)·(μ₀ − μ₁)², −1 where a class is empty, with w₀ and the first
  moment m the prefix sums of the counts and of count·centre.  The prefix
  sums follow one fixed order (``prefix_sum``): up to 16 entries one after
  another; past that, each block of 16 in order, plus the prefix sum, by
  the same rule, of the block totals before it.  ``torch.cumsum`` would
  not do: it sums in another order on each device (in sequence on the
  CPU, a parallel scan on the card), float32 addition is not associative,
  and a sum that differs in its last bit can move Otsu's argmax between
  two cuts that tie within rounding.
- Labels and counts: mask = den > t; the 8-connected components of the
  2-class mask with the background labelled too (``plain.ccl``), numbered
  in raster order (``plain.compact``); each id's area and class up to
  ``max_regions`` (ids past it dropped); ``count``, the foreground
  regions with area ≥ ``min_area``, and ``num_fg``, all of them.

Departures from the published recipe (``split_zstack.py`` and
``tiff_analysis.py`` run scipy/skimage in float64 on the host): float32
throughout, the contracted blur of the jitted graph, and the prefix sums'
fixed order, as the program states them; skimage's ``threshold_otsu``
takes the same 256 bins and centres.  ``control=True`` blurs and
thresholds in bfloat16, one precision below the float32 the
configuration states (no FMA, each product and sum rounded to bfloat16);
the labels stay int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import plain

BLOCK = 5  # planes a block: a tenth of the cell's stack, so the float64 blur stays small
SCAN_BLOCK = 16


def taps(sigma: float) -> np.ndarray:
    """float32 taps: exp(−x²/(2σ²)) over x in [−h, h], h = ceil(2σ),
    normalised in float64."""
    half = math.ceil(2 * sigma)
    xs = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a·b + c rounded once, for float32 tensors a and c and a
    float32 number b: a·b is exact in float64 (24 + 24 significant bits);
    the float64 sum s = fl(a·b + c) and its error e (Knuth's two-sum) give
    the sum rounded to odd, s itself where e is 0 or s's last bit is odd,
    else s one float64 ulp toward e; a value rounded to odd at 53 bits
    rounds to float32 as the exact sum does."""
    prod = a.to(torch.float64) * float(np.float32(b))
    c64 = c.to(torch.float64)
    s = prod + c64
    c_part = s - prod
    e = (prod - (s - c_part)) + (c64 - c_part)
    toward = torch.where(e > 0, math.inf, -math.inf).to(torch.float64)
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).to(torch.float32)


def _pass(x: torch.Tensor, k, axis: int, control: bool) -> torch.Tensor:
    """One axis of the blur on a replicate-padded block."""
    n = x.shape[axis] - (len(k) - 1)
    tap = [x.narrow(axis, o, n) for o in range(len(k))]
    if control:
        out = tap[0] * float(k[0])
        for o in range(1, len(k)):
            out = out + tap[o] * float(k[o])
        return out
    out = fma(tap[0], k[0], tap[1] * float(k[1]))
    for o in range(2, len(k)):
        out = fma(tap[o], k[o], out)
    return out


def blur(x: torch.Tensor, sigma: float, control: bool) -> torch.Tensor:
    """The blurred block, float32 (bfloat16 with ``control``)."""
    k = taps(sigma)
    if control:
        k = torch.from_numpy(k).to(torch.bfloat16).tolist()
    half = len(k) // 2
    H, W = x.shape[-2:]
    rows = torch.arange(-half, H + half, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-half, W + half, device=x.device).clamp(0, W - 1)
    x = _pass(x.index_select(-2, rows), k, -2, control)
    return _pass(x.index_select(-1, cols), k, -1, control)


def prefix_sum(c: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis in the fixed order of the
    module docstring, one addition at a time."""
    n = c.shape[-1]
    out = torch.empty_like(c)
    if n <= SCAN_BLOCK:
        acc = c[..., 0] + 0.0
        out[..., 0] = acc
        for i in range(1, n):
            acc = acc + c[..., i]
            out[..., i] = acc
        return out
    starts = range(0, n, SCAN_BLOCK)
    for s in starts:
        out[..., s:s + SCAN_BLOCK] = prefix_sum(c[..., s:s + SCAN_BLOCK])
    totals = torch.stack([out[..., min(s + SCAN_BLOCK, n) - 1] for s in starts], dim=-1)
    carry = prefix_sum(totals)
    for j, s in enumerate(starts):
        if j:
            out[..., s:s + SCAN_BLOCK] = out[..., s:s + SCAN_BLOCK] + carry[..., j - 1:j]
    return out


def otsu(x: torch.Tensor, bins: int) -> torch.Tensor:
    """Each plane's Otsu threshold of a float [B, H, W] block, in its
    dtype."""
    dt = x.dtype
    lo = x.amin(dim=(-2, -1), keepdim=True)
    span = torch.clamp_min(x.amax(dim=(-2, -1), keepdim=True) - lo, 1e-12)
    idx = ((x - lo) / span * bins).to(torch.int32).clamp(0, bins - 1)
    counts = plain.binned_sums(idx, None, bins - 1).to(dt)
    i = torch.arange(bins, device=x.device, dtype=dt)
    lo, span = lo[..., 0], span[..., 0]
    if dt == torch.float32:
        centres = fma((i + 0.5) * span, np.float32(1) / np.float32(bins), lo)
    else:
        centres = (i + 0.5) * span * (1 / bins) + lo
    w0 = prefix_sum(counts)
    m = prefix_sum(counts * centres)
    w1 = w0[..., -1:] - w0
    mu0 = m / torch.clamp_min(w0, 1e-12)
    mu1 = (m[..., -1:] - m) / torch.clamp_min(w1, 1e-12)
    d = mu0 - mu1
    var_b = torch.where((w0 > 0) & (w1 > 0), w0 * w1 * (d * d), -1.0)
    first = torch.where(var_b == var_b.amax(-1, keepdim=True),
                        torch.arange(bins, device=x.device), bins).amin(-1, keepdim=True)
    return torch.gather(centres, -1, first)[..., 0]


def compute(x: torch.Tensor, options: dict, control: bool = False, full: bool = False):
    """(readback, held): the call's per-plane answers as NumPy arrays (the
    thresholds as their float32 bits), and, with ``full``, its blurred
    stack, seg and tables as tensors."""
    R, min_area = options["max_regions"], options["min_area"]
    rows = {k: [] for k in ("threshold_bits", "count", "num_fg", "num_total", "converged")}
    held = {k: [] for k in ("den", "seg", "areas", "classes")}
    for b0 in range(0, x.shape[0], BLOCK):
        block = x[b0:b0 + BLOCK].view(torch.int16).to(torch.int32).bitwise_and(0xFFFF)
        block = block.to(torch.bfloat16 if control else torch.float32)
        den = blur(block, options["sigma"], control)
        t = otsu(den, options["bins"])
        mask = den > t[:, None, None]
        raw, converged = plain.ccl(mask.to(torch.uint8), 8, None, torch.int32)
        seg, num = plain.compact(raw, torch.int32)
        area = plain.binned_sums(seg, None, R)
        classes = torch.div(plain.binned_sums(seg, mask, R), area.clamp(min=1),
                            rounding_mode="floor")
        fg = (classes == 1) & (area > 0)
        rows["threshold_bits"].append(t.to(torch.float32).view(torch.int32))
        rows["count"].append((fg & (area >= min_area)).sum(-1))
        rows["num_fg"].append(fg.sum(-1))
        rows["num_total"].append(num)
        rows["converged"].append(torch.full_like(num, int(converged)))
        if full:
            held["den"].append(den.to(torch.float32))
            held["seg"].append(seg)
            held["areas"].append(area.to(torch.int32))
            held["classes"].append(classes.to(torch.int32))
    readback = {k: torch.cat(v).cpu().numpy().astype(np.int64) for k, v in rows.items()}
    return readback, ({k: torch.cat(v) for k, v in held.items()} if full else None)
