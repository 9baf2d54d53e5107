"""Intensity thresholding (BASELINE config #1: Otsu threshold + CCL count).

Counterpart of ``particle_col_image_segmentation_tpu/ops/threshold.py``:
classic Otsu on a per-plane 256-bin histogram over the plane's [min, max]
range (skimage.filters.threshold_otsu binning), float32 throughout, as the
JAX package computes it without x64, then a connected-components count of
the foreground.

On a CUDA tensor the histogram is K4's fused route (``bin_histogram_cuda``:
each pixel binned and counted in one pass, where the JAX package passes bin
ids and uint8 zeros to K4 on the TPU), and the count runs through K2, K3
and K4; on a CPU tensor each step is its plain version (``bin_histogram``:
the bin ids and one ``bincount`` over the planes' offset ids, the plain CCL
fixpoint, compaction and tables).  Outputs stay on the input's device.

The Otsu prefix sums are summed in one fixed order on every device
(``_prefix_sum``): blocks of 16 bins in order, then each block plus the
running total of the blocks before it, that total taken by the same rule.
That is the order XLA's CPU backend sums ``jnp.cumsum`` in, so thresholds
equal the JAX package's on the CPU bit for bit and the card's equal the
CPU's; ``torch.cumsum`` sums in another order on each device, and a float32
sum of ``count · centre`` in another order can move Otsu's argmax between
two cuts that tie within rounding.

``threshold_and_count_batch`` and config #2's
``models.zstack.zstack_stats_device`` share one body
(``_threshold_and_count_planes``): the histogram once a call, the Otsu
reduction, the mask, CCL, compaction, tables and counts, a span a step
(``pcis.threshold.otsu``, ``.ccl``, ``.compact``, ``.counts``) and no host
sync on the card.  On the card every Otsu threshold (``_otsu_batch``)
replays its reduction (bin centres, prefix sums, argmax: some 75 launches
on a few values a plane) as one CUDA graph (``_otsu_graphed``), so that
the host's launches no longer pace the card; the graph holds the same
kernels, so the thresholds keep their bits.

Inputs are [H, W] (``histogram``, ``otsu_threshold``,
``threshold_and_count``) or [B, H, W] (the batched functions) of any dtype
``filters.as_float32`` takes: uint8, int8, int16, uint16 (torch.uint16),
int32, float16, bfloat16, float32 or float64, cast to float32 first.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.ccl import (
    compact_labels_auto,
    connected_components_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.filters import as_float32
from particle_col_image_segmentation_tpu_torch.ops.histogram_tiles import (
    bin_histogram,
    bin_histogram_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import region_counts_auto
from particle_col_image_segmentation_tpu_torch.ops.rounding import fma_f32
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

__all__ = [
    "histogram",
    "otsu_threshold",
    "otsu_threshold_batch",
    "threshold_and_count",
    "threshold_and_count_batch",
]

_SCAN_BLOCK = 16  # bins XLA's CPU backend sums in order before carrying totals


def _value_range(x3: torch.Tensor):
    """(lo, span) of each plane, keepdims: span = max(hi − lo, 1e-12)."""
    lo = x3.amin(dim=(-2, -1), keepdim=True)
    hi = x3.amax(dim=(-2, -1), keepdim=True)
    return lo, torch.clamp_min(hi - lo, 1e-12)


def _centers(lo, span, bins: int) -> torch.Tensor:
    """Bin centres lo + (i + 0.5) · span / bins as the JAX package's jitted
    entry points compute them on the CPU: XLA turns the division by the
    constant ``bins`` into a product with its float32 reciprocal and fuses
    that with the add, fma(fl((i + 0.5) · span), fl(1 / bins), lo).  The
    same bits on every device and at any ``bins`` (at a power of two the
    reciprocal is exact, and the fma rounds as the division did)."""
    i = torch.arange(bins, dtype=torch.float32, device=lo.device)
    return fma_f32((i + 0.5) * span, np.float32(1) / np.float32(bins), lo)


def histogram(img: torch.Tensor, bins: int = 256):
    """(counts int32 [bins], bin centres float32 [bins]) over the image's
    [min, max] range: skimage.filters.threshold_otsu binning.  The image is
    binned as one plane of a [1, H, W] stack (``_histogram_batch``); an
    image of another rank is first flattened to one [N, W] plane."""
    x = as_float32(img)
    counts, centers = _histogram_batch(x.reshape(1, -1, x.shape[-1] if x.ndim else 1), bins)
    return counts[0], centers[0]


def _histogram_batch(x3: torch.Tensor, bins: int):
    """Per-plane (counts int32 [B, bins], centres float32 [B, bins]) of a
    float32 [B, H, W] stack over each plane's [min, max] range, with the
    same bins and centres as ``histogram``."""
    lo, span = _value_range(x3)
    if use_kernel(x3):
        counts = bin_histogram_cuda(x3.contiguous(), lo, span, bins)
    else:
        counts = bin_histogram(x3, lo, span, bins)
    return counts, _centers(lo[..., 0], span[..., 0], bins)


def _otsu_from_range(counts, lo, span, bins: int) -> torch.Tensor:
    """Otsu's cut [B] from counts [B, bins] and each plane's ``lo`` and
    ``span`` [B, 1]: the bin centres, then ``_otsu_from_hist``."""
    return _otsu_from_hist(counts, _centers(lo, span, bins))


_OTSU_GRAPHS: dict = {}  # (device, stream, planes, bins) -> (graph, its inputs, its cut)
_otsu_lock = threading.Lock()


def _otsu_graphed(counts, lo, span, bins: int) -> torch.Tensor:
    """``_otsu_from_range`` on the card, replayed as one CUDA graph a
    (device, current stream, planes, bins).  The first call of a key
    captures the graph (a host sync, once, in ``pcis.sync.otsu_graph``);
    every call copies its inputs into the graph's, replays it and copies
    the cut out, on the current stream.  A graph's buffers serve one
    stream, and the lock keeps two threads' copies and replays on it from
    interleaving."""
    with torch.cuda.device(counts.device), _otsu_lock:
        stream = torch.cuda.current_stream()
        key = (counts.device, stream.cuda_stream, counts.shape[0], bins)
        if key not in _OTSU_GRAPHS:
            with stage("pcis.sync.otsu_graph"):  # the capture syncs the card, once a key
                static = [t.clone() for t in (counts, lo, span)]
                side = torch.cuda.Stream()
                side.wait_stream(stream)
                with torch.cuda.stream(side):  # loads the kernels outside the capture
                    _otsu_from_range(*static, bins)
                stream.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    cut = _otsu_from_range(*static, bins)
            _OTSU_GRAPHS[key] = (graph, static, cut)
        graph, static, cut = _OTSU_GRAPHS[key]
        for held, t in zip(static, (counts, lo, span)):
            held.copy_(t)
        graph.replay()
        return cut.clone()


def _otsu_batch(x3: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-plane Otsu thresholds [B] of a float32 [B, H, W] stack: the
    histogram as ``_histogram_batch`` bins it, then the reduction, as one
    graph on the card."""
    if not use_kernel(x3):
        return _otsu_from_hist(*_histogram_batch(x3, bins))
    lo, span = _value_range(x3)
    counts = bin_histogram_cuda(x3.contiguous(), lo, span, bins)
    return _otsu_graphed(counts, lo[..., 0], span[..., 0], bins)


def _prefix_sum(c: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums along the last axis, in XLA's CPU order
    for ``jnp.cumsum``: up to 16 entries one after another from 0; past
    that, each block of 16 in order, plus the prefix sum (by this same rule)
    of the blocks' totals before it."""
    n = c.shape[-1]
    if n <= _SCAN_BLOCK:
        sums = [c[..., 0] + 0.0]
        for k in range(1, n):
            sums.append(sums[-1] + c[..., k])
        return torch.stack(sums, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(c, (0, nb * _SCAN_BLOCK - n)).reshape(c.shape[:-1] + (nb, _SCAN_BLOCK))
    inner = _prefix_sum(blocks)
    carry = _prefix_sum(inner[..., -1])[..., :-1, None]
    out = torch.cat([inner[..., :1, :], inner[..., 1:, :] + carry], dim=-2)
    return out.reshape(c.shape[:-1] + (nb * _SCAN_BLOCK,))[..., :n]


def _otsu_from_hist(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Otsu's cut over [..., bins] histograms: the bin centre maximising the
    between-class variance ω₀ω₁(μ₀ − μ₁)², the first such bin on a tie; cuts
    with an empty class score −1."""
    c = counts.to(torch.float32)
    w0, m = _prefix_sum(torch.stack([c, c * centers], dim=-2)).unbind(-2)
    w1 = w0[..., -1:] - w0
    mu0 = m / torch.clamp_min(w0, 1e-12)
    mu1 = (m[..., -1:] - m) / torch.clamp_min(w1, 1e-12)
    d = mu0 - mu1
    var_b = torch.where((w0 > 0) & (w1 > 0), w0 * w1 * (d * d), -1.0)
    best = torch.argmax(var_b, dim=-1, keepdim=True)
    return torch.gather(centers, -1, best)[..., 0]


def otsu_threshold(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Otsu's threshold (float32 scalar tensor) of one image: pixels above
    it are foreground."""
    x = as_float32(img)
    return _otsu_batch(x.reshape(1, -1, x.shape[-1] if x.ndim else 1), bins)[0]


def otsu_threshold_batch(imgs: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Per-plane Otsu thresholds [B] of a [B, H, W] stack, each equal to
    ``otsu_threshold`` of its plane."""
    if imgs.ndim != 3:
        raise ValueError(f"otsu_threshold_batch: expected [B, H, W], got {tuple(imgs.shape)}")
    return _otsu_batch(as_float32(imgs), bins)


def threshold_and_count(img: torch.Tensor, max_regions: int = 4096, min_area: int = 1):
    """BASELINE config #1 on one [H, W] plane: Otsu → binary mask → CCL →
    particle count.  Returns (mask bool, compact labels int32, count of
    components with area ≥ min_area, num_components), the last two int32
    scalars.

    ``num_components`` is the TRUE component count: components past
    ``max_regions`` are dropped from the area table, so ``count``
    undercounts when num_components > max_regions."""
    if img.ndim != 2:
        raise ValueError(f"threshold_and_count: expected [H, W], got {tuple(img.shape)}")
    x = as_float32(img)
    mask = x > otsu_threshold_batch(x[None])[0]
    raw = connected_components_auto(mask.to(torch.uint8), background=0, num_classes=2)
    seg, num = compact_labels_auto(raw, max_regions)
    area, _ = region_counts_auto(seg, mask.to(torch.int32), max_regions)
    count = (area[1:] >= min_area).sum(dtype=torch.int32)
    return mask, seg, count, num


def _threshold_and_count_planes(x: torch.Tensor, bins: int, max_regions: int,
                                min_area: int) -> tuple:
    """The body of config #1's batched count on a float32 [B, H, W] stack,
    shared with config #2 (``models.zstack``): each plane's Otsu threshold
    from one histogram, the mask above it, the 8-connected CCL of the
    2-class mask with the background labelled too, raster-rank compaction,
    the area and class tables [B, max_regions + 1], and the count of
    foreground regions with area ≥ ``min_area``.  A span a step
    (``pcis.threshold.otsu``, ``.ccl``, ``.compact``, ``.counts``); no host
    sync on the card.  Returns (thresholds, mask, seg, count, num_fg,
    num_total, converged, areas, classes), as ``threshold_and_count_batch``
    describes the six it returns."""
    with stage("pcis.threshold.otsu"):
        thresholds = _otsu_batch(x, bins)
    with stage("pcis.threshold.ccl"):
        mask = x > thresholds[:, None, None]
        m8 = mask.to(torch.uint8)
        raw, conv_ccl = connected_components_auto(m8, background=None, num_classes=2,
                                                  with_flag=True)
    with stage("pcis.threshold.compact"):
        seg, num_total, conv_cmp = compact_labels_auto(raw, max_regions, with_flag=True)
    with stage("pcis.threshold.counts"):
        areas, classes = region_counts_auto(seg, m8, max_regions, val_bound=1)
        fg = (classes == 1) & (areas > 0)
        count = (fg & (areas >= min_area)).sum(dim=-1, dtype=torch.int32)
        num_fg = fg.sum(dim=-1, dtype=torch.int32)
    return (thresholds, mask, seg, count, num_fg, num_total, conv_ccl & conv_cmp, areas,
            classes)


def threshold_and_count_batch(imgs: torch.Tensor, max_regions: int = 4096, min_area: int = 1):
    """Batched config #1: per-plane Otsu → CCL → per-plane particle counts
    of a [B, H, W] stack.

    Background pixels are labelled too (``background=None``); the count
    keeps foreground (class 1) regions with area ≥ ``min_area``.  Returns
    (mask [B,H,W] bool, seg [B,H,W] int32, count [B], num_fg [B], num_total
    [B], converged [B]).

    Overflow contract: ``num_total`` is the TRUE per-plane component count
    (foreground and background, from compaction, not clamped to capacity);
    ``count`` and ``num_fg`` of a plane with num_total > max_regions
    undercount, since components past capacity are dropped from the table.
    ``converged`` is False where the plain CCL's 64 rounds ran out (the
    kernels always converge)."""
    if imgs.ndim != 3:
        raise ValueError(
            f"threshold_and_count_batch: expected [B, H, W], got {tuple(imgs.shape)}")
    return _threshold_and_count_planes(as_float32(imgs), 256, max_regions, min_area)[1:7]
