"""Config #2 on the card: one channel's z-stack, plane by plane.

BASELINE config #2 ("Full z-stack: split_zstack plane extraction +
per-plane denoise, threshold, and label stats"): after the split, each
uint16 [P, H, W] stack of one channel is blurred (Gaussian, σ 1), each
plane is cut at its Otsu threshold (256 bins over the plane's range), and
the foreground's regions are labelled and counted.  ``bench.py`` calls it
``stack_stats`` and jits the graph, so the blur takes the contracted form
(``gaussian_blur(..., fma=True)``) that XLA's CPU code gives it.

On a CUDA tensor: the blur kernel, then ``ops.threshold``'s shared body
(K4's histogram, the Otsu reduction, K2 on the 2-class mask with the
background labelled, K3's compaction, K4's tables), with no host sync.  On
a CPU tensor every step is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particle_col_image_segmentation_tpu_torch.ops.filters import gaussian_blur
from particle_col_image_segmentation_tpu_torch.ops.threshold import _threshold_and_count_planes
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

__all__ = ["ZStackStats", "zstack_stats_device"]


class ZStackStats(NamedTuple):
    """A stack's per-plane results, on the stack's device: ``den`` float32
    [P, H, W], the blurred stack; ``thresholds`` float32 [P]; ``mask`` bool
    and ``seg`` int32 [P, H, W]; ``count`` (foreground regions with area ≥
    ``min_area``), ``num_fg``, ``num_total`` (every region, background ones
    too, not clamped to capacity) int32 [P] and ``converged`` bool [P];
    ``areas`` and ``classes`` int32 [P, max_regions + 1], ids past
    ``max_regions`` dropped (``count`` and ``num_fg`` then undercount)."""

    den: torch.Tensor
    thresholds: torch.Tensor
    mask: torch.Tensor
    seg: torch.Tensor
    count: torch.Tensor
    num_fg: torch.Tensor
    num_total: torch.Tensor
    converged: torch.Tensor
    areas: torch.Tensor
    classes: torch.Tensor


def zstack_stats_device(stack: torch.Tensor, *, sigma: float = 1.0, bins: int = 256,
                        max_regions: int = 4095, min_area: int = 1) -> ZStackStats:
    """Config #2's compute on a [P, H, W] stack (any dtype ``gaussian_blur``
    takes; the microscope's uint16 is read as it lies): the contracted
    Gaussian blur at ``sigma``, then per plane the Otsu threshold over
    ``bins`` bins, the 8-connected CCL of the mask, compaction, the area
    and class tables and the counts (``ZStackStats``).  The keywords'
    defaults are config #2's constants as ``bench.py`` uses them."""
    if stack.ndim != 3:
        raise ValueError(f"zstack_stats_device: expected [P, H, W], got {tuple(stack.shape)}")
    with stage("pcis.zstack"):
        with stage("pcis.zstack.blur"):
            den = gaussian_blur(stack, sigma, fma=True)
        r = _threshold_and_count_planes(den, bins, max_regions, min_area)
    return ZStackStats(den, *r)
