"""Plain reference of the segmentation call (``fused_segment_batch``).

From the staged uint8 class planes alone: the 5x5 median (scipy's
'reflect'), the 8-connected components of equal classes numbered in raster
order of their first pixel, the area and class of each id up to
``max_regions`` (ids past it dropped), and the pixel stats summed from
those tables.  ``control=True`` holds the labels and every count in int16,
the integer type below the int32 the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import plain

BLOCK = 4  # planes a block: the reference's working set stays near 1 GiB at 2048²
_I32 = torch.iinfo(torch.int32)


def compute(x: torch.Tensor, options: dict, control: bool = False, full: bool = False):
    """(readback, held): the call's per-plane answers as NumPy arrays, and,
    with ``full``, its seg and tables as tensors."""
    dt = torch.int16 if control else torch.int32
    size, K, R = options["denoise_size"], options["num_classes"], options["max_regions"]
    rows = {k: [] for k in ("num", "particle_px", "cell_px", "converged", "class_px")}
    held = {k: [] for k in ("seg", "areas", "classes")}
    for b0 in range(0, x.shape[0], BLOCK):
        den = plain.median_filter(x[b0:b0 + BLOCK], size, K)
        raw, converged = plain.ccl(den, 8, None, dt)
        seg, num = plain.compact(raw, dt)
        area = plain.binned_sums(seg, None, R)
        sums = plain.binned_sums(seg, den, R).clamp(_I32.min, _I32.max)
        classes = torch.div(sums, area.clamp(min=1), rounding_mode="floor").to(dt)
        area = area.to(dt)
        class_px = torch.stack(
            [torch.where(classes == v, area, 0).sum(-1, dtype=dt) for v in range(K)], dim=-1)
        cell_px = sum(class_px[:, v] for v in options["cell_vals"])
        rows["num"].append(num)
        rows["particle_px"].append(class_px[:, options["particle_val"]])
        rows["cell_px"].append(cell_px)
        rows["converged"].append(torch.full_like(num, int(converged)))
        rows["class_px"].append(class_px)
        if full:
            held["seg"].append(seg)
            held["areas"].append(area)
            held["classes"].append(classes)
    readback = {k: torch.cat(v).cpu().numpy().astype(np.int64) for k, v in rows.items()}
    return readback, ({k: torch.cat(v) for k, v in held.items()} if full else None)
