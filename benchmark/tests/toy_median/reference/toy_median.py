"""Plain reference of the toy median configuration: ``plain.median_filter``
and each plane's sum of classes (in int16 with ``control``, where a sum
past 32767 wraps)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import plain


def compute(x: torch.Tensor, options: dict, control: bool = False, full: bool = False):
    den = plain.median_filter(x, options["denoise_size"], options["num_classes"])
    sums = den.sum(dim=(-2, -1), dtype=torch.int16 if control else torch.int64)
    return {"class_sum": sums.cpu().numpy().astype(np.int64)}, ({"den": den} if full else None)
