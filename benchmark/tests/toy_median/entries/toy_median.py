"""Entry driver of a toy configuration for the tests: the port's label
median (``ops.filters.median_label_filter``) on [B, H, W] uint8 class
planes, inside a span of the driver's own, then one host readback of each
plane's sum of classes.  It stands for an entry that joins the benchmark
by new files alone, with its two declarations.
"""

from __future__ import annotations

import torch

SPAN = "pcis.toy_median"


def CALL_BYTES(B: int, H: int, W: int, options: dict) -> int:
    """uint8 planes in, uint8 planes out."""
    return B * H * W * 2


class Entry:
    def __init__(self, options: dict):
        from particle_col_image_segmentation_tpu_torch.ops.filters import median_label_filter
        from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

        self._median, self._stage = median_label_filter, stage
        self.size, self.num_classes = options["denoise_size"], options["num_classes"]

    def call(self, x: torch.Tensor):
        with self._stage(SPAN):
            return self._median(x, self.size, self.num_classes)

    def readback(self, out) -> torch.Tensor:
        return out.sum(dim=(-2, -1), dtype=torch.int64).cpu()

    @staticmethod
    def answer(host: torch.Tensor) -> dict:
        return {"class_sum": host.numpy()}

    def held(self, out) -> dict:
        return {"den": out}

    def counters(self) -> dict:
        return {}
