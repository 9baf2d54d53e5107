"""Entry driver: config #2's z-stack stats.

A call is ``models.zstack.zstack_stats_device`` on one [P, H, W] uint16
stack on the card (the blur, then each plane's Otsu threshold, CCL,
compaction, tables and counts), then one host readback of what a z-stack
run writes out a plane: the threshold, count, num_fg, num_total and
converged.
"""

from __future__ import annotations

import torch

SPAN = "pcis.zstack"


def CALL_BYTES(B: int, H: int, W: int, options: dict) -> int:
    """The uint16 stack read once (2 B a pixel); the int32 ``seg`` and the
    bool mask written once (5 B a pixel); the two int32 region tables of
    max_regions + 1 rows a plane (the per-plane stats are a few bytes)."""
    return B * H * W * (2 + 5) + B * (options["max_regions"] + 1) * 4 * 2


class Entry:
    def __init__(self, options: dict):
        from particle_col_image_segmentation_tpu_torch.models.zstack import zstack_stats_device

        self._stats = zstack_stats_device
        self.kw = {k: options[k] for k in ("sigma", "bins", "max_regions", "min_area")}

    def call(self, x: torch.Tensor):
        return self._stats(x, **self.kw)

    def readback(self, out) -> torch.Tensor:
        """The call's answers on the host: one [P, 5] int32 copy, the
        thresholds as their float32 bits."""
        return torch.stack([out.thresholds.view(torch.int32), out.count, out.num_fg,
                            out.num_total, out.converged.to(torch.int32)], dim=-1).cpu()

    @staticmethod
    def answer(host: torch.Tensor) -> dict:
        """A readback's fields, as the reference gives them."""
        a = host.numpy().astype("int64")
        return {"threshold_bits": a[:, 0], "count": a[:, 1], "num_fg": a[:, 2],
                "num_total": a[:, 3], "converged": a[:, 4]}

    def held(self, out) -> dict:
        return {"den": out.den, "seg": out.seg, "areas": out.areas, "classes": out.classes}

    def counters(self) -> dict:
        return {}
