"""Entry driver: the fused segmentation pass of ``batch`` and ``analyze``.

A call is ``models.batch.fused_segment_batch`` on a [B, H, W] uint8 batch on
the card, then one host readback of what the ``batch`` verb writes out
(num, particle_px, cell_px, converged, class_px), as ``run_batch`` reads it.
"""

from __future__ import annotations

import dataclasses

import torch

SPAN = "pcis.segment"


def CALL_BYTES(B: int, H: int, W: int, options: dict) -> int:
    """uint8 planes in; int32 ``seg`` and the two int32 region tables of
    max_regions + 1 rows out (the per-plane stats are a few bytes)."""
    return B * H * W * (1 + 4) + B * (options["max_regions"] + 1) * 4 * 2


class Entry:
    def __init__(self, options: dict):
        from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
        from particle_col_image_segmentation_tpu_torch.models import batch

        self._batch = batch
        names = {f.name for f in dataclasses.fields(AnalysisConfig)}
        self.cfg = AnalysisConfig(**{k: v for k, v in options.items() if k in names})
        self.particle_val = options["particle_val"]
        self.cell_vals = tuple(options["cell_vals"])

    def call(self, x: torch.Tensor):
        return self._batch.fused_segment_batch(x, self.cfg, self.particle_val, self.cell_vals)

    def readback(self, out) -> torch.Tensor:
        """The call's answers on the host: one [B, 4 + C] copy."""
        _, num, _, _, particle_px, cell_px, class_px, converged = out
        return torch.cat([num[:, None], particle_px[:, None], cell_px[:, None],
                          converged[:, None].to(num.dtype), class_px], dim=-1).cpu()

    @staticmethod
    def answer(host: torch.Tensor) -> dict:
        """A readback's fields, as the reference gives them."""
        a = host.numpy().astype("int64")
        return {"num": a[:, 0], "particle_px": a[:, 1], "cell_px": a[:, 2],
                "converged": a[:, 3], "class_px": a[:, 4:]}

    def held(self, out) -> dict:
        seg, _, areas, classes = out[:4]
        return {"seg": seg, "areas": areas, "classes": classes}

    def counters(self) -> dict:
        return {}
