"""Entry driver: the watershed refine of the ``refine`` verb.

A call is ``models.refine.refine_plane_device`` on a [B, H, W] float32
boundary map on the card, then one host readback of num, converged and the
centroid table, from which the verb's CSV is made.  After each call the
driver reads the watershed loop's counters: the PhaseLogs of K10/K11
(``watershed_cuda.last_logs``) where that call set them, and the steps of
the tunnelled phase 2 (``claim_labels.last_steps``) where the call
tunnelled.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

SPAN = "pcis.refine"


def CALL_BYTES(B: int, H: int, W: int, options: dict) -> int:
    """float32 maps in; int32 labels and markers and float32 distance out,
    and the five int32 columns of the centroid table of max_regions + 1
    rows."""
    return B * H * W * (4 + 4 + 4 + 4) + B * (options["max_regions"] + 1) * 4 * 5


class Entry:
    def __init__(self, options: dict):
        from particle_col_image_segmentation_tpu_torch.config import RefineConfig
        from particle_col_image_segmentation_tpu_torch.models import refine
        from particle_col_image_segmentation_tpu_torch.ops.regionprops import HILO_BASE
        from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import watershed_cuda

        # the module, not the package's function of the same name
        watershed = importlib.import_module(
            "particle_col_image_segmentation_tpu_torch.ops.watershed")
        self._refine = refine
        self._claim_labels = watershed.claim_labels
        self._watershed_cuda = watershed_cuda
        self._base = HILO_BASE
        names = {f.name for f in dataclasses.fields(RefineConfig)}
        self.cfg = RefineConfig(**{k: v for k, v in options.items() if k in names})
        self.max_regions = options["max_regions"]
        self._logs = None

    def call(self, x: torch.Tensor):
        self._logs = self._watershed_cuda.last_logs
        return self._refine.refine_plane_device(x, self.cfg, self.max_regions)

    def readback(self, out) -> torch.Tensor:
        """The call's answers on the host: one [B, 2 + 5 (R + 1)] copy."""
        _, _, num, table, _, converged = out
        return torch.cat([num[:, None], converged[:, None].to(num.dtype), table.area,
                          table.sr_hi, table.sr_lo, table.sc_hi, table.sc_lo], dim=-1).cpu()

    def answer(self, host: torch.Tensor) -> dict:
        """A readback's fields, as the reference gives them: the coordinate
        sums from their base-``HILO_BASE`` digits."""
        a = host.numpy().astype("int64")
        R1 = (a.shape[1] - 2) // 5
        col = [a[:, 2 + i * R1: 2 + (i + 1) * R1] for i in range(5)]
        return {"num": a[:, 0], "converged": a[:, 1], "area": col[0],
                "sum_row": self._base * col[1] + col[2], "sum_col": self._base * col[3] + col[4]}

    def held(self, out) -> dict:
        labels, markers, _, _, distance, _ = out
        return {"labels": labels, "markers": markers, "distance": distance}

    def counters(self) -> dict:
        """What the last call's watershed loop did."""
        got = {}
        logs = self._watershed_cuda.last_logs
        if logs and logs is not self._logs:
            got["ws_passes"] = sum(log.passes for log in logs)
        if self.cfg.tunnel_basins:
            got["tunnel_steps"] = self._claim_labels.last_steps
        return got
