"""Host-side helpers of the reference pipeline that the port calls: its own
copy of ``normalize_ds_arr`` and ``get_cell_counts_and_densities`` from the
JAX package's ``oracle/reference_pipeline.py`` (reference:
tiff_analysis.py:727-737 and :1018-1038).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from particle_col_image_segmentation_tpu_torch.config import (
    CELL_TYPES,
    DEFAULT_CONFIG,
    AnalysisConfig,
)
from particle_col_image_segmentation_tpu_torch.oracle.ndimage import Region


def normalize_ds_arr(ds_arr: np.ndarray, cfg: AnalysisConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Squeeze (H,W,1) / (1,H,W) → (H,W) (reference: tiff_analysis.py:727-737).

    The reference hardcodes H=W=2048; we accept any 2-D plane (the device
    kernels handle rectangular shapes; the reference itself squeezes ANY
    trailing-1 shape without checking squareness) unless
    ``cfg.enforce_reference_shape`` pins the exact 2048².  A squeeze that
    still leaves >2 dims raises — the reference would silently hand a 3-D
    array to skimage.label (defect class, SURVEY §2.6).
    """
    if ds_arr.shape[-1] == 1:
        out = np.squeeze(ds_arr)
    elif ds_arr.shape[0] == 1:
        out = ds_arr[0]
    else:
        out = ds_arr
    if out.ndim != 2:
        raise ValueError(f"DS arr is not a single plane. Shape: {ds_arr.shape}")
    if cfg.enforce_reference_shape and out.shape != (2048, 2048):
        raise ValueError(f"DS arr shape is not 2048². Shape: {ds_arr.shape}")
    return out


def get_cell_counts_and_densities(
    cell_pos: Dict[str, List[Region]],
    cell_clusters: Dict[str, List[Region]],
    particle_area: float,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
):
    """Counts / densities / area ratios (reference: tiff_analysis.py:1018-1038)."""
    cell_count, cell_density, cell_area_ratio = {}, {}, {}
    particle_area_um = particle_area / (cfg.px_to_um**2)
    for cell_type, cell_array in cell_pos.items():
        if cell_type not in CELL_TYPES:
            continue
        cluster_cells = sum(c.cells for c in cell_clusters[cell_type])
        cell_count[cell_type] = len(cell_array) + cluster_cells
        cell_area = float(np.sum([c.area for c in cell_array])) if cell_array else 0.0
        for cluster in cell_clusters[cell_type]:
            cell_area += cluster["area"]
        area_um = cell_area / (cfg.px_to_um**2)
        cell_density[cell_type] = round(cell_count[cell_type] / particle_area_um, 5)
        cell_area_ratio[cell_type] = round(area_um / particle_area_um, 5)
    return cell_count, cell_density, cell_area_ratio
