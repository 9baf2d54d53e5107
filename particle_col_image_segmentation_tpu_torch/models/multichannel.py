"""Multi-channel fusion (reference tiff_analysis.py:224-249).

Counterpart of ``particle_col_image_segmentation_tpu/models/multichannel.py``:
label-space remaps are ``torch.where`` stamping on the planes' device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from particle_col_image_segmentation_tpu_torch.config import BASE_TYPE_MAP, STRAIN_MAP
from particle_col_image_segmentation_tpu_torch.models.single_channel import as_plane

__all__ = ["rfp_base_remap", "combine_channels_device", "fuse_channels"]


def rfp_base_remap(rfp: torch.Tensor, six_b07_base: bool) -> torch.Tensor:
    """Remap RFP channel values into BASE_TYPE space (reference :224-231).

    six_b07_base=True for strain sets ["6B07"] / ["6B07","C3M10"] (RFP plane
    has no cell class: 1→Particle, 2→Background); otherwise 2→Particle,
    3→Background with 3D05 cells staying 1.
    """
    particle, background = (1, 2) if six_b07_base else (2, 3)
    out = torch.where(rfp == particle, 4, rfp)
    return torch.where(rfp == background, 5, out)


def combine_channels_device(
    base: torch.Tensor,
    channel_planes: Tuple[torch.Tensor, ...],
    strain_vals: Tuple[int, ...],
) -> torch.Tensor:
    """Stamp each channel's cell pixels (value 1) with its strain's BASE_TYPE
    value (reference :233-249; 3D05 skipped by the caller since it is already
    the base)."""
    out = base
    for plane, val in zip(channel_planes, strain_vals):
        out = torch.where(plane == 1, val, out)
    return out


def fuse_channels(channel_ds_arrs: Dict[str, torch.Tensor], cell_strains) -> torch.Tensor:
    """Full reference fusion — RFP base remap + stamping of every non-3D05
    strain present (reference :202-204).  Planes may be tensors or NumPy
    arrays; the result lies with the RFP plane."""
    cell_strains = list(cell_strains)
    six_b07_base = cell_strains in (["6B07"], ["6B07", "C3M10"])
    base = rfp_base_remap(as_plane(channel_ds_arrs["RFP"]), six_b07_base)
    planes, vals = [], []
    strain_of_val = {name: val for val, name in BASE_TYPE_MAP.items()}
    for strain in cell_strains:
        if strain == "3D05":
            continue
        planes.append(as_plane(channel_ds_arrs[STRAIN_MAP[strain]], base.device))
        vals.append(strain_of_val[strain])
    if not planes:
        return base
    return combine_channels_device(base, tuple(planes), tuple(vals))
