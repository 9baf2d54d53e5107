"""Strain / channel / class-id mapping logic.

Pure-Python port-free reimplementation of the label-semantics helpers
(reference: tiff_analysis.py:673-712).  A "cell-type map" maps the integer
pixel values of an Ilastik label plane to semantic names, e.g.
``{1: "3D05", 2: "Particle", 3: "Background"}``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from particle_col_image_segmentation_tpu_torch.config import (
    CELL_TYPES,
    CHANNEL_MAP,
    CHANNELS,
)


def get_strains_from_path(path: str) -> List[str]:
    """Strains whose token appears in the uppercased path.

    Reference: tiff_analysis.py:673-678. Order follows CELL_TYPES, i.e.
    ("3D05", "6B07", "C3M10").
    """
    upper = path.upper()
    return [s for s in CELL_TYPES if s in upper]


def get_channel_from_path(path: str) -> str:
    """The single channel token found in the path.

    Reference: tiff_analysis.py:680-687 — raises ValueError when more than one
    channel token is present and (like the reference's bare ``channels[0]``)
    an IndexError when none is found.
    """
    upper = path.upper()
    found = [c for c in CHANNELS if c in upper]
    if len(found) > 1:
        raise ValueError("More than one channel found in file path")
    return found[0]


def get_cell_type_map(path: str) -> Dict[int, str]:
    """Value→name map from the strain tokens in a path.

    Reference: tiff_analysis.py:694-702. Strains get values 1..n, then
    Particle=n+1 and Background=n+2. The reference NameErrors when no strain
    token is present (loop variable unbound); we raise a clear ValueError.
    """
    strains = get_strains_from_path(path)
    if not strains:
        raise ValueError(f"No strain token found in path: {path!r}")
    out = {i + 1: s for i, s in enumerate(strains)}
    out[len(strains) + 1] = "Particle"
    out[len(strains) + 2] = "Background"
    return out


def get_cell_type_map_from_channel(
    strains: Sequence[str], channel: str
) -> Dict[int, str]:
    """Per-channel value→name map.

    Reference: tiff_analysis.py:709-712. RFP with only-6B07 or 6B07+C3M10
    strain sets carries no cell class: {1: Particle, 2: Background}.
    """
    strains = list(strains)
    if channel == "RFP" and strains in (["6B07"], ["6B07", "C3M10"]):
        return {1: "Particle", 2: "Background"}
    return {1: CHANNEL_MAP[channel], 2: "Particle", 3: "Background"}


def particle_value(cell_types: Dict[int, str]) -> int:
    """The pixel value whose class is Particle (reference: :939-942)."""
    for val, name in cell_types.items():
        if name == "Particle":
            return val
    raise ValueError("No Particle class in cell-type map")


def strain_values(cell_types: Dict[int, str]) -> Dict[str, int]:
    """strain name → pixel value, for strains present in the map."""
    return {name: val for val, name in cell_types.items() if name in CELL_TYPES}
