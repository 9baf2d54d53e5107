"""Configuration of the port's pipelines.

The port's own copy of what it reads from the JAX package's ``config.py``
(the reference's constants as frozen dataclasses; reference:
tiff_analysis.py:47-82, refine_boundaries.py, the NanoSIMS .m script).  Defaults and field names are
the JAX package's, field for field, so a configuration carries across with
``config_from_fields``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

# Display colors (reference: tiff_analysis.py:48-55).
CMAP: Mapping[str, str] = {
    "3D05": "#c0a0c0",
    "6B07": "cyan",
    "C3M10": "yellow",
    "Particle": "#1f607f",
    "Background": "black",
}

# Label-value semantics (reference: tiff_analysis.py:56-60).
BASE_TYPE_MAP: Mapping[int, str] = {
    1: "3D05",
    2: "6B07",
    3: "C3M10",
    4: "Particle",
    5: "Background",
}
CELL_TYPES: Tuple[str, ...] = ("3D05", "6B07", "C3M10")
CHANNELS: Tuple[str, ...] = ("RFP", "DAPI", "GFP")
CHANNEL_MAP: Mapping[str, str] = {"RFP": "3D05", "DAPI": "6B07", "GFP": "C3M10"}
STRAIN_MAP: Mapping[str, str] = {"3D05": "RFP", "6B07": "DAPI", "C3M10": "GFP"}

# Raw-capture channel layout (reference: create_file_structure.py:13-16,
# split_zstack.py:39).
CAPTURE_CHANNELS: Tuple[dict, ...] = (
    {"name": "CY5", "color": "red"},
    {"name": "RFP", "color": "magenta"},
    {"name": "GFP", "color": "green"},
    {"name": "DAPI", "color": "cyan"},
)


def _freeze(d: Mapping) -> Tuple:
    return tuple(sorted(d.items()))


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """All tunables of the segmentation analysis.

    Defaults mirror reference tiff_analysis.py:62-82 exactly.
    """

    # Minimum single-cell area in px² per strain (reference :65).
    min_cell_area: Tuple[Tuple[str, int], ...] = _freeze(
        {"3D05": 20, "6B07": 20, "C3M10": 20}
    )
    # Minimum cluster area in px² per strain (reference :67-71).
    min_cluster_area: Tuple[Tuple[str, int], ...] = _freeze(
        {"3D05": 200, "6B07": 200, "C3M10": 370}
    )
    # Median-filter window (reference :73).
    denoise_size: int = 5
    # Particle-fill dilation radius, px (reference :74-76).
    dilation_radius: int = 20
    # Particle-fill EDT threshold, px (reference :77-79).
    distance_threshold: int = 2
    # Proximity-merge distance (disk radius = value // 2) (reference :80).
    cell_cluster_distance_threshold: int = 5
    # DAPI-overlap removal fraction (reference :81).
    dapi_overlap_threshold: float = 0.1
    # Pixel scale, px per µm (reference :82).
    px_to_um: float = 9.95

    # ---- framework-only knobs (no reference counterpart) ----
    # Upper bound on regions per plane: region tables have max_regions + 1 rows.
    max_regions: int = 16384
    # Exclusive upper bound on label values (reference planes use 1..5).
    num_classes: int = 8
    # Reproduce reference crash behaviors instead of the deliberate fixes
    # (e.g. cluster.cells=0 when a strain has clusters but no single cells).
    strict_reference_errors: bool = False
    # Enforce the reference's hardcoded 2048×2048 plane shape.
    enforce_reference_shape: bool = False
    # Fixpoint budgets of the plain CCL (ccl_max_iters rounds; the kernel is
    # not iterative).  The JAX package's band-sweep and sharded budgets are
    # kept so that every field carries across.
    ccl_max_sweeps: int = 16
    ccl_max_iters: int = 64
    sharded_max_iters: int = 128

    @property
    def min_cell_area_map(self) -> dict:
        return dict(self.min_cell_area)

    @property
    def min_cluster_area_map(self) -> dict:
        return dict(self.min_cluster_area)

    @property
    def merge_disk_radius(self) -> int:
        # reference tiff_analysis.py:827: disk(CELL_CLUSTER_DISTANCE_THRESHOLD // 2)
        return self.cell_cluster_distance_threshold // 2


DEFAULT_CONFIG = AnalysisConfig()


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Watershed boundary-refinement tunables (reference: refine_boundaries.py)."""

    # Probability threshold: object where boundary prob < threshold (ref :44-45).
    boundary_threshold: float = 0.5
    # Channel index of the boundary-probability map (ref :34).
    boundary_channel: int = 3
    # Cap (px) for the marker-seeding EDT, or None (default) for the EXACT
    # uncapped transform (scipy parity).  A cap saturates deeper distances
    # into one plateau that local_maxima would merge into one giant marker.
    edt_cap: int | None = None
    # Probe cap of the certified-exact EDT (ops.edt.edt_sq_exact_auto): the
    # capped transform runs first and the exact fallback only if some
    # distance exceeds the probe.  Results are the same at any setting.
    edt_probe_cap: int = 32
    # Model priority-flood basin tunneling in the watershed via
    # basin-component contraction (ops.watershed docstring), for plateaued
    # or quantized probability maps with sparse markers.
    tunnel_basins: bool = False
    # Watershed budgets: ``watershed_max_iters`` bounds the plain Jacobi
    # steps and the kernels' passes of each phase.  ``watershed_max_sweeps``
    # is the JAX package's band-sweep budget, kept so every field carries
    # across; the port does not read it.
    watershed_max_iters: int = 1024
    watershed_max_sweeps: int = 16


@dataclasses.dataclass(frozen=True)
class NanoSIMSConfig:
    """NanoSIMS 5-isotope analysis tunables (reference: the .m script)."""

    # Acquisition field of view in µm (ref .m:265: raster=19).
    raster_um: float = 19.0
    # Acquisition size in px after the 1-px frame crop (ref .m:18-28).
    # Distances are converted via raster / 512 µm per px (ref .m:265-268).
    distance_size_px: int = 512
    # Gaussian blur sigmas (ref .m:43,51-62).
    sigma_display: float = 1.0
    sigma_ratio: float = 1.5
    # Reproduce the reference copy-paste bug where the green-ROI O17/O18
    # activity maps are accumulated into the red images (ref .m:210-213).
    compat_green_o_bug: bool = False
    # Reproduce MATLAB imcrop's half-pixel rect convention (ref .m:83-85):
    # one extra row and column past the content extent (clamped at the image
    # edge), which shifts every ROI mask resize and so every ROI sum.  False
    # crops exactly to the content bounding box.
    compat_imcrop_rect: bool = False
    # ROI capacity of one painted class; more ROIs raise.
    max_rois: int = 1024


def config_from_fields(obj):
    """The port's ``AnalysisConfig``, ``RefineConfig`` or ``NanoSIMSConfig``
    with the field values of ``obj``, any object that has every field of one
    of them (a configuration of the JAX package, say).  Raises if it has
    none."""
    for cls in (AnalysisConfig, RefineConfig, NanoSIMSConfig):
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(obj, n) for n in names):
            return cls(**{n: getattr(obj, n) for n in names})
    raise TypeError(
        f"{type(obj).__name__} has the fields of neither AnalysisConfig, RefineConfig "
        "nor NanoSIMSConfig"
    )
