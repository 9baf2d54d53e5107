"""Reference-semantics analysis pipeline, pure NumPy/SciPy: the port's own
copy of the JAX package's ``oracle/reference_pipeline.py``.

Each function reimplements the behavior of its reference counterpart in
tiff_analysis.py (cited per function).  It is the golden oracle the port's
analysis plane is held against (``tests/test_torch_analysis.py``, and
``chip_smoke.py`` on the card at 2048²), and it holds the host helpers the
port calls (``normalize_ds_arr``, ``get_cell_counts_and_densities``).  It
reads the skimage primitives from the port's ``oracle/ndimage.py``.

Known reference defects (SURVEY.md §2.6) are fixed by default and reproduced
when ``AnalysisConfig.strict_reference_errors`` is set.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy import ndimage as ndi

from particle_col_image_segmentation_tpu_torch.config import (
    BASE_TYPE_MAP,
    CELL_TYPES,
    STRAIN_MAP,
    AnalysisConfig,
    DEFAULT_CONFIG,
)
from particle_col_image_segmentation_tpu_torch.oracle.ndimage import (
    Region,
    binary_dilation,
    disk,
    label,
    regionprops,
)


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


def denoise(ds_arr: np.ndarray, cfg: AnalysisConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Median filter (reference: tiff_analysis.py:122,643 — scipy default
    'reflect' boundary)."""
    return ndi.median_filter(ds_arr, size=cfg.denoise_size)


def get_type(region: Region, data: np.ndarray) -> int:
    """Class id at the region's first pixel (reference: tiff_analysis.py:1041-1044)."""
    y, x = region.coords[0]
    return int(data[y, x])


def get_cell_positions_and_areas(
    z_slice: np.ndarray,
    cell_types: Dict[int, str],
    merged: bool = False,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
):
    """Label, classify, and partition regions (reference: tiff_analysis.py:742-789).

    Returns (cell_pos, cell_clusters, particle_area, merged_clusters) where the
    dicts map strain → list[Region] (insertion order = first encounter in
    label order, matching the reference's dict population order).
    """
    label_im = label(z_slice)
    regions = regionprops(label_im)
    cell_pos: Dict[str, List[Region]] = {}
    cell_clusters: Dict[str, List[Region]] = {}
    particle_area = 0
    min_cell = cfg.min_cell_area_map
    min_cluster = cfg.min_cluster_area_map

    for region in regions:
        region_type = get_type(region, z_slice)
        cell_type = cell_types[region_type]
        if cell_type not in CELL_TYPES:
            if cell_type == "Particle":
                particle_area += region.area
            continue
        if cell_type not in cell_pos:
            cell_pos[cell_type] = []
            cell_clusters[cell_type] = []
        if min_cell[cell_type] <= region.area < min_cluster[cell_type]:
            cell_pos[cell_type].append(region)
        if region.area >= min_cluster[cell_type]:
            cell_clusters[cell_type].append(region)

    # Per-cluster estimated cell count from mean single-cell area
    # (reference :776-781; NaN-crashes when a strain has clusters but no
    # singles — fixed to cells=0 unless strict).
    for cell_type, cluster_array in cell_clusters.items():
        singles = cell_pos[cell_type]
        mean_area = float(np.average([c.area for c in singles])) if singles else float("nan")
        for cluster in cluster_array:
            if mean_area == mean_area:
                cluster.cells = int(cluster.area // mean_area)
            elif cfg.strict_reference_errors:
                # reference: int(area // nan) → "cannot convert float NaN to integer"
                cluster.cells = int(cluster.area // mean_area)
            else:
                cluster.cells = 0

    if merged:
        merged_clusters, _ = get_cell_clusters_from_distances(
            z_slice, cell_pos, cell_clusters, cell_types, cfg
        )
    else:
        merged_clusters = {}
    return cell_pos, cell_clusters, particle_area, merged_clusters


def get_cell_clusters_from_distances(
    z_slice: np.ndarray,
    cell_pos: Dict[str, List[Region]],
    cell_clusters: Dict[str, List[Region]],
    cell_types: Dict[int, str],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
):
    """Proximity-merge per strain, then on the union of strain masks
    (reference: tiff_analysis.py:791-824).

    The reference iterates ``set(cell_pos) | set(cell_clusters)`` whose order
    depends on string-hash randomization; we pin the deterministic CELL_TYPES
    order so outputs are reproducible across processes.
    """
    combined: Dict[str, List[Region]] = {}
    all_keys = sorted(
        set(cell_pos) | set(cell_clusters), key=lambda k: CELL_TYPES.index(k)
    )
    for key in all_keys:
        combined[key] = cell_pos.get(key, []) + cell_clusters.get(key, [])

    merged_regions, merged_images = {}, {}
    img_vals, combined_regions = [], []
    for cell_type, cell_regions in combined.items():
        cell_img_val = 0
        for cell_val, name in cell_types.items():
            if name == cell_type:
                cell_img_val = cell_val
                break
        img_vals.append(cell_img_val)
        combined_regions.extend(cell_regions)
        binary_image = z_slice == cell_img_val
        merged_regions[cell_type], merged_images[cell_type] = get_merged_regions(
            binary_image, cell_regions, cfg
        )

    combined_image = np.zeros_like(z_slice, dtype=bool)
    for v in img_vals:
        combined_image |= z_slice == v
    merged_regions["combined"], merged_images["combined"] = get_merged_regions(
        combined_image, combined_regions, cfg
    )
    return merged_regions, merged_images


def get_merged_regions(
    binary_image: np.ndarray,
    og_cell_regions: List[Region],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
) -> Tuple[List[dict], np.ndarray]:
    """Group regions sharing a dilated-mask component (reference:
    tiff_analysis.py:826-883).

    Each original region is assigned to the dilated-mask label under its
    (truncated) centroid; all regions sharing that label merge into one record
    with summed area, area-weighted centroid, and union bbox.  Regions whose
    centroid lands on a zero dilated label are silently dropped (reference
    behavior).  The returned merged image is the union of touched dilated
    components with holes filled.
    """
    struct_elem = disk(cfg.merge_disk_radius)
    dilated = binary_dilation(binary_image, struct_elem)
    dilated_labels = label(dilated)
    processed = set()
    merged_regions: List[dict] = []
    merged_image = np.zeros_like(binary_image, dtype=bool)

    # Precompute each region's dilated label (truncated-centroid lookup,
    # reference :843-851) to avoid the reference's O(N²) rescans.
    region_dl = []
    H, W = dilated_labels.shape
    for r in og_cell_regions:
        y, x = int(r.centroid[0]), int(r.centroid[1])
        region_dl.append(dilated_labels[y, x] if 0 <= y < H and 0 <= x < W else 0)

    for idx, region in enumerate(og_cell_regions):
        dl = region_dl[idx]
        if dl > 0 and dl not in processed:
            touching = [r for r, g in zip(og_cell_regions, region_dl) if g == dl]
            areas = [r.area for r in touching]
            combined_area = sum(areas)
            combined_centroid = np.average(
                [r.centroid for r in touching], axis=0, weights=areas
            )
            bbox = (
                min(r.bbox[0] for r in touching),
                min(r.bbox[1] for r in touching),
                max(r.bbox[2] for r in touching),
                max(r.bbox[3] for r in touching),
            )
            merged_regions.append(
                {
                    "area": combined_area,
                    "centroid": combined_centroid,
                    "regions": touching,
                    "bbox": bbox,
                }
            )
            processed.add(dl)
            merged_image |= dilated_labels == dl
    merged_image = ndi.binary_fill_holes(merged_image)
    return merged_regions, merged_image


def fill_particle_area(
    ds_arr: np.ndarray,
    particle_label: int,
    cell_label: int,
    overlap_label: int,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
):
    """Absorb near-particle cell pixels into the particle class
    (reference: tiff_analysis.py:982-1015).

    Overlap = cell ∧ (EDT(~particle) < distance_threshold  ∨
                      dilate(particle, disk(dilation_radius))).
    With the reference constants (2 < 20) the EDT criterion is subsumed by the
    dilation criterion; both are kept for config generality.
    """
    particle_mask = ds_arr == particle_label
    cell_mask = ds_arr == cell_label
    dilated_particle = binary_dilation(particle_mask, disk(cfg.dilation_radius))
    dist = ndi.distance_transform_edt(~particle_mask)
    combined_overlap = cell_mask & (
        (dist < cfg.distance_threshold) | dilated_particle
    )
    updated = ds_arr.copy()
    updated[combined_overlap] = overlap_label
    return updated, int(np.sum(combined_overlap))


def recreate_particle_area(
    ds_arr: np.ndarray,
    cell_types: Dict[int, str],
    particle_area: int,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
):
    """Fold cell/particle overlap into the particle area, per strain class
    (reference: tiff_analysis.py:931-950)."""
    particle_label = None
    for key, value in cell_types.items():
        if value == "Particle":
            particle_label = key
    for cell_type_label, cell_type in cell_types.items():
        if cell_type not in CELL_TYPES:
            continue
        ds_arr, overlap_area = fill_particle_area(
            ds_arr, particle_label, cell_type_label, particle_label, cfg
        )
        particle_area += overlap_area
    return ds_arr, particle_area


def combine_cell_positions_and_clusters(
    dapi_channel: np.ndarray,
    other_channel: np.ndarray,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Remove DAPI cells overlapping >threshold with the other channel's cells
    (reference: tiff_analysis.py:252-287).  Removed cells become value 2
    (particle)."""
    dapi_mask = dapi_channel == 1
    other_mask = other_channel == 1
    labeled_dapi = label(dapi_mask)
    n = int(labeled_dapi.max())
    out = dapi_channel.copy()
    if n == 0:
        return out
    # Vectorized per-region overlap fractions (reference loops over regions
    # with full-image masks, O(N·H·W); identical result).
    areas = np.bincount(labeled_dapi.ravel(), minlength=n + 1)
    overlaps = np.bincount(
        labeled_dapi.ravel(), weights=other_mask.ravel(), minlength=n + 1
    )
    frac = overlaps[1:] / areas[1:]
    remove_ids = np.flatnonzero(frac > cfg.dapi_overlap_threshold) + 1
    remove_mask = np.isin(labeled_dapi, remove_ids)
    out[remove_mask] = 2
    return out


def get_rfp_base_arr(rfp_arr: np.ndarray, cell_strains: List[str]) -> np.ndarray:
    """Remap RFP channel values into BASE_TYPE space, in place
    (reference: tiff_analysis.py:224-231)."""
    if cell_strains == ["6B07"] or cell_strains == ["6B07", "C3M10"]:
        rfp_arr[rfp_arr == 1] = 4
        rfp_arr[rfp_arr == 2] = 5
    else:
        rfp_arr[rfp_arr == 2] = 4
        rfp_arr[rfp_arr == 3] = 5
    return rfp_arr


def combine_channels(
    rfp_base: np.ndarray,
    channel_ds_arrs: Dict[str, np.ndarray],
    cell_strains: List[str],
) -> np.ndarray:
    """Stamp each non-3D05 strain's cell pixels into the fused base array
    (reference: tiff_analysis.py:233-249)."""
    for strain in cell_strains:
        if strain == "3D05":
            continue
        channel_name = STRAIN_MAP[strain]
        for val, strain_name in BASE_TYPE_MAP.items():
            if strain_name == strain:
                rfp_base[channel_ds_arrs[channel_name] == 1] = val
    return rfp_base


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
