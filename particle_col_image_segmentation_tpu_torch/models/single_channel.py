"""Single-channel plane analysis: device graph + host table assembly.

Counterpart of ``particle_col_image_segmentation_tpu/models/single_channel.py``
(reference tiff_analysis.py:627-671 / 742-789).  The pixel work runs in
``labels.analysis`` on the plane's device; this module turns the fixed-shape
tables into the reference's dict-of-regions representation with identical
ordering, classification and statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch.config import (
    CELL_TYPES,
    DEFAULT_CONFIG,
    AnalysisConfig,
)
from particle_col_image_segmentation_tpu_torch.oracle.ndimage import Region
from particle_col_image_segmentation_tpu_torch.labels.analysis import (
    PlaneDeviceOut,
    analyze_plane_device,
    analyze_plane_device_sharded,
    strain_values_of,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops import centroids_f64


def host(t) -> np.ndarray:
    """A host NumPy copy of a tensor (a NumPy array passes through)."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass
class PlaneAnalysis:
    """Host-side result of one plane, mirroring the reference's outputs.

    ``denoised`` / ``filled`` stay on the device until first access: the
    full-plane copies to the host are paid only by consumers that need
    pixels (figures), not by the CSV path.
    """

    cell_pos: Dict[str, List[Region]]
    cell_clusters: Dict[str, List[Region]]
    particle_area: int  # pre-fill particle pixels (reference :752-760)
    merged_clusters: Dict[str, List[dict]]
    _denoised_dev: object
    _filled_dev: object  # plane after particle fill (reference :931-950)
    filled_particle_area: int  # particle_area + absorbed overlap
    num_regions: int

    @property
    def denoised(self) -> np.ndarray:
        if not isinstance(self._denoised_dev, np.ndarray):
            self._denoised_dev = host(self._denoised_dev)
        return self._denoised_dev

    @property
    def filled(self) -> np.ndarray:
        if not isinstance(self._filled_dev, np.ndarray):
            self._filled_dev = host(self._filled_dev)
        return self._filled_dev


def _as_static(cell_types: Dict[int, str]) -> Tuple[Tuple[int, str], ...]:
    return tuple(sorted(cell_types.items()))


def as_plane(img, device=None) -> torch.Tensor:
    """A label plane as a tensor on ``device`` (a tensor stays where it is
    when ``device`` is None; a NumPy plane goes to the card, ``cuda``)."""
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img))
        if device is None:
            device = "cuda"
    return img if device is None else img.to(device)


def analyze_plane(
    img,
    cell_types: Dict[int, str],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    merged: bool = False,
    denoise: bool = True,
    device_out: Optional[PlaneDeviceOut] = None,
    mesh=None,
    *,
    device=None,
) -> PlaneAnalysis:
    """Analyze one raw label plane end-to-end.

    Matches oracle/reference get_cell_positions_and_areas on the denoised
    plane, plus recreate_particle_area.  ``img`` is a NumPy plane or a
    tensor; it runs on ``device`` (default: where a tensor lies, ``cuda`` for
    NumPy; pass ``device="cpu"`` for the plain versions).  ``denoise=False``
    analyzes the plane as-is (reference re-analysis paths).  Pass
    ``device_out`` to reuse an already-computed device result (e.g. from a
    batched run), or ``mesh`` (it takes the place of ``device``) to split
    the plane's rows into bands over the mesh's space axis (same results as
    the one-device graph).
    """
    ct = _as_static(cell_types)
    if device_out is None:
        if mesh is not None:
            device_out = analyze_plane_device_sharded(
                img, ct, cfg, mesh, compute_merge=merged, denoise=denoise
            )
        else:
            device_out = analyze_plane_device(
                as_plane(img, device), ct, cfg, compute_merge=merged, denoise=denoise
            )
    out = device_out

    num = int(out.num)
    if not bool(out.converged):
        raise RuntimeError(
            "CCL/compaction did not reach its fixpoint within the kernel "
            "iteration budget — labels are invalid (pathological worst-case "
            "geometry; raise the sweep budgets in ops.ccl/ccl_tiles)"
        )
    if num > cfg.max_regions:
        raise ValueError(
            f"Plane has {num} components > max_regions={cfg.max_regions}; "
            "raise AnalysisConfig.max_regions"
        )

    table = type(out.table)(*(host(leaf) for leaf in out.table))
    area, bbox, class_id = table.area, table.bbox, table.class_id
    cy, cx = centroids_f64(table)

    name_of = dict(ct)
    min_cell = cfg.min_cell_area_map
    min_cluster = cfg.min_cluster_area_map

    cell_pos: Dict[str, List[Region]] = {}
    cell_clusters: Dict[str, List[Region]] = {}
    for i in range(1, num + 1):
        name = name_of[int(class_id[i])]
        if name not in CELL_TYPES:
            continue
        if name not in cell_pos:
            cell_pos[name] = []
            cell_clusters[name] = []
        a = int(area[i])
        r = Region(
            lab=i,
            area=a,
            centroid=(float(cy[i]), float(cx[i])),
            bbox=tuple(int(v) for v in bbox[i]),
            coords=None,
        )
        if min_cell[name] <= a < min_cluster[name]:
            cell_pos[name].append(r)
        if a >= min_cluster[name]:
            cell_clusters[name].append(r)

    # cluster.cells (reference :776-781; NaN fix per SURVEY §2.6)
    for name, clusters in cell_clusters.items():
        singles = cell_pos[name]
        mean_area = float(np.average([c.area for c in singles])) if singles else float("nan")
        # NaN mean (clusters but zero singles): int(a // nan) raises like
        # the reference under strict mode, else the fixed behavior is 0
        use_mean = mean_area == mean_area or cfg.strict_reference_errors
        for c in clusters:
            c.cells = int(c.area // mean_area) if use_mean else 0

    merged_clusters: Dict[str, List[dict]] = {}
    if merged:
        g_ctx = host(out.g_ctx)
        strain_order = [n for _, n in strain_values_of(ct)]
        contexts: Dict[str, List[Region]] = {}
        all_keys = sorted(set(cell_pos), key=lambda k: CELL_TYPES.index(k))
        for key in all_keys:
            contexts[key] = cell_pos[key] + cell_clusters[key]
        combined_regions: List[Region] = []
        for key in all_keys:
            combined_regions.extend(contexts[key])
        if combined_regions and (g_ctx < 0).all():
            # with compute_merge=True, every existing region's slot holds
            # its merge-group root (>= 0); an all -1 table is the
            # compute_merge=False placeholder — silently returning empty
            # merge groups would corrupt downstream merge statistics
            raise ValueError(
                "device_out was computed with compute_merge=False but "
                "merged=True analysis was requested — recompute with "
                "compute_merge=True"
            )
        for key in all_keys:
            ctx_idx = strain_order.index(key)
            merged_clusters[key] = _group_regions(contexts[key], g_ctx[ctx_idx])
        merged_clusters["combined"] = _group_regions(combined_regions, g_ctx[-1])

    return PlaneAnalysis(
        cell_pos=cell_pos,
        cell_clusters=cell_clusters,
        particle_area=int(out.particle_area),
        merged_clusters=merged_clusters,
        _denoised_dev=out.den,
        _filled_dev=out.filled,
        filled_particle_area=int(out.particle_area) + int(host(out.overlap_counts).sum()),
        num_regions=num,
    )


def _group_regions(regions: List[Region], g_row: np.ndarray) -> List[dict]:
    """Group regions sharing a dilated-component root (reference :843-875).

    ``g_row[label]`` is the dilated-mask component root under the region's
    truncated centroid (-1 = background → region silently dropped, matching
    the reference's ``dilated_label_value > 0`` guard).  Single O(N) pass —
    the reference rescans all regions per group (O(N²), SURVEY §2.6).
    """
    members: dict = {}
    for region in regions:
        g = int(g_row[region.label])
        if g >= 0:
            members.setdefault(g, []).append(region)
    groups: List[dict] = []
    emitted = set()
    for region in regions:  # group order = first-member order (reference)
        g = int(g_row[region.label])
        if g < 0 or g in emitted:
            continue
        touching = members[g]
        areas = [r.area for r in touching]
        centroid = np.average([r.centroid for r in touching], axis=0, weights=areas)
        groups.append(
            {
                "area": sum(areas),
                "centroid": centroid,
                "regions": touching,
                "bbox": (
                    min(r.bbox[0] for r in touching),
                    min(r.bbox[1] for r in touching),
                    max(r.bbox[2] for r in touching),
                    max(r.bbox[3] for r in touching),
                ),
            }
        )
        emitted.add(g)
    return groups
