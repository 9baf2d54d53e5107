"""Watershed boundary refinement (``pcis refine``) on PyTorch.

Counterpart of ``particle_col_image_segmentation_tpu/models/refine.py``
(reference refine_boundaries.py, completed): an Ilastik probability export →
boundary mask → exact EDT → plateau-aware local maxima → marker CCL and
compaction → two-phase watershed → centroid table → nearest-neighbour
distances → per-cell CSV.  All pixel work runs on the tensors' device: CUDA
tensors through K9 (the EDT's capped probe), K2 (plateaus and markers), K3
(compaction), K10/K11 (watershed) and K7 (centroid table), CPU tensors
through the plain versions.  Every stage is batched over planes, and each
plane's result equals its single-plane run.

``RefineConfig.tunnel_basins`` floods with basin tunnelling
(``ops.watershed`` docstring): on CUDA tensors K10 for phase 1, K2 for the
basins and a plain PyTorch phase 2 in place of K11, bounded by
``watershed_max_iters`` steps.

``refine_boundaries_sharded`` runs a stack over a mesh.  On a data axis
alone, plane chunks run ``refine_plane_device`` on their own devices, one
worker thread a device.  A space axis splits each plane's rows into bands,
one a device (``parallel.sharded.make_sharded_refine_fn``: K9's windowed
probe, K2/K3/K6 and a host seam join for the maxima and markers, K10/K11's
band modes coupled by halo rows, K7 in the plane's rows).  With
``tunnel_basins`` the chunks go to every device of the mesh, as in the JAX
package.  Each plane's result equals ``refine_boundaries_stack``'s.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch.config import RefineConfig
from particle_col_image_segmentation_tpu_torch.ops.ccl import (
    compact_labels_auto,
    connected_components_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.edt import sqrt_f32
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import (
    edt_sq_auto,
    edt_sq_exact_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.morphology import local_maxima_auto
from particle_col_image_segmentation_tpu_torch.ops.pairwise import (
    min_dist_to_set,
    nearest_neighbor_dists,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops import CentroidTable, centroids_f64
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import centroid_sums_auto
from particle_col_image_segmentation_tpu_torch.ops.watershed import watershed_auto
from particle_col_image_segmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    make_mesh,
    require_one_process,
    run_per_device,
)
from particle_col_image_segmentation_tpu_torch.parallel.sharded import make_sharded_refine_fn

__all__ = [
    "RefineResult",
    "refine_plane_device",
    "refine_boundaries",
    "refine_boundaries_stack",
    "refine_boundaries_sharded",
    "write_refine_csv",
    "write_refine_stack_csv",
    "cross_strain_distances",
]


def refine_plane_device(boundary_map: torch.Tensor, cfg: RefineConfig,
                        max_regions: int = 4095):
    """Probability map [..., H, W] → (labels, markers, num_cells, table,
    distance, converged) on the map's device.  ``max_regions`` is 4095, so
    tables have 4096 rows, as in the JAX package."""
    binary_mask = boundary_map < cfg.boundary_threshold  # reference :44-45
    # reference :60: the distance of object pixels to the nearest boundary
    # pixel, exact by default (a cap would merge deep plateaus into one marker)
    if cfg.edt_cap is None:
        dsq = edt_sq_exact_auto(~binary_mask, probe_cap=cfg.edt_probe_cap)
    else:
        dsq = edt_sq_auto(~binary_mask, cfg.edt_cap)
    distance = sqrt_f32(dsq)
    # maxima of d² are maxima of d, and int32 d² compares stay exact where
    # adjacent float32 square roots would round together
    maxima, conv_max = local_maxima_auto(dsq, with_flag=True)
    raw, conv_ccl = connected_components_auto(
        maxima.to(torch.uint8), background=0, num_classes=2, with_flag=True
    )
    markers, num, conv_cmp = compact_labels_auto(raw, max_regions, with_flag=True)
    labels, conv_ws = watershed_auto(
        boundary_map.to(torch.float32), markers, binary_mask, with_flag=True,
        max_iters=cfg.watershed_max_iters, tunnel_basins=cfg.tunnel_basins,
    )
    table = centroid_sums_auto(labels, max_regions)
    converged = conv_max & conv_ccl & conv_cmp & conv_ws
    return labels, markers, num, table, distance, converged


@dataclasses.dataclass
class RefineResult:
    labels: np.ndarray  # [H,W] per-cell labels after watershed split
    num_cells: int
    areas: np.ndarray  # [num_cells] px²
    centroids: np.ndarray  # [num_cells, 2] (row, col) float64
    nn_distances: np.ndarray  # [num_cells] same-set nearest-neighbor, px


def _host_table(table):
    return type(table)(*(t.cpu().numpy() for t in table))


def refine_boundaries(probabilities: np.ndarray, cfg: RefineConfig = RefineConfig(),
                      max_regions: int = 4095, *, device="cuda") -> RefineResult:
    """Full refinement of one plane of an Ilastik probability export on
    ``device`` (default the card, ``cuda``; ``"cpu"`` runs the plain
    versions).

    Accepts the raw export with channels on either end — [C,H,W] or [H,W,C]
    — or an [H,W] boundary map.  The channel axis is whichever end is small
    enough to be one (≤ 8), preferring the reference's axis 0.
    """
    arr = _extract_boundary_channel(np.asarray(probabilities), cfg, ndim=2)
    labels, _, num, table, _, converged = refine_plane_device(
        torch.as_tensor(np.asarray(arr, np.float32), device=torch.device(device)),
        cfg, max_regions,
    )
    if not bool(converged):
        raise RuntimeError(
            "refine fixpoints (CCL/compaction/watershed) did not converge "
            "within the kernel iteration budgets — labels are invalid"
        )
    n = int(num)
    if n > max_regions:
        raise ValueError(f"{n} cells > max_regions={max_regions}")
    table = _host_table(table)
    cy, cx = centroids_f64(table)
    pts = np.stack([cy, cx], axis=1)[1 : n + 1]
    areas = np.asarray(table.area)[1 : n + 1]
    if n > 1:
        nn = nearest_neighbor_dists(
            torch.as_tensor(pts.astype(np.float32), device=labels.device),
            torch.ones(n, dtype=torch.bool, device=labels.device),
        ).cpu().numpy()
    else:
        nn = np.full((n,), np.inf, np.float32)
    return RefineResult(
        labels=labels.cpu().numpy(), num_cells=n, areas=areas, centroids=pts,
        nn_distances=nn,
    )


def _reject_channel_last_plane(probs: np.ndarray) -> None:
    """The stack entry point rejects a SINGLE [H, W, C] channel-last export:
    flooding it as H planes of [W, C] would silently produce garbage."""
    if probs.ndim == 3 and probs.shape[-1] <= 8:
        raise ValueError(
            f"shape {probs.shape} looks like a single [H, W, C] plane "
            "(trailing axis <= 8 can only be channels) — refine it as a "
            "single plane (refine_boundaries / stack=False), or pass a "
            "[Z, H, W(, C)] stack"
        )


def _extract_boundary_channel(arr: np.ndarray, cfg: RefineConfig, ndim: int):
    """Strip the (small, ≤ 8) channel axis off either end, reference axis
    first (``ndim`` = expected spatial rank of the result)."""
    if arr.ndim == ndim + 1:
        # the non-trailing channel axis sits just before (H, W) in both
        # [C, H, W] and [Z, C, H, W] layouts
        if arr.shape[-3] <= 8:
            arr = arr[..., cfg.boundary_channel, :, :]
        elif arr.shape[-1] <= 8:
            arr = np.ascontiguousarray(arr[..., cfg.boundary_channel])
        else:
            raise ValueError(f"No channel axis of size <= 8 in shape {arr.shape}")
    elif arr.ndim != ndim:
        raise ValueError(f"expected rank {ndim} or {ndim + 1}, got {arr.shape}")
    return arr


def refine_boundaries_stack(probabilities: np.ndarray, cfg: RefineConfig = RefineConfig(),
                            max_regions: int = 4095, *, device="cuda") -> List[RefineResult]:
    """Refine a whole probability STACK — [Z, H, W], [Z, C, H, W] or
    [Z, H, W, C] — in one batched pass on ``device`` (default ``cuda``).
    Each plane's result equals ``refine_boundaries`` on that plane."""
    probs = np.asarray(probabilities)
    _reject_channel_last_plane(probs)
    arr = _extract_boundary_channel(probs, cfg, ndim=3)
    return _refine_data_parallel(arr, cfg, max_regions, [torch.device(device)],
                                 check_fits=False)


def _check_stack_converged(converged) -> None:
    conv = np.atleast_1d(np.asarray(converged))
    if not conv.all():
        bad = np.nonzero(~conv)[0].tolist()
        raise RuntimeError(
            f"refine fixpoints did not converge on plane(s) {bad} within "
            "the kernel iteration budgets — labels are invalid"
        )


def _assemble_stack_results(labels_np: np.ndarray, nums: np.ndarray, table,
                            max_regions: int, device) -> List[RefineResult]:
    """RefineResults from stacked outputs (``table`` needs the area and
    the four digit-sum columns, as host arrays)."""
    cy, cx = centroids_f64(table)  # [Z, R+1] each
    areas_all = np.asarray(table.area)
    Z = labels_np.shape[0]
    max_n = int(nums.max()) if Z else 0
    if max_n > max_regions:
        bad = int(np.argmax(nums))
        raise ValueError(
            f"plane {bad}: {int(nums[bad])} cells > max_regions={max_regions}"
        )
    results = []
    for z in range(Z):
        n = int(nums[z])
        pts = np.stack([cy[z], cx[z]], axis=1)[1 : n + 1]
        nn = nearest_neighbor_dists(
            torch.as_tensor(pts.astype(np.float32), device=device),
            torch.ones(n, dtype=torch.bool, device=device),
        ).cpu().numpy()
        results.append(RefineResult(
            labels=labels_np[z], num_cells=n, areas=areas_all[z][1 : n + 1],
            centroids=pts, nn_distances=nn,
        ))
    return results


def refine_boundaries_sharded(probabilities: np.ndarray, cfg: RefineConfig = RefineConfig(),
                              max_regions: int = 4095, mesh=None,
                              stack: "bool | None" = None) -> List[RefineResult]:
    """Refine over a device mesh (default: every CUDA card on the data axis,
    ``parallel.make_mesh()``); the CLI's ``refine --data-parallel`` and
    ``--space-parallel``.

    ``stack`` selects the input interpretation exactly like the CLI flag:
    False → a single plane ([H,W] / [C,H,W] / [H,W,C], refine_boundaries
    semantics, returned as a 1-element list); True → a z-stack ([Z,H,W] /
    [Z,C,H,W] / [Z,H,W,C], refine_boundaries_stack semantics); None
    (default) → stack iff 4-D.  The EDT is always exact on this path
    (``cfg.edt_cap`` does not apply).  Per-plane results equal
    ``refine_boundaries_stack``'s.

    On a data axis alone, Z is padded to a multiple of the device count by
    repeating the last plane (padding results are dropped), and each device
    refines its contiguous chunk of planes.  A space axis larger than 1
    splits each plane's rows into bands, one a device (the plane height
    must be a multiple of it), with Z padded to a multiple of the data
    axis: ``make_sharded_refine_fn``, whose watershed counts
    ``cfg.watershed_max_iters`` rounds of band fixpoints (and as many passes
    a band a round); a plane that does not converge raises.

    ``cfg.tunnel_basins`` runs data-parallel over ALL mesh devices, whatever
    the space axis (each plane floods on one device; see
    ``_check_tunnel_chunk_fits``).  It runs in one process: a mesh whose
    rows span processes raises.
    """
    require_one_process(mesh, "refine_boundaries_sharded")
    probs = np.asarray(probabilities)
    if stack is None:
        stack = probs.ndim == 4
    if stack:
        _reject_channel_last_plane(probs)
        arr = _extract_boundary_channel(probs, cfg, ndim=3)
    else:
        arr = _extract_boundary_channel(probs, cfg, ndim=2)[None]
    if mesh is None:
        mesh = make_mesh()
    if cfg.tunnel_basins:
        # the tunnelled claim key has no halo-exchange schedule: planes go
        # data-parallel to every device of the mesh, each flooding on one
        return _refine_data_parallel(arr, cfg, max_regions, list(mesh.flat), check_fits=True)
    if mesh.shape[SPACE_AXIS] > 1:
        return _refine_space_parallel(arr, cfg, max_regions, mesh)
    return _refine_data_parallel(arr, dataclasses.replace(cfg, edt_cap=None), max_regions,
                                 list(mesh.flat), check_fits=False)


def _refine_space_parallel(arr: np.ndarray, cfg: RefineConfig, max_regions: int,
                           mesh) -> List[RefineResult]:
    """Planes ``arr`` [Z,H,W] through ``make_sharded_refine_fn`` on
    ``mesh`` (Z padded to a multiple of the data axis by repeating the
    last plane, results dropped); the CSV's areas and centroids come from
    the sharded centroid sums."""
    n_data = mesh.shape[DATA_AXIS]
    Z = arr.shape[0]
    pad = (-Z) % n_data
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    fn = make_sharded_refine_fn(
        mesh, threshold=cfg.boundary_threshold, max_regions=max_regions,
        max_iters=cfg.watershed_max_iters, with_tables=True, probe_cap=cfg.edt_probe_cap,
    )
    labels, _, num, converged, sums = fn(np.asarray(arr, np.float32))
    _check_stack_converged(converged.cpu().numpy()[:Z])
    cols = sums.cpu().numpy()[:Z]
    table = CentroidTable(*(cols[..., i] for i in range(5)))
    return _assemble_stack_results(labels.cpu().numpy()[:Z], num.cpu().numpy()[:Z], table,
                                   max_regions, mesh.flat[0])


def _refine_data_parallel(arr: np.ndarray, cfg: RefineConfig, max_regions: int, devices,
                          check_fits: bool) -> List[RefineResult]:
    """Planes ``arr`` [Z,H,W] in contiguous chunks, chunk i through
    ``refine_plane_device`` on ``devices[i]`` (one worker thread a device,
    the caller's thread for one device); Z pads to a multiple of the device
    count by repeating the last plane (results dropped)."""
    n_dev = len(devices)
    Z = arr.shape[0]
    pad = (-Z) % n_dev
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    per = arr.shape[0] // n_dev
    if check_fits:
        _check_tunnel_chunk_fits(arr.shape[-2:], per, devices[0])
    arr = np.asarray(arr, np.float32)

    def work(i: int, device):
        chunk = torch.as_tensor(arr[i * per:(i + 1) * per], device=device)
        labels, _, num, table, _, converged = refine_plane_device(chunk, cfg, max_regions)
        return labels.cpu(), num.cpu(), _host_table(table), converged.cpu()

    outs = run_per_device(work, devices, list(enumerate(devices)))
    labels = torch.cat([o[0] for o in outs]).numpy()[:Z]
    num = torch.cat([o[1] for o in outs]).numpy()[:Z]
    table = type(outs[0][2])(*(np.concatenate(cols)[:Z] for cols in zip(*(o[2] for o in outs))))
    _check_stack_converged(torch.cat([o[3] for o in outs]).numpy()[:Z])
    return _assemble_stack_results(labels, num, table, max_regions, devices[0])


# The tunnelled refine's working set, bytes a pixel of a chunk: the smoke
# measured 4.156 GiB above an [8,2048²] input on the H100 (about 133 B a
# pixel), rounded up.  Tripping early costs a clearer error; tripping late
# costs a device OOM.
_TUNNEL_BYTES_PER_PX = 160
# A device that reports no memory size (the CPU) is held to 16 GiB, the
# JAX package's figure.
_DEFAULT_DEVICE_BYTES = 16 * 1024**3


def _check_tunnel_chunk_fits(plane_shape, planes_per_device, device) -> None:
    """Size guard for the tunnelled data-parallel refine: a plateau-heavy
    export too large for one device would otherwise head straight for an
    out-of-memory error (the tunnelled claim key is single-device only — see
    refine_boundaries_sharded's docstring).  Raises with the alternatives
    instead.  The limit is the card's memory, ``_DEFAULT_DEVICE_BYTES`` for
    a device that reports none."""
    H, W = plane_shape
    need = H * W * planes_per_device * _TUNNEL_BYTES_PER_PX
    device = torch.device(device)
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
    else:
        limit = _DEFAULT_DEVICE_BYTES
    if need > limit:
        raise ValueError(
            f"tunnel_basins chunk ({planes_per_device} plane(s) of {H}x{W}, "
            f"~{need / 1e9:.1f} GB working set) exceeds one device's memory "
            f"(~{limit / 1e9:.1f} GB); the tunneled claim key runs single-"
            "device only.  Alternatives: (a) untunneled sharded refine "
            "(tunnel_basins=False — rows shard across the mesh; the default "
            "key is >=0.99 IoU in the pipeline regime), or (b) tile the "
            "plane and refine tiles independently if its basins are local."
        )


def _refine_rows(result: RefineResult, prefix: tuple = ()):
    """One row per cell (shared by the plane and stack CSV writers so the
    rounding / inf-sentinel format cannot diverge)."""
    for i in range(result.num_cells):
        cy, cx = result.centroids[i]
        nn = result.nn_distances[i]
        yield [*prefix, i + 1, round(float(cx), 2), round(float(cy), 2),
               int(result.areas[i]),
               "" if not np.isfinite(nn) else round(float(nn), 3)]


def write_refine_stack_csv(results: List[RefineResult], path: str) -> None:
    """Per-cell table across a refined stack (plane column + the
    write_refine_csv schema)."""
    with open(path, "w") as f:
        w = csv.writer(f)
        w.writerow(["plane", "cell", "x_pos", "y_pos", "area_px", "nn_distance_px"])
        for z, result in enumerate(results):
            w.writerows(_refine_rows(result, prefix=(z,)))


def write_refine_csv(result: RefineResult, path: str) -> None:
    """Per-cell table of a refined plane: cell id, position, area and
    nearest-neighbour distance in px (the reference docstring's goal 2)."""
    with open(path, "w") as f:
        w = csv.writer(f)
        w.writerow(["cell", "x_pos", "y_pos", "area_px", "nn_distance_px"])
        w.writerows(_refine_rows(result))


def cross_strain_distances(a_centroids: np.ndarray, b_centroids: np.ndarray,
                           *, device="cuda") -> Dict[str, np.ndarray]:
    """Goal (3b) of the reference docstring: each cell's distance to the
    nearest cell of the *other* strain, both directions."""
    a = torch.as_tensor(np.asarray(a_centroids, np.float32), device=torch.device(device))
    b = torch.as_tensor(np.asarray(b_centroids, np.float32), device=torch.device(device))
    return {
        "a_to_b": min_dist_to_set(a, b, torch.ones(b.shape[0], dtype=torch.bool,
                                                   device=a.device)).cpu().numpy(),
        "b_to_a": min_dist_to_set(b, a, torch.ones(a.shape[0], dtype=torch.bool,
                                                   device=a.device)).cpu().numpy(),
    }
