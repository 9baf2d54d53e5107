"""Device-side region analytics: the per-plane analysis graph of ``analyze``.

Counterpart of ``particle_col_image_segmentation_tpu/labels/analysis.py``.
All O(H·W) work of a plane — denoise, CCL, compaction, the full region
table, particle fill, the proximity-merge grouping inputs, DAPI dedup — runs
on the plane's device: CUDA tensors through the kernels K1–K6, K8 and K9, CPU
tensors through their plain versions.  The O(regions) bookkeeping stays on
the host (``models.single_channel``).

There are no learned weights.  What crosses between this module and the JAX
one is the frozen ``AnalysisConfig`` (the port's own, same fields) and the label planes,
handed to both as numpy arrays; PyTorch runs eagerly, so the JAX module's
per-stage ``jit`` has no counterpart here.

Reference counterparts: tiff_analysis.py:742-789 (positions/areas),
:826-883 (merge), :931-1015 (particle fill), :252-287 (DAPI dedup).
``analyze_plane_device_sharded`` runs the same graph with the plane's rows in
bands over a mesh's space axis (``parallel.sharded``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from particle_col_image_segmentation_tpu_torch.config import CELL_TYPES, AnalysisConfig
from particle_col_image_segmentation_tpu_torch.ops.ccl import (
    compact_labels_auto,
    connected_components_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.fill_tiles import particle_fill_step_auto
from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import median_label_filter_auto
from particle_col_image_segmentation_tpu_torch.ops.morphology import dilate_disk
from particle_col_image_segmentation_tpu_torch.ops.regionprops import RegionTable, centroids_int
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (
    region_props_auto,
    region_sums_auto,
    table_lookup_auto,
)
from particle_col_image_segmentation_tpu_torch.parallel.mesh import DATA_AXIS
from particle_col_image_segmentation_tpu_torch.parallel.sharded import (
    make_sharded_full_analysis_fn,
)

__all__ = [
    "PlaneDeviceOut",
    "analyze_plane_device",
    "analyze_planes_device",
    "analyze_plane_device_sharded",
    "dapi_dedup_device",
    "split_plane_device_out",
    "strain_values_of",
]


class PlaneDeviceOut(NamedTuple):
    den: torch.Tensor  # [H,W] denoised label plane
    seg: torch.Tensor  # [H,W] compact component ids (1..n, raster order)
    num: torch.Tensor  # scalar int32: true component count
    table: RegionTable  # [R+1] region properties
    particle_area: torch.Tensor  # scalar int32: particle pixels pre-fill
    filled: torch.Tensor  # [H,W] plane after particle fill
    overlap_counts: torch.Tensor  # [n_strains] int32 absorbed px per strain
    g_ctx: torch.Tensor  # [n_strains+1, R+1] merge-group root per region
    #   (contexts: each strain in map order, then the combined union;
    #    -1 = centroid not on any dilated component)
    converged: torch.Tensor  # scalar bool: every fixpoint reached its
    #   fixpoint within budget; False ⇒ labels/tables are invalid


def strain_values_of(cell_types: Tuple[Tuple[int, str], ...]):
    """(value, name) pairs of strain classes, in map (value) order."""
    return tuple((v, n) for v, n in cell_types if n in CELL_TYPES)


def _particle_value(cell_types):
    for v, n in cell_types:
        if n == "Particle":
            return v
    raise ValueError("cell_types has no Particle class")


def _stage_segment(img, cfg: AnalysisConfig, denoise: bool, particle_val: int):
    den = (
        median_label_filter_auto(img, cfg.denoise_size, cfg.num_classes)
        if denoise
        else img
    )
    raw, conv_ccl = connected_components_auto(
        den, background=None, num_classes=cfg.num_classes, with_flag=True,
        max_iters=cfg.ccl_max_iters,
    )
    seg, num, conv_cmp = compact_labels_auto(raw, cfg.max_regions, with_flag=True)
    table = region_props_auto(seg, den, cfg.max_regions)
    # per-plane sum, so the stage takes [H,W] and [B,H,W] alike
    particle_area = (den == particle_val).sum(dim=(-2, -1), dtype=torch.int32)
    return den, seg, num, table, particle_area, conv_ccl & conv_cmp


def _stage_fill(den, cfg: AnalysisConfig, particle_val: int, strain_vals):
    # Sequential over strains on purpose: pixels absorbed for strain k expand
    # the particle mask seen by strain k+1, exactly as the reference's loop
    # reassigns ds_arr each iteration (tiff_analysis.py:931-1015).
    cap = max(cfg.dilation_radius, cfg.distance_threshold)
    dt2 = cfg.distance_threshold * cfg.distance_threshold
    dr2 = cfg.dilation_radius * cfg.dilation_radius
    filled = den
    overlaps = []
    for sval in strain_vals:
        filled, ov = particle_fill_step_auto(filled, particle_val, sval, cap, dt2, dr2)
        overlaps.append(ov)
    # [n_strains] for [H,W] input, [n_strains, B] for [B,H,W]
    if overlaps:
        return filled, torch.stack(overlaps)
    return filled, torch.zeros((0,) + den.shape[:-2], dtype=torch.int32, device=den.device)


def _stage_merge_batch(den, table: RegionTable, cfg: AnalysisConfig, strain_vals):
    """For each context (each strain's class mask, then the union of all
    strain masks): dilate by disk(r), label, and read the raw component root
    under every region's truncated centroid (tiff_analysis.py:826-851).  The
    S·B context planes of a [B, H, W] stack label in ONE CCL launch.
    Returns (g_ctx [S, B, R+1], converged [B])."""
    B, H, W = den.shape
    icy, icx = centroids_int(table)  # [B, R+1] each
    icy = icy.clamp(0, H - 1)
    icx = icx.clamp(0, W - 1)
    masks = [den == sval for sval in strain_vals]  # each [B, H, W]
    union = torch.zeros((B, H, W), dtype=torch.bool, device=den.device)
    for m in masks:
        union = union | m
    S = len(masks) + 1
    dil = dilate_disk(torch.stack(masks + [union]).reshape(S * B, H, W),
                      cfg.merge_disk_radius)
    # background=None keeps every pixel labelled (bg pixels form inert
    # components); centroids off the dilated mask map to -1 below
    ctx_raw, conv = connected_components_auto(
        dil.to(torch.uint8), background=None, num_classes=2, with_flag=True,
        max_iters=cfg.ccl_max_iters,
    )
    R1 = icy.shape[-1]
    flat_idx = (icy * W + icx).to(torch.int64)[None].expand(S, B, R1).reshape(S * B, R1)
    g = torch.gather(ctx_raw.reshape(S * B, H * W), 1, flat_idx)
    on_mask = torch.gather(dil.reshape(S * B, H * W), 1, flat_idx)
    g_ctx = torch.where(on_mask, g, -1).reshape(S, B, R1)
    return g_ctx, conv.reshape(S, B).all(dim=0)


def _stage_merge(den, table: RegionTable, cfg: AnalysisConfig, strain_vals):
    """``_stage_merge_batch`` of one [H, W] plane → (g_ctx [S, R+1],
    converged scalar)."""
    g_ctx, conv = _stage_merge_batch(
        den[None], RegionTable(*(leaf[None] for leaf in table)), cfg, strain_vals
    )
    return g_ctx[:, 0], conv[0]


def analyze_planes_device(
    imgs: torch.Tensor,
    cell_types: Tuple[Tuple[int, str], ...],
    cfg: AnalysisConfig,
    compute_merge: bool = True,
    denoise: bool = True,
) -> PlaneDeviceOut:
    """Full device analysis of a same-shape plane stack [B, H, W] — the
    reference's folder loop (tiff_analysis.py:1126-1134) batched into single
    launches.

    Every stage is batch-polymorphic, so per-plane results are identical to
    B separate ``analyze_plane_device`` calls.  Leaves carry a leading batch
    axis (``overlap_counts`` is [n_strains, B], ``g_ctx`` [S, B, R+1]); slice
    per plane with ``split_plane_device_out``.

    Args:
      imgs: [B, H, W] small-int class planes (raw, pre-denoise), on the
        device to run on.
      cell_types: static tuple of (pixel value, class name) in value order.
      cfg: the AnalysisConfig.
      compute_merge: also compute proximity-merge grouping inputs
        (reference ``merged=True`` path).
      denoise: median-filter first.  False for planes already denoised (the
        reference's deduped-DAPI and fused-channel re-analyses).
    """
    strain_vals = tuple(v for v, _ in strain_values_of(cell_types))
    particle_val = _particle_value(cell_types)
    if imgs.ndim != 3:
        raise ValueError(f"expected [B, H, W], got {tuple(imgs.shape)}")
    den, seg, num, table, particle_area, conv = _stage_segment(
        imgs, cfg, denoise, particle_val
    )
    filled, overlap_counts = _stage_fill(den, cfg, particle_val, strain_vals)
    if compute_merge:
        g_ctx, conv_merge = _stage_merge_batch(den, table, cfg, strain_vals)
        conv = conv & conv_merge
    else:
        g_ctx = torch.full(
            (len(strain_vals) + 1, imgs.shape[0], cfg.max_regions + 1), -1,
            dtype=torch.int32, device=imgs.device,
        )
    return PlaneDeviceOut(
        den=den, seg=seg, num=num, table=table, particle_area=particle_area,
        filled=filled, overlap_counts=overlap_counts, g_ctx=g_ctx, converged=conv,
    )


def split_plane_device_out(out: PlaneDeviceOut, b: int) -> PlaneDeviceOut:
    """Plane ``b`` of a batched ``analyze_planes_device`` result, in the
    single-plane layout ``analyze_plane`` consumes."""
    return PlaneDeviceOut(
        den=out.den[b],
        seg=out.seg[b],
        num=out.num[b],
        table=RegionTable(*(leaf[b] for leaf in out.table)),
        particle_area=out.particle_area[b],
        filled=out.filled[b],
        overlap_counts=out.overlap_counts[:, b],
        g_ctx=out.g_ctx[:, b],
        converged=out.converged[b],
    )


def analyze_plane_device(
    img: torch.Tensor,
    cell_types: Tuple[Tuple[int, str], ...],
    cfg: AnalysisConfig,
    compute_merge: bool = True,
    denoise: bool = True,
) -> PlaneDeviceOut:
    """Full device analysis of one [H, W] label plane: the stack path on a
    batch of one (arguments as ``analyze_planes_device``)."""
    if img.ndim != 2:
        raise ValueError(f"expected [H, W], got {tuple(img.shape)}")
    out = analyze_planes_device(img[None], cell_types, cfg, compute_merge, denoise)
    return split_plane_device_out(out, 0)


def analyze_plane_device_sharded(
    img,
    cell_types: Tuple[Tuple[int, str], ...],
    cfg: AnalysisConfig,
    mesh,
    compute_merge: bool = True,
    denoise: bool = True,
) -> PlaneDeviceOut:
    """``analyze_plane_device`` of one [H, W] plane (NumPy or a tensor) with
    its rows in bands over ``mesh``'s space axis (``parallel.sharded``):
    the same PlaneDeviceOut, every leaf equal to the one-device graph's
    (``g_ctx`` included: both hold each dilated component's minimum linear
    index), on the mesh's first device."""
    if mesh.shape[DATA_AXIS] != 1:
        raise ValueError(
            f"analyze shards ONE plane at a time: the mesh data axis must "
            f"be 1, got {dict(mesh.shape)} — build it with "
            "make_mesh(n_data=1, n_space=N) (use models.batch.run_batch "
            "for data-parallel many-plane runs)"
        )
    strain_vals = tuple(v for v, _ in strain_values_of(cell_types))
    fn = make_sharded_full_analysis_fn(
        mesh, cfg, particle_val=_particle_value(cell_types), cell_vals=strain_vals,
        max_iters=cfg.sharded_max_iters, denoise=denoise, with_merge=compute_merge,
        need_lab=False,
    )
    (den, _, particle_ct, n_comp, filled, overlap_strain, conv, seg,
     area, class_id, sr_hi, sr_lo, sc_hi, sc_lo, bbox, g_ctx) = fn(img[None])
    R1 = cfg.max_regions + 1
    table = RegionTable(
        area=area[0], sr_hi=sr_hi[0], sr_lo=sr_lo[0], sc_hi=sc_hi[0], sc_lo=sc_lo[0],
        bbox=bbox[0], class_id=class_id[0],
        valid=(area[0] > 0) & (torch.arange(R1, device=area.device) > 0),
    )
    return PlaneDeviceOut(
        den=den[0], seg=seg[0], num=n_comp[0], table=table,
        particle_area=particle_ct[0], filled=filled[0],
        overlap_counts=overlap_strain[0], g_ctx=g_ctx[0], converged=conv[0],
    )


def dapi_dedup_device(dapi: torch.Tensor, other: torch.Tensor, cfg: AnalysisConfig):
    """Remove DAPI cells overlapping the other channel's cells (reference
    :252-287, vectorized: per-region overlap via segment sums).

    Cells (value 1) whose component overlaps the other channel's cell mask by
    more than ``cfg.dapi_overlap_threshold`` of their area become value 2.
    The ratio is float32, as in the JAX package: with ov = 1 and area = 10 it
    is not above a 0.1 threshold, where a float64 ratio would be.

    Returns (updated plane, converged bool scalar).
    """
    dapi_mask = dapi == 1
    other_mask = other == 1
    # background=None: bg pixels form (inert) labelled components too; the
    # removal test is masked by dapi_mask below, so bg rows never act
    raw, conv_ccl = connected_components_auto(
        dapi_mask.to(torch.uint8), background=None, num_classes=2,
        with_flag=True, max_iters=cfg.ccl_max_iters,
    )
    seg, _, conv_cmp = compact_labels_auto(raw, cfg.max_regions, with_flag=True)
    R1 = cfg.max_regions + 1
    area, ov = region_sums_auto(seg, other_mask.to(torch.int32), cfg.max_regions)
    frac = ov.to(torch.float32) / area.clamp(min=1).to(torch.float32)
    row = torch.arange(R1, device=dapi.device)
    remove = (frac > cfg.dapi_overlap_threshold) & (row > 0)
    remove_px = (table_lookup_auto(seg, remove.to(torch.int32)) > 0) & dapi_mask
    return torch.where(remove_px, 2, dapi), conv_ccl & conv_cmp
