"""Whole-experiment batch pipeline (bench config #5) on PyTorch.

Counterpart of ``particle_col_image_segmentation_tpu/models/batch.py``:
prefetching host loader → fused segmentation of each batch on one device,
on every device of a mesh's data axis (``make_fused_segment_fn``), or with
each plane's rows in bands over its space axis as well
(``make_space_sharded_segment_fn``) → per-plane stat tables → caller's sink,
with a restartable manifest.  The 4-bit packed transfers of the JAX version
are not part of this port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Sequence, Tuple

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch._relay import refuse_relay_arg
from particle_col_image_segmentation_tpu_torch.config import DEFAULT_CONFIG, AnalysisConfig
from particle_col_image_segmentation_tpu_torch.labels import classmaps
from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger
from particle_col_image_segmentation_tpu_torch.io.loader import batched_device_iterator
from particle_col_image_segmentation_tpu_torch.ops.ccl import (
    compact_labels_auto,
    connected_components_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import median_label_filter_auto
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import region_counts_auto
from particle_col_image_segmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    make_mesh,
    require_one_process,
    run_per_device,
)
from particle_col_image_segmentation_tpu_torch.parallel.sharded import shard_rows
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

_log = get_logger("batch")


def derive_class_values(folder_to_files):
    """{full_path: (particle_val, cell_vals)} via the analyze dispatch rules.

    Single-file folders read strains from the file name; multi-file folders
    read the per-channel map from folder strains + file channel token.
    Paths whose names carry no recognizable tokens fall back to (2, (1,))
    with a warning — the streaming path must not die on one odd file.
    """
    out = {}
    for folder, files in folder_to_files.items():
        for f in files:
            full = os.path.join(folder, f)
            try:
                if len(files) == 1:
                    ct = classmaps.get_cell_type_map(f)
                else:
                    strains = classmaps.get_strains_from_path(folder)
                    channel = classmaps.get_channel_from_path(f)
                    ct = classmaps.get_cell_type_map_from_channel(strains, channel)
                inv = {v: k for k, v in ct.items()}
                cells = tuple(
                    k for k, v in ct.items() if v not in ("Particle", "Background")
                )
                out[full] = (inv["Particle"], cells)
            except (ValueError, KeyError, IndexError) as e:
                # IndexError: get_channel_from_path with no channel token
                _log.warning("no class map derivable for %s (%s); using defaults", full, e)
                out[full] = (2, (1,))
    return out


@dataclasses.dataclass
class PlaneStats:
    """Per-plane headline statistics from the fused pass."""

    num_regions: int
    particle_px: int
    cell_px: int
    class_px: np.ndarray  # [num_classes] pixel histogram
    # True when num_regions > cfg.max_regions: components past capacity were
    # dropped from the tables, so the pixel stats UNDERCOUNT.  Re-run the
    # plane with a larger AnalysisConfig.max_regions.
    overflow: bool = False
    # False when a fixpoint exhausted its iteration budget: the labels (and
    # every stat) are INVALID for this plane, and it is not marked done.
    converged: bool = True


def fused_segment_batch(
    imgs: torch.Tensor,
    cfg: AnalysisConfig,
    particle_val: int = 2,
    cell_vals: Tuple[int, ...] = (1,),
    packed: bool = False,
):
    """[B,H,W] uint8 → (seg [B,H,W], num [B], area-table [B,R+1],
    class-table [B,R+1], particle_px [B], cell_px [B], class_px
    [B,num_classes], converged [B]); int32 but ``converged`` (bool).

    CUDA tensors run the kernels K1-K4, CPU tensors their plain versions.
    ``packed`` (nibble-packed input) is a relay argument: only False binds.
    """
    refuse_relay_arg("fused_segment_batch", "packed", packed, False)
    den = median_label_filter_auto(imgs, cfg.denoise_size, cfg.num_classes)
    raw, conv_ccl = connected_components_auto(
        den, background=None, num_classes=cfg.num_classes, with_flag=True,
        max_iters=cfg.ccl_max_iters,
    )
    seg, num, conv_cmp = compact_labels_auto(raw, cfg.max_regions, with_flag=True)
    areas, classes = region_counts_auto(
        seg, den, cfg.max_regions, val_bound=cfg.num_classes - 1
    )
    class_px, particle_px, cell_px = _pixel_stats_from_tables(
        areas, classes, cfg, particle_val, cell_vals
    )
    converged = conv_ccl & conv_cmp  # per plane [B]
    return seg, num, areas, classes, particle_px, cell_px, class_px, converged


def make_fused_segment_fn(mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
                          packed: bool = False):
    """Data-parallel fused pass over ``mesh``'s data axis: a callable that
    takes one [b,H,W] chunk a device (in mesh order, each on its device) and
    returns ``fused_segment_batch``'s outputs for each, in the same order.

    Planes are independent, so each device runs the whole per-plane pipeline
    on its chunk with no communication (the JAX package's ``shard_map`` over
    "data"), one worker thread a device (``parallel.run_per_device``).  On a
    mesh whose rows span processes it runs this process's devices only
    (``Mesh.local``): one chunk each.
    ``packed`` is a relay argument: only False binds."""
    refuse_relay_arg("make_fused_segment_fn", "packed", packed, False)
    if mesh.shape[SPACE_AXIS] > 1:
        raise ValueError(
            f"make_fused_segment_fn runs whole planes: a mesh with a space axis "
            f"(n_space = {mesh.shape[SPACE_AXIS]}) takes make_space_sharded_segment_fn"
        )
    devices = list(mesh.local().flat)
    cell_vals = tuple(cell_vals)

    def fn(chunks):
        return run_per_device(
            lambda x: fused_segment_batch(x, cfg, particle_val, cell_vals),
            devices, [(x,) for x in chunks],
        )

    return fn


def make_space_sharded_segment_fn(
    mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
    max_iters=None,
):
    """The fused pass with each plane's rows in bands over ``mesh``'s space
    axis (and its planes over the data axis): a callable that takes one
    [b, H/n_space, W] band a mesh position (``mesh.flat`` order, each on
    its device; ``parallel.sharded.split_bands``) and returns, for each data
    row, ``fused_segment_batch``'s outputs on the row's first device, but
    ``seg`` as the tuple of the row's bands.

    The band-sharded CCL, compaction and tables run as in
    ``parallel.sharded``; the per-plane pixel stats come from the summed
    region tables exactly as in the one-device pass, so the overflow
    semantics (ids past ``cfg.max_regions`` dropped) match it.
    ``max_iters`` is kept for the JAX signature (its distributed fixpoints'
    budget); the seam join is exact in one pass."""
    del max_iters
    cell_vals = tuple(cell_vals)

    def fn(bands):
        outs = []
        for r in shard_rows(bands, mesh, cfg, particle_val, cell_vals, tables="counts",
                            need_lab=False, need_fill=False):
            class_px, particle_px, cell_px = _pixel_stats_from_tables(
                r["area"], r["class_id"], cfg, particle_val, cell_vals
            )
            outs.append((tuple(r["seg"]), r["n_comp"], r["area"], r["class_id"],
                         particle_px, cell_px, class_px, r["converged"]))
        return outs

    return fn


def _stats_host(out) -> np.ndarray:
    """The per-plane scalars of one ``fused_segment_batch`` output as one
    host [B, 4+C] array: num, particle_px, cell_px, converged, class_px.
    ONE readback (one host sync) a call."""
    _, num, _, _, particle_px, cell_px, class_px, converged = out
    return torch.cat(
        [num[:, None], particle_px[:, None], cell_px[:, None],
         converged[:, None].to(num.dtype), class_px],
        dim=-1,
    ).cpu().numpy()


def _pixel_stats_from_tables(areas, classes, cfg: AnalysisConfig,
                             particle_val: int, cell_vals):
    """Per-plane pixel histograms reduced over the [R+1] region tables
    (every pixel belongs to exactly one class-homogeneous region).  Requires
    num ≤ cfg.max_regions (ids past capacity are dropped from the tables);
    callers check ``num``."""
    class_px = torch.stack(
        [
            torch.where(classes == v, areas, 0).sum(-1, dtype=torch.int32)
            for v in range(cfg.num_classes)
        ],
        dim=-1,
    )
    particle_px = class_px[..., particle_val]
    # empty cell_vals (e.g. an RFP plane with no cell class) must still
    # yield a [B] tensor, not Python 0
    cell_px = (
        sum(class_px[..., v] for v in cell_vals)
        if cell_vals
        else torch.zeros_like(particle_px)
    )
    return class_px, particle_px, cell_px


def run_batch(
    paths: Sequence[str],
    load_fn: Callable[[str], np.ndarray],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    batch_size: int = 4,
    particle_val: int = 2,
    cell_vals: Tuple[int, ...] = (1,),
    manifest=None,
    sharding=None,
    mesh=None,
    pack_transfer: bool = False,
    on_error: str = "skip",
    *,
    device: torch.device = "cuda",
) -> Iterator[Tuple[str, PlaneStats]]:
    """Stream per-plane stats for every path on ``device`` (default the
    card, ``cuda``; ``"cpu"`` runs the plain versions); skips
    manifest-completed units.

    Pass ``mesh`` (``parallel.make_mesh``; it takes the place of
    ``device``) to run data-parallel: each batch splits over the data
    axis's devices (``batch_size`` must be a multiple of its size), each
    device runs the fused pass on its chunk, and the stats are read back
    once a device a batch and joined in plane order.  A mesh with a space
    axis also splits each plane's rows into that many bands, one a device
    (the plane height must be a multiple of it;
    ``make_space_sharded_segment_fn``).  Without a mesh, the batch runs on a
    one-device mesh of ``device``, in the caller's thread.

    By default a plane whose decode raises is logged and skipped — one
    corrupt file must not kill a 100k-plane run.  Skipped planes are never
    marked done, so a resume (after fixing the file) retries exactly those;
    callers without a manifest should diff the yielded paths against their
    input (or pass ``on_error="raise"`` to fail fast).

    The arguments bind in the JAX package's order; ``sharding`` and
    ``pack_transfer`` are its relay arguments, and only their defaults
    bind.
    """
    refuse_relay_arg("run_batch", "sharding", sharding, None)
    refuse_relay_arg("run_batch", "pack_transfer", pack_transfer, False)
    require_one_process(mesh, "run_batch")
    todo = [p for p in paths if manifest is None or not manifest.is_done(p)]
    if len(todo) < len(paths):
        _log.info("manifest: skipping %d completed planes", len(paths) - len(todo))
    if mesh is None:
        mesh = make_mesh(devices=[device])
    devices = list(mesh.flat)
    n_data, n_space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    if batch_size % n_data:
        raise ValueError(
            f"run_batch: batch_size {batch_size} is not a multiple of the mesh's "
            f"data axis ({n_data})"
        )
    if n_space > 1:
        segment_fn = make_space_sharded_segment_fn(mesh, cfg, particle_val, cell_vals)
    else:
        segment_fn = make_fused_segment_fn(mesh, cfg, particle_val, cell_vals)
    # the span's events sit on the first device's stream; the other cards
    # are synchronised before it closes, so it covers the whole mesh
    others = {d for d in devices[1:] if d.type == "cuda" and d != devices[0]}
    it = batched_device_iterator(
        load_fn, todo, batch_size=batch_size, devices=devices, on_error=on_error,
        with_paths=True, n_space=n_space,
    )
    for chunks, count, batch_paths in it:
        H, W = chunks[0].shape[-2] * n_space, chunks[0].shape[-1]
        with stage("fused_segment", device=devices[0], megapixels=count * H * W / 1e6):
            outs = segment_fn(chunks)
            for d in others:
                torch.cuda.current_stream(d).synchronize()
        # ONE host readback per device (data row) per batch, joined in plane
        # order; the outputs (the labels) go before the next batch's pass runs
        stats_host = np.concatenate([_stats_host(out) for out in outs])
        del outs
        num = stats_host[:, 0]
        particle_px = stats_host[:, 1]
        cell_px = stats_host[:, 2]
        conv_host = stats_host[:, 3]
        class_px = stats_host[:, 4:]
        for b in range(count):
            path = batch_paths[b]
            converged = bool(conv_host[b])
            if not converged:
                _log.error(
                    "%s: CCL exhausted its iteration budget — stats INVALID "
                    "for this plane; not marking done (pathological geometry; "
                    "raise AnalysisConfig.ccl_max_iters)", path,
                )
            overflow = int(num[b]) > cfg.max_regions
            if overflow:
                _log.warning(
                    "%s: %d components > max_regions=%d — stats undercount; "
                    "not marking done, so a re-run with a larger "
                    "AnalysisConfig.max_regions retries this plane",
                    path, int(num[b]), cfg.max_regions,
                )
            stats = PlaneStats(
                num_regions=int(num[b]),
                particle_px=int(particle_px[b]),
                cell_px=int(cell_px[b]),
                class_px=class_px[b],
                overflow=overflow,
                converged=converged,
            )
            # yield FIRST, mark done after: if the consumer crashes while
            # recording this plane the plane stays unmarked and a resume
            # retries it — at-least-once, never a done-but-unrecorded gap.
            # Overflowed and unconverged planes are also left unmarked.
            yield path, stats
            if manifest is not None and converged and not overflow:
                meta = {
                    "regions": stats.num_regions,
                    "particle_px": stats.particle_px,
                }
                manifest.mark_done(path, meta=meta)
