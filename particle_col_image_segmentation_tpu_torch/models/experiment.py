"""Experiment orchestration: folder → analysis → CSV/figures.

Counterpart of ``particle_col_image_segmentation_tpu/models/experiment.py``:
host-side code mirroring the reference tiff_analysis.py's two entry
flows, ``process_single_h5_file`` (:627-671) and ``process_multiple_h5_files``
(:92-222), with all pixel work on one torch device (``device``: CUDA runs the
kernels, the CPU the plain versions), or with every plane's rows in bands
over a mesh's space axis (``mesh``).  The CSVs equal the JAX package's byte
for byte.  No learned
weights: what the two packages share is the frozen ``AnalysisConfig``
(the port's own, same fields) and the label planes, read as numpy arrays.

Faithful ordering quirks preserved:
  * single-file: counts/densities use the PRE-fill particle area (:647-648),
    while both position CSVs use the POST-fill area (:651,668-670);
  * multi-file: the RFP channel's recreated particle area is authoritative
    (:128-132) and all CSVs/densities use it.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch.config import (
    BASE_TYPE_MAP,
    CELL_TYPES,
    DEFAULT_CONFIG,
    AnalysisConfig,
)
from particle_col_image_segmentation_tpu_torch.io.discovery import (
    get_h5_files_recursively,
    get_pos_and_density_file_names,
)
from particle_col_image_segmentation_tpu_torch.io.hdf5 import load_h5_plane
from particle_col_image_segmentation_tpu_torch.labels import classmaps
from particle_col_image_segmentation_tpu_torch.oracle.reference_pipeline import (
    get_cell_counts_and_densities,
    normalize_ds_arr,
)
from particle_col_image_segmentation_tpu_torch.report.csvio import (
    write_cell_position_info,
    write_density_info,
    write_merged_cell_position_info,
)
from particle_col_image_segmentation_tpu_torch.labels.analysis import (
    analyze_planes_device,
    dapi_dedup_device,
    split_plane_device_out,
)
from particle_col_image_segmentation_tpu_torch.models.multichannel import fuse_channels
from particle_col_image_segmentation_tpu_torch.models.single_channel import (
    PlaneAnalysis,
    _as_static,
    analyze_plane,
    host,
)
from particle_col_image_segmentation_tpu_torch.parallel.mesh import require_one_process
from particle_col_image_segmentation_tpu_torch.parallel.sharded import make_sharded_dapi_dedup_fn
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

LoadFn = Callable[[str], np.ndarray]


def process_h5_folder(
    cur_folder: str,
    h5_files: List[str],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    make_figures: bool = True,
    mesh=None,
    device_outs: Optional["_BatchedDeviceOuts"] = None,
    *,
    device="cuda",
    load_fn: LoadFn = load_h5_plane,
) -> None:
    """Dispatch single vs multi-channel (reference :85-89).  ``device_outs``
    provides precomputed ``(PlaneDeviceOut, ds_arr)`` pairs from a batched
    run (``run_analysis(batch_planes=N)``); ``load_fn`` reads one plane;
    ``mesh`` splits every plane's rows over its space axis (results
    identical to the one-device run)."""
    kw = dict(device=device, device_outs=device_outs, load_fn=load_fn, mesh=mesh)
    if len(h5_files) == 1:
        process_single_h5_file(cur_folder, h5_files[0], cfg, make_figures, **kw)
    else:
        process_multiple_h5_files(cur_folder, h5_files, cfg, make_figures, **kw)


def _load_or_precomputed(full_file_path, cfg, device_outs, load_fn):
    """(ds_arr, device_out-or-None) — consume a batched precompute when one
    exists for this file, else load + normalize.  Consumption is one-shot:
    the provider drops its reference so device buffers free as folders
    complete (see _BatchedDeviceOuts)."""
    pre = device_outs.get(full_file_path) if device_outs is not None else None
    if pre is not None:
        return pre[1], pre[0]
    return normalize_ds_arr(load_fn(full_file_path), cfg), None


def process_single_h5_file(
    cur_folder: str,
    file_path: str,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    make_figures: bool = True,
    mesh=None,
    device_outs: Optional["_BatchedDeviceOuts"] = None,
    *,
    device="cuda",
    load_fn: LoadFn = load_h5_plane,
) -> PlaneAnalysis:
    """Single-file flow (reference :627-671)."""
    full_file_path = os.path.join(cur_folder, file_path)
    density_path, cell_pos_path = get_pos_and_density_file_names(cur_folder)
    base_name = full_file_path.replace(".h5", "")
    # basename of the RESOLVED path: a trailing-slash folder would make
    # split("/")[-1] empty, corrupting density-CSV keys and figure titles
    processed_folder = os.path.basename(os.path.abspath(cur_folder))

    cell_types = classmaps.get_cell_type_map(file_path)
    ds_arr, device_out = _load_or_precomputed(full_file_path, cfg, device_outs, load_fn)
    with stage("analyze_plane", device=device):
        res = analyze_plane(ds_arr, cell_types, cfg, merged=True,
                            device_out=device_out, device=device, mesh=mesh)

    # counts/densities use the PRE-fill particle area (reference :647-648)
    cell_count, cell_density, cell_area_ratio = get_cell_counts_and_densities(
        res.cell_pos, res.cell_clusters, res.particle_area, cfg
    )

    if make_figures:
        from particle_col_image_segmentation_tpu_torch.viz.figures import (
            create_single_plots,
            get_color_map,
            plot_original_vs_merged,
        )

        cmap, norm = get_color_map(cell_types)
        create_single_plots(
            ds_arr, cmap, norm, processed_folder, base_name, res.denoised,
            res.filled, cell_positions=res.cell_pos, cell_clusters=res.cell_clusters,
        )
        plot_original_vs_merged(
            res.denoised, res.merged_clusters, res.cell_clusters, cell_types,
            processed_folder, base_name,
        )

    # position CSVs use the POST-fill area (reference :651,668-670)
    write_cell_position_info(
        res.cell_pos, res.cell_clusters, cell_pos_path, res.filled_particle_area, cfg
    )
    merged_path = cell_pos_path.replace("_cell_pos.csv", "_merged_cell_pos.csv")
    write_merged_cell_position_info(
        res.merged_clusters, merged_path, res.filled_particle_area, cfg
    )
    write_density_info(
        density_path, processed_folder, cell_density, cell_area_ratio, cell_count
    )
    return res


def process_multiple_h5_files(
    cur_folder: str,
    h5_files: List[str],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    make_figures: bool = True,
    mesh=None,
    device_outs: Optional["_BatchedDeviceOuts"] = None,
    *,
    device="cuda",
    load_fn: LoadFn = load_h5_plane,
) -> Dict[str, PlaneAnalysis]:
    """Multi-channel fusion flow (reference :92-222)."""
    density_path, cell_pos_path = get_pos_and_density_file_names(cur_folder)
    raw_path = cell_pos_path.replace("_cell_pos.csv", "_cell_pos_raw.csv")
    combined_path = cell_pos_path.replace("_cell_pos.csv", "_cell_pos_combined.csv")
    processed_folder = os.path.basename(os.path.abspath(cur_folder))

    rfp_particle_area: Optional[int] = None
    master_cell_pos: Dict[str, list] = {}
    master_cell_clusters: Dict[str, list] = {}
    channel_ds_arrs: Dict[str, torch.Tensor] = {}
    dapi_cell_types = None
    results: Dict[str, PlaneAnalysis] = {}
    cell_strains = classmaps.get_strains_from_path(cur_folder)
    base_name = None

    for file in h5_files:
        full_file_path = os.path.join(cur_folder, file)
        channel = classmaps.get_channel_from_path(file)
        cell_types = classmaps.get_cell_type_map_from_channel(cell_strains, channel)
        strain_type = cell_types[1]
        base_name = full_file_path.replace(".h5", "")
        ds_arr, device_out = _load_or_precomputed(
            full_file_path, cfg, device_outs, load_fn
        )
        with stage("analyze_plane", device=device):
            res = analyze_plane(ds_arr, cell_types, cfg, merged=False,
                                device_out=device_out, device=device, mesh=mesh)
        results[channel] = res
        # keep the device plane — fusion/dedup consume it on the device;
        # figures trigger the host copy lazily via res.denoised
        channel_ds_arrs[channel] = res._denoised_dev

        overlap_arr = None
        if channel == "RFP":
            # RFP establishes the authoritative particle area (reference
            # :128-132): base + absorbed overlap from the fill pass.
            rfp_particle_area = res.filled_particle_area
            overlap_arr = res.filled
            if strain_type == "Particle":  # no cell class on this plane
                continue
        elif channel == "DAPI":
            dapi_cell_types = cell_types
        if strain_type not in CELL_TYPES:
            raise ValueError(f"Strain type not in cell types. {strain_type}")

        if make_figures:
            from particle_col_image_segmentation_tpu_torch.viz.figures import (
                create_channel_plots,
                get_color_map,
            )

            cmap, norm = get_color_map(cell_types)
            create_channel_plots(
                ds_arr, strain_type, cmap, norm,
                f"{processed_folder}_{channel}", base_name, res.denoised,
                overlap_arr, cell_positions=res.cell_pos,
                cell_clusters=res.cell_clusters,
            )
        master_cell_pos.update(res.cell_pos)
        master_cell_clusters.update(res.cell_clusters)

    if rfp_particle_area is None:
        raise ValueError("RFP particle area not found")

    write_cell_position_info(
        master_cell_pos, master_cell_clusters, raw_path, rfp_particle_area, cfg
    )

    if len(cell_strains) > 1:
        other_name = "GFP" if cell_strains == ["6B07", "C3M10"] else "RFP"
        missing = [c for c in ("DAPI", other_name) if c not in channel_ds_arrs]
        if missing:
            # a bare KeyError here left partial output (the raw CSV is
            # already written) with no hint which capture the folder lacks
            raise ValueError(
                f"multi-strain folder {processed_folder!r} is missing the "
                f"{'/'.join(missing)} channel file(s) needed for DAPI "
                f"dedup (have: {sorted(channel_ds_arrs)})"
            )
        other = channel_ds_arrs[other_name]
        if mesh is not None:
            dedup_fn = make_sharded_dapi_dedup_fn(mesh, cfg, max_iters=cfg.sharded_max_iters)
            dapi_b, dedup_num, dedup_conv_b = dedup_fn(channel_ds_arrs["DAPI"][None], other[None])
            dapi_dev, dedup_conv = dapi_b[0], dedup_conv_b[0]
            # convergence first: an unconverged plane's region count is
            # garbage, and a bogus max_regions error would name the wrong
            # remedy
            if bool(dedup_conv) and int(dedup_num[0]) > cfg.max_regions:
                # overflowing regions get no overlap row (sharded contract)
                raise ValueError(
                    f"DAPI plane has {int(dedup_num[0])} components > "
                    f"max_regions={cfg.max_regions}; raise "
                    "AnalysisConfig.max_regions"
                )
        else:
            dapi_dev, dedup_conv = dapi_dedup_device(channel_ds_arrs["DAPI"], other, cfg)
        if not bool(dedup_conv):
            raise RuntimeError(
                "DAPI-dedup CCL did not converge within the kernel budget"
            )
        # The reference analyzes the already-denoised deduped plane directly
        # (:168) — no second median pass; the plane stays on the device.
        dapi_res = analyze_plane(
            dapi_dev, dapi_cell_types, cfg, merged=False, denoise=False, mesh=mesh,
        )
        master_cell_pos["6B07"] = dapi_res.cell_pos.get("6B07", [])
        master_cell_clusters["6B07"] = dapi_res.cell_clusters.get("6B07", [])

        if make_figures:
            from particle_col_image_segmentation_tpu_torch.viz.figures import (
                get_color_map,
                visualize_dapi_overlap_results,
            )

            cmap, norm = get_color_map(BASE_TYPE_MAP)
            dapi_cmap, dapi_norm = get_color_map(dapi_cell_types)
            other_np = host(other)
            other_updated = other_np.copy()
            other_updated[other_np == 3] = 5
            other_updated[other_np == 2] = 4
            if other_name == "GFP":
                other_updated[other_np == 1] = 3
            visualize_dapi_overlap_results(
                host(channel_ds_arrs["DAPI"]), other_updated, host(dapi_dev),
                cmap, norm, dapi_cmap, dapi_norm, processed_folder, base_name,
                other_name,
            )

    cell_counts, cell_densities, cell_area_ratios = get_cell_counts_and_densities(
        master_cell_pos, master_cell_clusters, rfp_particle_area, cfg
    )
    write_density_info(
        density_path, processed_folder, cell_densities, cell_area_ratios, cell_counts
    )

    # fused plane is built from denoised channels — no second median pass
    # (reference :206 analyzes combined_channels directly); it stays on the
    # device (figures make a host copy only when actually drawn)
    try:
        fused_dev = fuse_channels(channel_ds_arrs, cell_strains)
    except KeyError as e:
        raise ValueError(
            f"folder {processed_folder!r} lacks the channel file for "
            f"{e.args[0]!r} needed by the fused analysis "
            f"(have: {sorted(channel_ds_arrs)})"
        ) from e
    with stage("analyze_plane_fused", device=device):
        fused_res = analyze_plane(
            fused_dev, BASE_TYPE_MAP, cfg, merged=True, denoise=False, mesh=mesh,
        )
    merged_clusters = fused_res.merged_clusters

    if make_figures and base_name is not None:
        from particle_col_image_segmentation_tpu_torch.viz.figures import (
            create_plot,
            get_color_map,
            plot_original_vs_merged,
        )

        cmap, norm = get_color_map(BASE_TYPE_MAP)
        fused = host(fused_dev)
        plot_original_vs_merged(
            fused, merged_clusters, master_cell_clusters, BASE_TYPE_MAP,
            processed_folder, base_name,
        )
        create_plot(
            fused, cmap, norm, f"{base_name}_combined_channels.png",
            cell_positions=master_cell_pos, cell_clusters=master_cell_clusters,
            title=f"{processed_folder} Combined Channels",
        )

    write_cell_position_info(
        master_cell_pos, master_cell_clusters, combined_path, rfp_particle_area, cfg
    )
    merged_path = combined_path.replace("_cell_pos_combined.csv", "_merged_cell_pos.csv")
    write_merged_cell_position_info(merged_clusters, merged_path, rfp_particle_area, cfg)
    return results


class _BatchedDeviceOuts:
    """Streaming provider of batched device analyses for a folder tree.

    The reference's outermost parallel axis is its folder loop
    (tiff_analysis.py:1126-1134).  This provider groups the tree's planes by
    (cell-type map, merge mode) IN FOLDER ORDER into chunks of
    ``batch_planes`` and runs ``analyze_planes_device`` once per chunk — only
    when the folder flow first asks for a plane of that chunk (lazy) — and
    each ``get`` hands the plane's device out away for good (consume-once),
    so finished folders' buffers free at once.

    Memory bound: a ``get`` miss computes ONE chunk, and entries drop as
    folders consume them.  Chunks are built per (map, merge mode) key, so a
    tree whose folders hold C channel files keeps up to C keys' chunks
    filling side by side: a miss can leave the straggler planes of every
    other key's current chunk live, so live planes stay below about
    C·batch_planes (below 2·batch_planes only on single-file trees).
    ``peak_live`` is tracked.  Decoded host planes stream the same way.

    Per-plane slices equal the folder flow's own single-plane analysis, so
    CSVs stay byte-identical.  Only the plain per-channel analyses batch:
    the per-folder deduped-DAPI and fused re-analyses depend on earlier
    results and stay inline.
    """

    def __init__(self, folders: Dict[str, List[str]], cfg: AnalysisConfig,
                 batch_planes: int, device, load_fn: LoadFn = load_h5_plane):
        self._cfg = cfg
        self._device = device
        self._load_fn = load_fn
        tasks = []  # (full_path, static cell_types, compute_merge)
        for folder, files in folders.items():
            if len(files) == 1:
                ct = _as_static(classmaps.get_cell_type_map(files[0]))
                tasks.append((os.path.join(folder, files[0]), ct, True))
            else:
                strains = classmaps.get_strains_from_path(folder)
                for f in files:
                    channel = classmaps.get_channel_from_path(f)
                    ct = _as_static(
                        classmaps.get_cell_type_map_from_channel(strains, channel)
                    )
                    tasks.append((os.path.join(folder, f), ct, False))

        self._chunks: List[tuple] = []  # (fps tuple, ct, merged)
        self._chunk_of: Dict[str, int] = {}
        pending: Dict[tuple, list] = {}  # (ct, merged) -> fps
        for fp, ct, merged in tasks:
            key = (ct, merged)
            pending.setdefault(key, []).append(fp)
            if len(pending[key]) == batch_planes:
                self._flush(pending.pop(key), key)
        for key, fps in pending.items():
            self._flush(fps, key)

        self._done: set = set()
        self._ready: dict = {}
        self.live = 0
        self.peak_live = 0

    def _flush(self, fps, key):
        if len(fps) == 1:
            return  # a 1-plane batch saves nothing; the folder flow runs it
        ci = len(self._chunks)
        self._chunks.append((tuple(fps), *key))
        for fp in fps:
            self._chunk_of[fp] = ci

    def _compute(self, ci: int) -> None:
        self._done.add(ci)
        fps, ct, merged = self._chunks[ci]
        arrs = {fp: normalize_ds_arr(self._load_fn(fp), self._cfg) for fp in fps}
        by_shape: Dict[tuple, list] = {}
        for fp in fps:
            by_shape.setdefault(arrs[fp].shape, []).append(fp)
        for sfps in by_shape.values():
            if len(sfps) == 1:
                continue  # odd-shaped straggler: the folder flow runs it
            stack = torch.from_numpy(np.stack([arrs[fp] for fp in sfps])).to(self._device)
            with stage("analyze_planes_batch", device=self._device):
                out = analyze_planes_device(stack, ct, self._cfg, compute_merge=merged)
            for b, fp in enumerate(sfps):
                self._ready[fp] = (split_plane_device_out(out, b), arrs[fp])
                self.live += 1
        self.peak_live = max(self.peak_live, self.live)

    def get(self, fp: str):
        """Pop this plane's (device_out, ds_arr) — computing its chunk on
        first touch — or None if it was never batched (singletons)."""
        if fp not in self._ready:
            ci = self._chunk_of.get(fp)
            if ci is None or ci in self._done:
                return None
            self._compute(ci)
            if fp not in self._ready:
                return None
        self.live -= 1
        return self._ready.pop(fp)


def run_analysis(
    top_level_folder: str,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    make_figures: bool = True,
    mesh=None,
    batch_planes: int = 1,
    *,
    device="cuda",
    load_fn: LoadFn = load_h5_plane,
) -> None:
    """Top-level entry point (reference main, :1126-1134) on one torch ``device``
    (default the card, ``cuda``; ``"cpu"`` runs the plain versions).
    ``mesh`` (it takes the place of ``device``) splits every plane's rows
    into bands over the mesh's space axis (CLI ``analyze --space-parallel``).
    ``batch_planes`` > 1 batches same-shape planes from the whole tree into
    single device launches (CLI ``analyze --batch-planes``; byte-identical
    CSVs, mutually exclusive with ``mesh``).  ``load_fn`` reads one plane
    from a discovered path (default: the HDF5 reader).  It runs in one
    process: a mesh whose rows span processes raises."""
    require_one_process(mesh, "run_analysis")
    device = torch.device(device) if mesh is None else mesh.flat[0]
    folders = get_h5_files_recursively(top_level_folder)
    device_outs = None
    if batch_planes > 1:
        if mesh is not None:
            raise ValueError(
                "batch_planes batches whole planes per device and cannot "
                "combine with space sharding — pass one or the other"
            )
        device_outs = _BatchedDeviceOuts(folders, cfg, batch_planes, device, load_fn)
    for folder, files in folders.items():
        process_h5_folder(folder, files, cfg, make_figures, device=device,
                          device_outs=device_outs, load_fn=load_fn, mesh=mesh)
