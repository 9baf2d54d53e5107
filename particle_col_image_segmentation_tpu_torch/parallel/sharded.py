"""Plane rows in bands over the mesh's space axis: the band-sharded segment,
region tables, particle fill, merge grouping, DAPI dedup and refine.

Counterpart of ``particle_col_image_segmentation_tpu/parallel/sharded.py``
(``make_sharded_segment_fn``, ``make_sharded_analysis_fn``,
``make_sharded_full_analysis_fn``, ``sharded_segment_batch``,
``make_sharded_dapi_dedup_fn``, ``make_sharded_refine_fn``,
``make_sharded_watershed_fn``).  Planes split over the mesh's "data" axis
and each plane's rows into ``n_space`` contiguous bands, one a mesh
position.  The outputs equal the single-device graph's.

The JAX package runs one ``shard_map`` whose fixpoints exchange halos every
round.  Here each step runs on every band's device at once (one worker
thread a position, ``parallel.mesh.run_per_device``, where the mesh spans
several devices), and a small step on the host joins the bands between
them:

* windowed steps (the median, the particle fill, the merge dilation) read
  halo rows copied from the neighbouring bands (``parallel.halo``) and run
  the kernels' band modes: K1 on a row-padded band, K8 counting its own
  rows only, K5 in the plane's rows;
* the CCL runs K2 on each band, and K3 ranks each band's roots.  The host
  then reads each band's first and last rows, unions the equal-valued
  8-connected pairs across every seam of a plane at once (one union-find),
  and gives each band a table: K6 maps a band's local root ranks to global
  raster ranks (roots on earlier bands, minus the roots that merged into a
  smaller one, plus — for the merged ones — the rank of their global root,
  found on the band that owns it), and its local roots to the global
  minimum linear index, the JAX package's labels.  The join is exact in one
  pass, so no iteration budget applies to it (``max_iters`` is kept for the
  JAX signatures only; the bands' own CCL keeps ``cfg.ccl_max_iters``);
* the refine's EDT runs K9 on each band with a cap-row halo, its flag
  raised by the band's own rows, and the exact transform over the gathered
  plane where a band flags; its maxima and markers take the CCL above (a
  plateau is "bad" if any band's piece of it is, the markers' join skips
  background); its watershed runs rounds of band fixpoints (K10 and K11
  resume each band under frozen halo rows) with the halo rows exchanged
  between rounds until no band's edge rows change, which reaches the
  plane's unique fixpoint (``ops.watershed``).

On a mesh whose data rows span processes (``parallel.mesh.initialize_multihost``)
every factory takes the global [B, H, W] batch and runs only the positions
of this process's rows (``_positions``, ``split_bands``): it returns this
process's planes, ``B · n_local_rows / n_data`` of them, and
``process_allgather(..., tiled=True)`` gives the global outputs.  A plane
never crosses a process, so nothing here talks to another process.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
from particle_col_image_segmentation_tpu_torch.ops.ccl import (
    compact_labels_auto,
    connected_components_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.edt import minplus_rows, row_dh2_exact
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_auto
from particle_col_image_segmentation_tpu_torch.ops.fill_tiles import particle_fill_step_auto
from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import (
    median_label_filter_rows_padded_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.morphology import (
    _OFFSETS8,
    _has_higher,
    _marked_components,
    dilate_disk,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops import RegionTable, centroids_int
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (
    centroid_sums_auto,
    region_props_auto,
    region_sums_auto,
    table_lookup_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.watershed import (
    claim_labels_band_auto,
    minimax_costs_band_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
    _BIG_LAB,
    _INF as _WS_INF,
)
from particle_col_image_segmentation_tpu_torch.parallel.halo import pad_with_halo
from particle_col_image_segmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    run_per_device,
)

__all__ = [
    "split_bands",
    "join_bands",
    "sharded_segment_batch",
    "make_sharded_segment_fn",
    "make_sharded_analysis_fn",
    "make_sharded_full_analysis_fn",
    "make_sharded_dapi_dedup_fn",
    "make_sharded_refine_fn",
    "make_sharded_watershed_fn",
]

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1

def _each(fn, devices: Sequence[torch.device], args: Sequence[tuple]) -> list:
    """``[fn(*args[i])]``, call ``i`` on ``devices[i]``: one worker thread a
    position where the positions span several devices, so that their work
    and host syncs overlap; one after another in the caller's thread where
    they all name one device, whose one stream would run them in turn
    anyway (on one H100 the workers made a 1×4 batch 18 % slower; on four,
    22 % faster)."""
    if len(set(devices)) > 1:
        return run_per_device(fn, devices, args)
    out = []
    for d, a in zip(devices, args):
        with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
            out.append(fn(*a))
    return out


# ---------------------------------------------------------------------------
# bands of a batch over a mesh
# ---------------------------------------------------------------------------


def _check_split(B: int, H: int, mesh) -> Tuple[int, int]:
    n_data, n_space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    if B % n_data:
        raise ValueError(f"{B} planes do not split over the mesh's data axis ({n_data})")
    if H % n_space:
        raise ValueError(
            f"plane height {H} is not a multiple of the mesh's space axis ({n_space})"
        )
    return B // n_data, H // n_space


def _positions(mesh) -> List[torch.device]:
    """The devices of the positions this process runs, row by row: the rows
    it owns (``Mesh.local``), every row of a one-process mesh.  The band
    lists below are in this order, and ``_rows_of`` indexes it."""
    return list(mesh.local().flat)


def split_bands(x, mesh) -> List[torch.Tensor]:
    """[B, H, W] (NumPy or a tensor) → one contiguous [B/n_data, H/n_space,
    W] band a mesh position (``mesh.flat`` order), each on its device:
    planes over "data", rows over "space".  On a mesh whose rows span
    processes, ``x`` is the global batch and only this process's positions
    get their bands."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.ndim != 3:
        raise ValueError(f"expected [B, H, W], got {tuple(x.shape)}")
    b, h = _check_split(x.shape[0], x.shape[1], mesh)
    return [
        x[r * b:(r + 1) * b, j * h:(j + 1) * h].to(d).contiguous()
        for r in mesh.local_rows() for j, d in enumerate(mesh.devices[r])
    ]


def join_bands(bands: Sequence[torch.Tensor], mesh, device=None) -> torch.Tensor:
    """``split_bands``' inverse: the [B, H, W] batch (this process's planes,
    on a mesh whose rows span processes) on ``device`` (default: the first
    device of this process's positions)."""
    device = torch.device(device) if device is not None else _positions(mesh)[0]
    n_space = mesh.shape[SPACE_AXIS]
    rows = [
        torch.cat([t.to(device) for t in bands[i:i + n_space]], dim=-2)
        for i in range(0, len(bands), n_space)
    ]
    return torch.cat(rows, dim=0)


def _rows_of(mesh) -> List[List[int]]:
    """The positions (``_positions`` indices) of each data row this process
    runs, in space order."""
    n_space = mesh.shape[SPACE_AXIS]
    n = len(_positions(mesh))
    return [list(range(i, i + n_space)) for i in range(0, n, n_space)]


def _pad_rows(bands, mesh, halo: int, edge_mode: str, fill=0) -> List[torch.Tensor]:
    """``pad_with_halo`` within each data row of a mesh's bands."""
    return [x for row in _rows_of(mesh)
            for x in pad_with_halo([bands[k] for k in row], halo, edge_mode, fill)]


# ---------------------------------------------------------------------------
# the CCL across bands
# ---------------------------------------------------------------------------


def _edge_rows(*planes) -> tuple:
    """Host int64 copies of each [b, h, W] band's first and last rows, [b, 2, W]."""
    h = planes[0].shape[-2]
    return tuple(
        p[:, [0, h - 1], :].to(torch.int64).cpu().numpy() if p is not None else None
        for p in planes
    )


def _band_ccl(val: torch.Tensor, max_iters: int, max_regions: int, num_classes: int,
              ranks: bool, background: Optional[int] = None):
    """K2 (and, with ``ranks``, K3) on one band [b, h, W]: labels hold the
    band's own minimum linear indices (−1 on ``background``).  Returns
    (lab, converged, seg_l, num_l, edges): ``seg_l`` the roots' raster ranks
    within the band (0 on background), ``edges`` the host rows the seam
    join reads.  ``max_iters`` bounds the plain CCL of a CPU band."""
    lab, conv = connected_components_auto(
        val, background=background, num_classes=num_classes, with_flag=True,
        max_iters=max_iters,
    )
    if not ranks:
        return lab, conv, None, None, _edge_rows(val, lab, None)
    seg_l, num_l = compact_labels_auto(lab, max_regions)
    return lab, conv, seg_l, num_l, _edge_rows(val, lab, seg_l) + (num_l.cpu().numpy(),)


def _first_of_runs(*arrays) -> np.ndarray:
    """Where an entry differs from the one before it in any of the
    equal-length 1-D ``arrays``: neighbouring pixels of a row mostly share
    their labels, so this drops most repeats before a sort."""
    keep = np.ones(len(arrays[0]), bool)
    if len(keep):
        keep[1:] = np.logical_or.reduce([x[1:] != x[:-1] for x in arrays])
    return keep


class _Join(NamedTuple):
    """What the seam join of one data row gives each band ``j``: the global
    root count ``num[j]`` and the roots on earlier bands ``before[j]`` (each
    [b]), and its merged roots ``dead[j]`` = (plane, local root index, local
    rank, global root, global rank), host int64 arrays."""

    num: Optional[np.ndarray]
    before: Optional[np.ndarray]
    dead: list


def _keys_of(j: int, lab_row, b: int, h: int, W: int, n: int):
    """[b, W] local labels of band j → seam keys, plane·H·W + the global
    linear index."""
    planes = np.arange(b, dtype=np.int64)[:, None]
    return planes * (n * h * W) + j * (h * W) + lab_row


def _seam_roots(edges: Sequence[tuple], h: int, W: int, background=None):
    """One union-find over every seam of a data row's planes: the
    equal-valued 8-connected pairs between band j's last row and band
    j+1's first row (pairs on ``background`` skipped).  Keys are
    plane·H·W + the pixel's global linear root index, so a component's
    global root is the minimum key it reaches.  Returns (keys, root): the
    sorted keys met on a seam and each one's global root."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(edges)
    b = edges[0][0].shape[0]

    ea, eb = [], []
    for j in range(n - 1):
        vt, kt = edges[j][0][:, 1], _keys_of(j, edges[j][1][:, 1], b, h, W, n)
        vb, kb = edges[j + 1][0][:, 0], _keys_of(j + 1, edges[j + 1][1][:, 0], b, h, W, n)
        for dx in (-1, 0, 1):  # top column c meets bottom column c + dx
            c0, c1 = max(0, -dx), W - max(0, dx)
            same = vt[:, c0:c1] == vb[:, c0 + dx:c1 + dx]
            if background is not None:
                same &= vt[:, c0:c1] != background
            ea.append(kt[:, c0:c1][same])
            eb.append(kb[:, c0 + dx:c1 + dx][same])
    a = np.concatenate(ea) if ea else np.zeros(0, np.int64)
    bb = np.concatenate(eb) if eb else np.zeros(0, np.int64)
    keep = _first_of_runs(a, bb)
    a, bb = a[keep], bb[keep]
    keys, inv = np.unique(np.concatenate([a, bb]), return_inverse=True)
    if len(keys):
        m = len(a)
        graph = coo_matrix((np.ones(m, np.int8), (inv[:m], inv[m:])), shape=(len(keys),) * 2)
        _, comp = connected_components(graph, directed=False)
        low = np.full(comp.max() + 1, np.iinfo(np.int64).max)
        np.minimum.at(low, comp, keys)
        root = low[comp]
    else:
        root = keys
    return keys, root


def _key_parts(keys, h: int, W: int, n: int):
    """(plane, band, local linear index) of seam keys."""
    plane = keys // (n * h * W)
    glob = keys - plane * (n * h * W)
    band = glob // (h * W)
    return plane, band, glob - band * (h * W)


def _value_at_keys(edges: Sequence[tuple], col: int, keys, h: int, W: int):
    """The component-constant edge value ``edges[j][col]`` of each seam key,
    read where the key's label shows in its band's first or last row
    (background pixels, label −1, hold no key)."""
    n = len(edges)
    b = edges[0][0].shape[0]
    at = [(j, r) for j in range(n) for r in (0, 1)]
    all_keys = np.concatenate([_keys_of(j, edges[j][1][:, r], b, h, W, n).ravel()
                               for j, r in at])
    values = np.concatenate([edges[j][col][:, r].ravel() for j, r in at])
    fg = np.concatenate([edges[j][1][:, r].ravel() >= 0 for j, r in at])
    all_keys, values = all_keys[fg], values[fg]
    keep = _first_of_runs(all_keys)
    uk, first = np.unique(all_keys[keep], return_index=True)
    return values[keep][first][np.searchsorted(uk, keys)]


def _join_seams(edges: Sequence[tuple], h: int, W: int, ranks: bool, background=None) -> _Join:
    """The seam join of a data row (``_seam_roots``): what each band needs
    to map its local roots and ranks to global ones."""
    n = len(edges)
    b = edges[0][0].shape[0]
    band_px, plane_px = h * W, n * h * W
    keys, root = _seam_roots(edges, h, W, background)
    plane, band, local = _key_parts(keys, h, W, n)
    dead = keys != root

    if ranks:
        rank = _value_at_keys(edges, 2, keys, h, W)
        num_l = np.stack([edges[j][3] for j in range(n)]).astype(np.int64)  # [n, b]
        ndead = np.zeros((n, b), np.int64)
        np.add.at(ndead, (band[dead], plane[dead]), 1)
        num = num_l - ndead
        before = np.cumsum(num, axis=0) - num
        # global rank of a live root: before + its rank among the band's
        # live roots (its local rank less the merged roots ranked before it)
        big = band_px + 1
        slot = band * b + plane
        dead_code = np.sort(slot[dead] * big + rank[dead])
        below = np.searchsorted(dead_code, slot * big + rank) - np.searchsorted(dead_code, slot * big)
        grank = before[band, plane] + rank - below
        grank = np.where(dead, grank[np.searchsorted(keys, root)], grank)
    else:
        num = before = None
        rank = grank = np.zeros_like(keys)
    groot = root - plane * plane_px
    dead_of = [
        tuple(x[dead & (band == j)] for x in (plane, local, rank, groot, grank))
        for j in range(n)
    ]
    return _Join(num, before, dead_of)


def _rank_table(seg_l, num_l_max: int, before, dead) -> torch.Tensor:
    """[b, K+1] int32 table from a band's local root ranks to global ones."""
    b, dev = seg_l.shape[0], seg_l.device
    plane, _, rank, _, grank = (torch.from_numpy(x).to(dev) for x in dead)
    K1 = num_l_max + 1
    table = torch.from_numpy(before).to(dev)[:, None] + torch.arange(K1, device=dev)
    merged = torch.zeros((b, K1), dtype=torch.int64, device=dev)
    merged[plane, rank] = 1
    table -= torch.cumsum(merged, dim=-1)
    table[plane, rank] = grank
    table[:, 0] = 0
    return table.to(torch.int32)


def _global_labels(lab, j: int, dead) -> torch.Tensor:
    """K6: a band's local labels → global minimum linear indices."""
    b, h, W = lab.shape
    dev = lab.device
    plane, local, _, groot, _ = (torch.from_numpy(x).to(dev) for x in dead)
    table = (torch.arange(h * W, dtype=torch.int32, device=dev) + j * h * W).expand(b, -1).clone()
    table[plane, local] = groot.to(torch.int32)
    return table_lookup_auto(lab, table)


def _compact(seg_l, num_l, before, dead) -> torch.Tensor:
    """K6: a band's local ranks → global raster ranks (1-based ids)."""
    return table_lookup_auto(seg_l, _rank_table(seg_l, int(num_l.max()), before, dead))


# ---------------------------------------------------------------------------
# tables joined over the bands
# ---------------------------------------------------------------------------


def _class_of(area: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    sums = sums.clamp(_I32_MIN, _I32_MAX)
    return torch.div(sums, area.clamp(min=1), rounding_mode="floor").to(torch.int32)


def _sum_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Σ of per-band tensors on ``device``, in int64."""
    return sum(p.to(device, torch.int64) for p in parts)


def _join_tables(tables: Sequence[RegionTable], sums, device) -> RegionTable:
    """The plane's RegionTable from its bands' (K5 in the plane's rows):
    counts and digit sums add, the bbox takes the extremes over the bands
    that hold the region, the class divides the summed values."""
    area = _sum_to([t.area for t in tables], device)
    digits = [_sum_to([getattr(t, f) for t in tables], device).to(torch.int32)
              for f in ("sr_hi", "sr_lo", "sc_hi", "sc_lo")]
    big = torch.tensor(_I32_MAX, device=device)
    lo = hi = None
    for t in tables:
        box = t.bbox.to(device)
        has = (t.area.to(device) > 0)[..., None]
        tl = torch.where(has, box[..., :2], big)
        br = torch.where(has, box[..., 2:], 0)
        lo = tl if lo is None else torch.minimum(lo, tl)
        hi = br if hi is None else torch.maximum(hi, br)
    bbox = torch.where((area > 0)[..., None], torch.cat([lo, hi], dim=-1), 0).to(torch.int32)
    R1 = area.shape[-1]
    return RegionTable(
        area=area.to(torch.int32), sr_hi=digits[0], sr_lo=digits[1], sc_hi=digits[2],
        sc_lo=digits[3], bbox=bbox, class_id=_class_of(area, _sum_to(sums, device)),
        valid=(area > 0) & (torch.arange(R1, device=device) > 0),
    )


# ---------------------------------------------------------------------------
# the band-sharded analysis of one mesh
# ---------------------------------------------------------------------------


def _neutral_value(particle_val: int, cell_vals) -> int:
    """A uint8 value that is neither the particle nor a strain: the rows
    past the plane's edges in the fill's halo."""
    used = {particle_val, *cell_vals}
    return next(v for v in range(256) if v not in used)


def _merge_groups(den_bands, table: RegionTable, cfg: AnalysisConfig, strain_vals,
                  devices, H: int):
    """``g_ctx`` [b, S+1, R+1] of one data row (``_stage_merge_batch`` on
    bands): per context (each strain, then their union) dilate by
    disk(r) with K9 on r-row halos, label with the cross-band CCL, and read
    the global root under each region's truncated centroid on the band that
    owns its row.  Returns (g_ctx on the row's first device, converged [b])."""
    n = len(den_bands)
    b, h, W = den_bands[0].shape
    S1 = len(strain_vals) + 1
    r = cfg.merge_disk_radius

    def contexts(den):
        masks = [den == v for v in strain_vals]
        union = torch.zeros_like(den, dtype=torch.bool)
        for m in masks:
            union = union | m
        return torch.stack(masks + [union]).reshape(S1 * b, h, W)

    padded = pad_with_halo([contexts(d) for d in den_bands], r, "constant", False)

    def label(ctx_p):
        dil = dilate_disk(ctx_p, r)[..., r:r + h, :].to(torch.uint8).contiguous()
        lab, conv, _, _, edges = _band_ccl(dil, cfg.ccl_max_iters, cfg.max_regions, 2,
                                           ranks=False)
        return dil, lab, conv, edges

    outs = _each(label, devices, [(p,) for p in padded])
    join = _join_seams([o[3] for o in outs], h, W, ranks=False)
    dev0 = den_bands[0].device
    icy, icx = centroids_int(table)
    icy = icy.clamp(0, H - 1)
    icx = icx.clamp(0, W - 1)
    owner = (icy // h).cpu().numpy()
    g = np.zeros((S1, b, icy.shape[-1]), np.int64)
    on = np.zeros(g.shape, bool)
    for j, (dil, lab, _, _) in enumerate(outs):
        d = dil.device
        idx = ((icy.to(d) - j * h).clamp(0, h - 1) * W + icx.to(d)).to(torch.int64)
        idx = idx[None].expand(S1, b, -1).reshape(S1 * b, -1)
        lab_at = torch.gather(lab.reshape(S1 * b, h * W), 1, idx).cpu().numpy()
        dil_at = torch.gather(dil.reshape(S1 * b, h * W), 1, idx).cpu().numpy()
        mine = (owner == j)[None]
        g = np.where(mine, (lab_at + j * h * W).reshape(g.shape), g)
        on = np.where(mine, (dil_at > 0).reshape(g.shape), on)
        # merged roots of this band map to their global root
        plane, local, _, groot, _ = join.dead[j]
        if len(plane):
            code = np.sort(plane * (h * W) + local)
            to = groot[np.argsort(plane * (h * W) + local)]
            flat = (np.arange(S1 * b)[:, None] * (h * W) + lab_at).reshape(g.shape)
            at = np.clip(np.searchsorted(code, flat), 0, len(code) - 1)
            hit = mine & (code[at] == flat)
            g = np.where(hit, to[at], g)
    g_ctx = np.where(on, g, -1).astype(np.int32)
    conv = torch.stack([o[2].reshape(S1, b).all(dim=0).to(dev0) for o in outs]).all(dim=0)
    return torch.from_numpy(np.moveaxis(g_ctx, 0, 1).copy()).to(dev0), conv


def shard_rows(
    bands: Sequence[torch.Tensor],
    mesh,
    cfg: AnalysisConfig,
    particle_val: int,
    cell_vals,
    *,
    tables: str = "counts",
    with_merge: bool = False,
    denoise: bool = True,
    need_lab: bool = True,
    need_fill: bool = True,
) -> List[dict]:
    """The band-sharded per-plane pipeline: one ``[b, h, W]`` band a mesh
    position (``split_bands``) → one dict a data row.

    Band-shaped outputs (``den``, ``lab``, ``filled``, ``seg``) are lists
    of the row's bands, each on its device; per-plane and per-region outputs
    lie on the row's first device: ``particle_ct``, ``n_comp``,
    ``overlaps`` (one [b] a strain), ``converged`` [b], and with ``tables``
    = "counts" (K4) or "full" (K5, also ``table``, a RegionTable)
    ``seg``, ``area`` and ``class_id`` [b, R+1]; with ``with_merge`` (which
    takes "full") ``g_ctx`` [b, S+1, R+1].  ``tables=None`` stops after the
    CCL; ``need_lab`` / ``need_fill`` skip the global labels / the fill."""
    devices = _positions(mesh)
    n_space = mesh.shape[SPACE_AXIS]
    b, h, W = bands[0].shape
    H = h * n_space
    cell_vals = tuple(cell_vals)
    if denoise:
        half = cfg.denoise_size // 2
        padded = _pad_rows(bands, mesh, half, "symmetric")
    else:
        padded = bands
    if with_merge:
        tables = "full"

    def stage_segment(x):
        den = (median_label_filter_rows_padded_auto(x, cfg.denoise_size, cfg.num_classes)
               if denoise else x)
        lab, conv, seg_l, num_l, edges = _band_ccl(den, cfg.ccl_max_iters, cfg.max_regions,
                                                   cfg.num_classes, ranks=True)
        particle = (den == particle_val).sum(dim=(-2, -1), dtype=torch.int32)
        return den, lab, conv, seg_l, num_l, edges, particle

    seg_outs = _each(stage_segment, devices, [(x,) for x in padded])
    rows = _rows_of(mesh)
    joins = {}
    for row in rows:
        join = _join_seams([seg_outs[k][5] for k in row], h, W, ranks=True)
        for j, k in enumerate(row):
            joins[k] = (j, join)

    def stage_tables(k):
        den, lab, _, seg_l, num_l, _, _ = seg_outs[k]
        j, join = joins[k]
        out = {}
        if need_lab:
            out["lab"] = _global_labels(lab, j, join.dead[j])
        if tables is not None:
            seg = _compact(seg_l, num_l, join.before[j], join.dead[j])
            out["seg"] = seg
            if tables == "full":
                out["table"] = region_props_auto(seg, den, cfg.max_regions, row_offset=j * h,
                                                 with_sums=True)
            else:
                out["counts"] = region_sums_auto(seg, den, cfg.max_regions)
        return out

    tab_outs = _each(stage_tables, devices, [(k,) for k in range(len(devices))])

    # the particle fill, a strain at a time: a cap-row halo of the current
    # plane (the bounded EDT reaches no farther), K8 counting own rows only
    filled = [o[0] for o in seg_outs]
    overlaps = []
    if need_fill:
        cap = max(cfg.dilation_radius, cfg.distance_threshold)
        dt2 = cfg.distance_threshold * cfg.distance_threshold
        dr2 = cfg.dilation_radius * cfg.dilation_radius
        neutral = _neutral_value(particle_val, cell_vals)

        def stage_fill(xp, sval):
            out, ov = particle_fill_step_auto(xp, particle_val, sval, cap, dt2, dr2,
                                              count_rows=(cap, cap + h))
            return out[..., cap:cap + h, :].contiguous(), ov

        for sval in cell_vals:
            xp = _pad_rows(filled, mesh, cap, "constant", neutral)
            res = _each(stage_fill, devices, [(x, sval) for x in xp])
            filled = [r[0] for r in res]
            overlaps.append([r[1] for r in res])

    results = []
    for row in rows:
        dev0 = devices[row[0]]
        out = {
            "den": [seg_outs[k][0] for k in row],
            "lab": [tab_outs[k]["lab"] for k in row] if need_lab else None,
            "filled": [filled[k] for k in row],
            "particle_ct": _sum_to([seg_outs[k][6] for k in row], dev0).to(torch.int32),
            "overlaps": [_sum_to([ov[k] for k in row], dev0).to(torch.int32) for ov in overlaps],
            "converged": torch.stack([seg_outs[k][2].to(dev0) for k in row]).all(dim=0),
        }
        out["n_comp"] = torch.from_numpy(joins[row[0]][1].num.sum(axis=0)).to(dev0, torch.int32)
        if tables is not None:
            out["seg"] = [tab_outs[k]["seg"] for k in row]
        if tables == "full":
            table = _join_tables([tab_outs[k]["table"][0] for k in row],
                                 [tab_outs[k]["table"][1] for k in row], dev0)
            out.update(table=table, area=table.area, class_id=table.class_id)
        elif tables == "counts":
            area = _sum_to([tab_outs[k]["counts"][0] for k in row], dev0)
            out["area"] = area.to(torch.int32)
            out["class_id"] = _class_of(area, _sum_to([tab_outs[k]["counts"][1] for k in row], dev0))
        if with_merge:
            g_ctx, m_conv = _merge_groups(
                out["den"], out["table"], cfg, cell_vals, [devices[k] for k in row], H,
            )
            out["g_ctx"] = g_ctx
            out["converged"] = out["converged"] & m_conv
        results.append(out)
    return results


# ---------------------------------------------------------------------------
# the JAX package's factories
# ---------------------------------------------------------------------------


def _cat(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts], dim=0)


def _planes(rows: Sequence[dict], key: str, mesh) -> torch.Tensor:
    """The [B, H, W] batch of one band-shaped output of ``shard_rows``."""
    return join_bands([t for r in rows for t in r[key]], mesh)


def make_sharded_segment_fn(
    mesh,
    cfg: AnalysisConfig,
    particle_val: int = 2,
    cell_vals=(1,),
    max_iters: int = 128,
    with_tables: bool = False,
    with_merge: bool = False,
):
    """The band-sharded step: [B,H,W] uint8 (NumPy or a tensor) →
    (den [B,H,W], labels [B,H,W] global minimum linear indices, particle_px
    [B], n_comp [B], filled [B,H,W], overlap_px [B], converged [B]); with
    ``with_tables`` also seg [B,H,W] (global compact ids, skimage raster
    order), area [B,R+1], class_id [B,R+1]; with ``with_merge`` (implies
    tables) also g_ctx [B,S+1,R+1].  Outputs lie on the mesh's first
    device (of this process's rows, whose planes alone it returns where the
    mesh spans processes).  ``max_iters`` is the JAX package's budget for
    its distributed fixpoints; the seam join here is exact in one pass."""
    del max_iters
    with_tables = with_tables or with_merge
    cell_vals = tuple(cell_vals)

    def fn(imgs):
        rows = shard_rows(
            split_bands(imgs, mesh), mesh, cfg, particle_val, cell_vals,
            tables="counts" if with_tables else None, with_merge=with_merge,
        )
        dev = _positions(mesh)[0]
        out = (
            _planes(rows, "den", mesh), _planes(rows, "lab", mesh),
            _cat([r["particle_ct"] for r in rows], dev),
            _cat([r["n_comp"] for r in rows], dev),
            _planes(rows, "filled", mesh),
            _cat([sum(r["overlaps"]) if r["overlaps"] else torch.zeros_like(r["particle_ct"])
                  for r in rows], dev),
            _cat([r["converged"] for r in rows], dev),
        )
        if with_tables:
            out += (
                _planes(rows, "seg", mesh),
                _cat([r["area"] for r in rows], dev),
                _cat([r["class_id"] for r in rows], dev),
            )
        if with_merge:
            out += (_cat([r["g_ctx"] for r in rows], dev),)
        return out

    return fn


def make_sharded_analysis_fn(
    mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
    max_iters: int = 128,
):
    """``make_sharded_segment_fn`` with tables and the merge grouping: its
    outputs then ``g_ctx`` [B, n_strains+1, R+1], the merge-group roots
    (-1 = centroid off the dilated mask), equal to the single-device
    ``_stage_merge``'s."""
    return make_sharded_segment_fn(
        mesh, cfg, particle_val=particle_val, cell_vals=tuple(cell_vals),
        max_iters=max_iters, with_tables=True, with_merge=True,
    )


def make_sharded_full_analysis_fn(
    mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,),
    max_iters: int = 128, denoise: bool = True, with_merge: bool = True,
    need_lab: bool = True,
):
    """PlaneDeviceOut-grade band-sharded analysis: [B,H,W] uint8 →
    (den, lab, particle_ct [B], n_comp [B], filled, overlap_strain [B,S],
    converged [B], seg, area [B,R+1], class_id [B,R+1], sr_hi, sr_lo,
    sc_hi, sc_lo [B,R+1 each], bbox [B,R+1,4], g_ctx [B,S+1,R+1]) —
    everything ``labels.analysis.analyze_plane_device`` computes, on the
    mesh's first device.  ``with_merge=False`` returns the -1 placeholder
    ``g_ctx``; ``denoise=False`` analyzes the planes as they are;
    ``need_lab=False`` returns None for ``lab`` (which nothing downstream
    reads) and skips building it."""
    del max_iters
    cell_vals = tuple(cell_vals)

    def fn(imgs):
        rows = shard_rows(
            split_bands(imgs, mesh), mesh, cfg, particle_val, cell_vals,
            tables="full", with_merge=with_merge, denoise=denoise, need_lab=need_lab,
        )
        dev = _positions(mesh)[0]
        S = len(cell_vals)
        overlap = _cat([
            torch.stack(r["overlaps"], dim=-1) if S
            else torch.zeros(r["particle_ct"].shape + (0,), dtype=torch.int32, device=dev)
            for r in rows
        ], dev)
        if with_merge:
            g_ctx = _cat([r["g_ctx"] for r in rows], dev)
        else:
            g_ctx = torch.full((overlap.shape[0], S + 1, cfg.max_regions + 1), -1,
                               dtype=torch.int32, device=dev)
        t = [r["table"] for r in rows]
        return (
            _planes(rows, "den", mesh), _planes(rows, "lab", mesh) if need_lab else None,
            _cat([r["particle_ct"] for r in rows], dev),
            _cat([r["n_comp"] for r in rows], dev),
            _planes(rows, "filled", mesh), overlap,
            _cat([r["converged"] for r in rows], dev),
            _planes(rows, "seg", mesh),
            *(_cat([getattr(x, f) for x in t], dev)
              for f in ("area", "class_id", "sr_hi", "sr_lo", "sc_hi", "sc_lo", "bbox")),
            g_ctx,
        )

    return fn


def sharded_segment_batch(
    batch, mesh, cfg: AnalysisConfig, particle_val: int = 2, cell_vals=(1,)
):
    """Run the band-sharded step on a host batch."""
    return make_sharded_segment_fn(mesh, cfg, particle_val, tuple(cell_vals))(batch)


# ---------------------------------------------------------------------------
# DAPI dedup (labels/analysis.py:dapi_dedup_device, reference :252-287)
# ---------------------------------------------------------------------------


def dedup_rows(dapi_bands, other_bands, mesh, cfg: AnalysisConfig) -> List[tuple]:
    """``dapi_dedup_device`` on bands (``split_bands`` of both planes) →
    one (updated dapi bands, num_regions [b], converged [b]) a data row:
    the cross-band CCL and compaction of the DAPI cell mask, the overlap
    sums added over the bands (K4), then K6 reads each pixel's verdict."""
    devices = _positions(mesh)
    b, h, W = dapi_bands[0].shape
    R1 = cfg.max_regions + 1

    def stage_label(dapi):
        return _band_ccl((dapi == 1).to(torch.uint8), cfg.ccl_max_iters, cfg.max_regions, 2,
                         ranks=True)

    outs = _each(stage_label, devices, [(d,) for d in dapi_bands])
    joins = {}
    for row in _rows_of(mesh):
        join = _join_seams([outs[k][4] for k in row], h, W, ranks=True)
        for j, k in enumerate(row):
            joins[k] = (j, join)

    def stage_sums(k):
        _, _, seg_l, num_l, _ = outs[k]
        j, join = joins[k]
        seg = _compact(seg_l, num_l, join.before[j], join.dead[j])
        return (seg,) + region_sums_auto(seg, (other_bands[k] == 1).to(torch.int32), cfg.max_regions)

    sums = _each(stage_sums, devices, [(k,) for k in range(len(devices))])
    results = []
    for row in _rows_of(mesh):
        dev0 = devices[row[0]]
        area = _sum_to([sums[k][1] for k in row], dev0)
        ov = _sum_to([sums[k][2] for k in row], dev0)
        frac = ov.to(torch.float32) / area.clamp(min=1).to(torch.float32)
        remove = ((frac > cfg.dapi_overlap_threshold)
                  & (torch.arange(R1, device=dev0) > 0)).to(torch.int32)

        def stage_remove(k):
            rm = table_lookup_auto(sums[k][0], remove.to(devices[k]))
            dapi = dapi_bands[k]
            return torch.where((rm > 0) & (dapi == 1), 2, dapi).to(dapi.dtype)

        out = _each(stage_remove, [devices[k] for k in row], [(k,) for k in row])
        num = torch.from_numpy(joins[row[0]][1].num.sum(axis=0)).to(dev0, torch.int32)
        conv = torch.stack([outs[k][1].to(dev0) for k in row]).all(dim=0)
        results.append((out, num, conv))
    return results


def make_sharded_dapi_dedup_fn(mesh, cfg: AnalysisConfig, max_iters: int = 128):
    """Band-sharded DAPI-vs-other-channel dedup: [B,H,W] × 2 uint8 →
    (updated dapi [B,H,W], num_regions [B], converged [B]), equal to the
    single-device ``labels.analysis.dapi_dedup_device``.  Callers must check
    ``num_regions <= cfg.max_regions``: an overflowing plane's extra regions
    get no overlap row, and their verdicts are invalid."""
    del max_iters

    def fn(dapi, other):
        rows = dedup_rows(split_bands(dapi, mesh), split_bands(other, mesh), mesh, cfg)
        dev = _positions(mesh)[0]
        return (
            join_bands([t for r in rows for t in r[0]], mesh),
            _cat([r[1] for r in rows], dev),
            _cat([r[2] for r in rows], dev),
        )

    return fn


# ---------------------------------------------------------------------------
# the spatial refine (models/refine.refine_plane_device on bands; JAX
# _refine_shard)
# ---------------------------------------------------------------------------


def _edt_bands(feature_bands, mesh, probe_cap: int, stats: dict):
    """Exact squared EDT of each band's own rows (``ops.edt.edt_sq_exact``
    of the whole plane, ``_edt_sq_exact_shard``): K9 on each band with a
    ``probe_cap``-row halo, its flag raised by the band's own rows only.
    Where no band of a data row flags, the capped result is exact;
    otherwise that row takes the exact transform: each band's row pass,
    the plane's dh² gathered onto every band, and each band's own rows
    min-plussed with global row indices."""
    devices = _positions(mesh)
    b, h, W = feature_bands[0].shape
    n_space = mesh.shape[SPACE_AXIS]
    H = n_space * h
    inf = (H + W + 2) * (H + W + 2)  # the whole plane's, as on one device
    padded = _pad_rows(feature_bands, mesh, probe_cap, "constant", False)

    def probe(x):
        d2, flag = edt_sq_auto(x.contiguous(), probe_cap, with_flag=True,
                               flag_rows=(probe_cap, probe_cap + h))
        return d2[:, probe_cap:probe_cap + h].contiguous(), flag

    outs = _each(probe, devices, [(x,) for x in padded])
    deep = [bool(o[1]) for o in outs]
    d2 = [o[0] for o in outs]
    stats["edt_fallback_rows"] = 0
    for row in _rows_of(mesh):
        if not any(deep[k] for k in row):
            continue
        stats["edt_fallback_rows"] += 1
        row_devices = [devices[k] for k in row]
        dh2 = _each(lambda f: row_dh2_exact(f, inf), row_devices,
                    [(feature_bands[k],) for k in row])

        def exact(j, dev):
            g = torch.cat([x.to(dev) for x in dh2], dim=-2)
            r_idx = torch.arange(j * h, (j + 1) * h, dtype=torch.int32, device=dev)
            return minplus_rows(g, r_idx, inf)

        for j, out in enumerate(_each(exact, row_devices, list(enumerate(row_devices)))):
            d2[row[j]] = out
    return d2


def _seam_or(edges: Sequence[tuple], h: int, W: int) -> list:
    """OR a component-constant flag (``edges[j][2]``) over the components
    the seams join: for each band, (plane, local root) of its components
    whose flag is off while another piece of their joined component has it
    on, as host int64 arrays."""
    n = len(edges)
    keys, root = _seam_roots(edges, h, W)
    if not len(keys):
        return [(np.zeros(0, np.int64),) * 2 for _ in range(n)]
    flag = _value_at_keys(edges, 2, keys, h, W) != 0
    roots, comp = np.unique(root, return_inverse=True)
    any_on = np.zeros(len(roots), bool)
    np.logical_or.at(any_on, comp, flag)
    need = any_on[comp] & ~flag
    plane, band, local = _key_parts(keys, h, W, n)
    return [(plane[need & (band == j)], local[need & (band == j)]) for j in range(n)]


def _maxima_bands(d2_bands, mesh, max_iters: int):
    """Plateau-aware local maxima (8-connected) of int32 d² bands
    (``_local_maxima_shard``): ``has_higher`` with a 1-row halo, K2 on each
    band with the values' own classes and the seam join; a plateau is
    "bad" where any of its pixels, on any band, has a higher neighbour.
    Returns (maxima bands, converged [b] a position)."""
    devices = _positions(mesh)
    b, h, W = d2_bands[0].shape
    padded = _pad_rows(d2_bands, mesh, 1, "constant", _I32_MIN)  # never "higher"

    def local(x, xp):
        higher = _has_higher(xp, _OFFSETS8)[:, 1:h + 1]
        lab, conv, _, _, edges = _band_ccl(x, max_iters, 0, _I32_MAX, ranks=False)
        bad = _marked_components(lab, higher)
        return lab, bad, conv, edges[:2] + _edge_rows(bad)

    outs = _each(local, devices, [(x, xp) for x, xp in zip(d2_bands, padded)])
    marks = {}
    for row in _rows_of(mesh):
        for j, m in enumerate(_seam_or([outs[k][3] for k in row], h, W)):
            marks[row[j]] = m

    def join(k):
        lab, bad, _, _ = outs[k]
        plane, local_root = (torch.from_numpy(x).to(lab.device) for x in marks[k])
        if len(plane):
            table = torch.zeros((b, h * W), dtype=torch.int32, device=lab.device)
            table[plane, local_root] = 1
            bad = bad | (table_lookup_auto(lab, table) > 0)
        return ~bad

    maxima = _each(join, devices, [(k,) for k in range(len(devices))])
    return maxima, [o[2] for o in outs]


def _marker_bands(maxima_bands, mesh, max_iters: int, max_regions: int):
    """The markers (``_dist_ccl`` + ``_compact_and_tables_shard`` with
    ``fg=maxima``): K2 on each band with background 0, K3's ranks, the seam
    join over foreground pairs only and the K6 rank tables.  Returns (marker
    bands: global raster ranks, 0 off the maxima; num [b] a data row on its
    first device; converged [b] a position)."""
    devices = _positions(mesh)
    b, h, W = maxima_bands[0].shape

    def label(mx):
        return _band_ccl(mx.to(torch.uint8), max_iters, max_regions, 2, ranks=True,
                         background=0)

    outs = _each(label, devices, [(m,) for m in maxima_bands])
    joins, nums = {}, []
    for row in _rows_of(mesh):
        join = _join_seams([outs[k][4] for k in row], h, W, ranks=True, background=0)
        nums.append(torch.from_numpy(join.num.sum(axis=0)).to(devices[row[0]], torch.int32))
        for j, k in enumerate(row):
            joins[k] = (j, join)

    def compact(k):
        _, _, seg_l, num_l, _ = outs[k]
        j, join = joins[k]
        return _compact(seg_l, num_l, join.before[j], join.dead[j])

    markers = _each(compact, devices, [(k,) for k in range(len(devices))])
    return markers, nums, [o[1] for o in outs]


def _refresh_halos(states, mesh) -> None:
    """Copy each band's first and last own rows into its neighbours' halo
    rows, for every [b, h+2, W] state of ``states`` (one list of bands a
    state; the halo rows past the plane's edges keep their fills)."""
    for row in _rows_of(mesh):
        for j, k in enumerate(row):
            for bands in states:
                x = bands[k]
                h = x.shape[-2] - 2
                if j > 0:
                    x[:, 0].copy_(bands[row[j - 1]][:, h], non_blocking=True)
                if j < len(row) - 1:
                    x[:, h + 1].copy_(bands[row[j + 1]][:, 1], non_blocking=True)


def _band_rounds(run, mesh, states, max_iters: int, log: dict) -> List[np.ndarray]:
    """Rounds of band fixpoints: ``run(k)`` relaxes position k's band to its
    local fixpoint under its halo rows and returns (still changing [b],
    own edge rows changed [b], PhaseLog).  Round 1 runs every band; a later
    round runs a band that was still changing or whose neighbour's edge
    rows changed, after the halo rows are exchanged.  Stops when no band
    has work, or after ``max_iters`` rounds.  Returns each data row's
    per-plane converged flags (host bool [b]): no band of the plane still
    changing and no edge row changed in the last round it ran."""
    devices = _positions(mesh)
    rows = _rows_of(mesh)
    b = states[0][0].shape[0]
    pending = {k: np.zeros((2, b), bool) for k in range(len(devices))}  # changing, edges
    active = list(range(len(devices)))
    rounds, passes, syncs = 0, [], 0
    while active and rounds < max_iters:
        outs = _each(run, [devices[k] for k in active], [(k,) for k in active])
        rounds += 1
        for k in range(len(devices)):
            pending[k] = np.zeros((2, b), bool)
        for k, (ch, ed, plog) in zip(active, outs):
            pending[k] = np.stack([ch.cpu().numpy(), ed.cpu().numpy()])
            syncs += plog.syncs + 1
        passes.append(max(o[2].passes for o in outs))
        _refresh_halos(states, mesh)
        nxt = []
        for row in rows:
            for j, k in enumerate(row):
                if (pending[k][0].any()
                        or (j > 0 and pending[row[j - 1]][1].any())
                        or (j < len(row) - 1 and pending[row[j + 1]][1].any())):
                    nxt.append(k)
        active = nxt
    log.update(rounds=rounds, passes=passes, syncs=syncs)
    return [~np.logical_or.reduce([pending[k].any(axis=0) for k in row]) for row in rows]


def _watershed_bands(img_bands, marker_bands, mask_bands, mesh, connectivity: int,
                     max_iters: int, stats: dict):
    """The band-coupled two-phase watershed (``_watershed_shard``): each
    phase runs rounds of the band phases (``ops.watershed`` band mode, K10
    and K11 on the card) with the halo rows exchanged between rounds, each
    band bounded by ``max_iters`` passes a round and the phase by
    ``max_iters`` rounds.  Both phases' fixpoints are unique, so the labels
    equal one device's.  Returns (label bands, converged [b] a data row on
    its first device)."""
    devices = _positions(mesh)
    h = img_bands[0].shape[-2]
    img = _pad_rows([x.to(torch.float32) for x in img_bands], mesh, 1, "constant", _WS_INF)
    m = _pad_rows([x.to(torch.bool) for x in mask_bands], mesh, 1, "constant", False)
    mk = _pad_rows([x.to(torch.int32) for x in marker_bands], mesh, 1, "constant", 0)
    seeded = [(x > 0) & y for x, y in zip(mk, m)]
    inf = torch.tensor(_WS_INF, dtype=torch.float32)
    cost = [torch.where(s, i, inf.to(i.device)).contiguous() for s, i in zip(seeded, img)]

    def phase1(k):
        c, ch, ed, plog = minimax_costs_band_auto(img[k], m[k], seeded[k], cost[k],
                                                  connectivity, max_iters)
        cost[k] = c
        return ch, ed, plog

    conv1 = _band_rounds(phase1, mesh, [cost], max_iters, stats.setdefault("phase1", {}))
    lab = [torch.where(s, x, _BIG_LAB).to(torch.int32).contiguous() for s, x in zip(seeded, mk)]
    dist = [torch.where(s, 0, _BIG_LAB).to(torch.int32).contiguous() for s in seeded]
    eimg = [torch.where(s, -inf.to(s.device), inf.to(s.device)).contiguous() for s in seeded]

    def phase2(k):
        out = claim_labels_band_auto(cost[k], img[k], m[k], seeded[k], lab[k], dist[k],
                                     eimg[k], connectivity, max_iters)
        lab[k], dist[k], eimg[k] = out[:3]
        return out[3:]

    conv2 = _band_rounds(phase2, mesh, [lab, dist, eimg], max_iters,
                         stats.setdefault("phase2", {}))

    def final(k):
        reached = m[k] & (cost[k] < _WS_INF) & (lab[k] != _BIG_LAB)
        return torch.where(reached, lab[k], 0)[:, 1:h + 1].contiguous()

    labels = _each(final, devices, [(k,) for k in range(len(devices))])
    conv = [torch.from_numpy(c1 & c2).to(devices[row[0]])
            for c1, c2, row in zip(conv1, conv2, _rows_of(mesh))]
    return labels, conv


def _centroid_rows(label_bands, mesh, max_regions: int):
    """K7 on each band with its global rows (``row_offset``), summed over a
    data row's bands onto its first device: [b, R+1, 5] int32 (area, Σrow
    hi, Σrow lo, Σcol hi, Σcol lo), JAX's ``sums``."""
    devices = _positions(mesh)
    h = label_bands[0].shape[-2]
    n_space = mesh.shape[SPACE_AXIS]
    tables = _each(lambda lab, k: torch.stack(tuple(centroid_sums_auto(
        lab, max_regions, row_offset=(k % n_space) * h)), dim=-1),
        devices, [(lab, k) for k, lab in enumerate(label_bands)])
    return [_sum_to([tables[k] for k in row], devices[row[0]]).to(torch.int32)
            for row in _rows_of(mesh)]


@lru_cache(maxsize=None)
def make_sharded_watershed_fn(mesh, connectivity: int = 1, max_iters: int = 4096):
    """The band-coupled marker watershed over ``mesh``: (image [B,H,W] f32,
    markers [B,H,W] i32, mask [B,H,W] bool or None) → (labels [B,H,W] i32,
    converged [B]) on the mesh's first device; the labels equal
    ``ops.watershed.watershed``'s on every plane where both converge.

    Each band relaxes to its local fixpoint in a round (at most
    ``max_iters`` passes of K10/K11 on the card, steps of the plain loop on
    the CPU), and a phase stops after a round that changed no band's edge
    rows and left every band at its local fixpoint, or after ``max_iters``
    rounds: the JAX package counts halo-exchanged Jacobi steps against its
    budget, the port counts rounds, so the ``converged`` flags at one budget
    need not agree.  ``fn.last_stats`` holds each phase's rounds, the most
    passes a band ran in each round, and the host syncs."""

    def fn(image, markers, mask=None):
        img = split_bands(image, mesh)
        m = (split_bands(mask, mesh) if mask is not None
             else [torch.ones_like(x, dtype=torch.bool) for x in img])
        stats: dict = {}
        labels, conv = _watershed_bands(img, split_bands(markers, mesh), m, mesh, connectivity,
                                        max_iters, stats)
        fn.last_stats = stats
        dev = _positions(mesh)[0]
        return join_bands(labels, mesh), _cat(conv, dev)

    fn.last_stats = {}
    return fn


@lru_cache(maxsize=None)
def make_sharded_refine_fn(mesh, threshold: float = 0.5, connectivity: int = 1,
                           max_regions: int = 4095, max_iters: int = 4096,
                           with_tables: bool = False, *, probe_cap: int = 32):
    """The refine pipeline on a mesh (``models.refine.refine_plane_device``
    with each plane's rows in bands): probability maps [B,H,W] (NumPy or a
    tensor) → (labels [B,H,W], markers [B,H,W], num_cells [B], converged
    [B]) on the mesh's first device, equal to the one-device run.

    EDT (K9's probe with a ``probe_cap``-row halo, the exact transform
    where it flags) → plateau-aware local maxima (K2 and the seam join) →
    marker CCL and compaction (K2, K3, the seam join, K6) → the
    band-coupled watershed (K10, K11; ``make_sharded_watershed_fn``).
    ``max_iters`` bounds the watershed's rounds and each band's passes a
    round, and a CPU band's plain CCL.  Callers must check ``num_cells <=
    max_regions`` and ``converged``.

    ``with_tables`` appends ``sums`` [B, max_regions+1, 5]: each cell's
    (area, Σrow hi, Σrow lo, Σcol hi, Σcol lo) over the final labels (K7 in
    the plane's rows, summed over the bands), from which the refine CSV's
    areas and centroids follow.  ``fn.last_stats`` holds the EDT fallback
    and the watershed's rounds, passes and syncs."""

    def fn(probs):
        bm = [x.to(torch.float32) for x in split_bands(probs, mesh)]
        binary = [x < threshold for x in bm]
        stats: dict = {}
        d2 = _edt_bands([~x for x in binary], mesh, probe_cap, stats)
        maxima, conv_max = _maxima_bands(d2, mesh, max_iters)
        markers, nums, conv_ccl = _marker_bands(maxima, mesh, max_iters, max_regions)
        labels, conv_ws = _watershed_bands(bm, markers, binary, mesh, connectivity,
                                           max_iters, stats)
        fn.last_stats = stats
        dev = _positions(mesh)[0]
        conv = _cat([
            torch.stack([conv_max[k].to(dev) & conv_ccl[k].to(dev) for k in row]).all(dim=0)
            for row in _rows_of(mesh)], dev) & _cat(conv_ws, dev)
        out = (join_bands(labels, mesh), join_bands(markers, mesh), _cat(nums, dev), conv)
        if with_tables:
            out += (_cat(_centroid_rows(labels, mesh, max_regions), dev),)
        return out

    fn.last_stats = {}
    return fn
