"""Plain reference of the refine call (``refine_plane_device``).

From the staged probability maps alone: the objects (map below the
threshold), the exact squared distance of every pixel to the nearest
boundary pixel and its float32 root, the plateau-aware local maxima of the
squared distance, the markers (their 8-connected components numbered in
raster order), the marker watershed of the map within the objects, and the
centroid table of its labels.

The watershed is the two-phase minimax flood the port defines (its
``ops/watershed.py``), written here again from its equations: phase 1 gives
every object pixel the least, over paths from a seed, of the highest map
value on the path; phase 2 gives every unseeded pixel the least claim
(level distance, entry value, claimer value, label) over its neighbours
whose cost it inherits.  Both are Jacobi loops run to their fixpoint, which
is unique.  With ``tunnel_basins`` phase 2 runs on the quotient graph of the
below-level basins (4-connected components of unseeded pixels lying under
their cost), each basin adopting the least claim of its pixels a step.
This is not scipy's or skimage's priority flood, whose labels differ.

``control=True`` computes every float in bfloat16, the type below the
float32 the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import plain

BLOCK = 2  # planes a block: the phase-2 state of 2048² planes stays near 1 GiB


def _costs(img, m, seeded, inf):
    """Phase 1: the minimax cost of every pixel of ``m`` from the seeds."""
    cost0 = torch.where(seeded, img, inf)
    cost = cost0
    for _ in range(plain.MAX_ROUNDS):
        best = cost
        for dy, dx in plain.OFFSETS4:
            best = torch.minimum(best, torch.maximum(plain.shifted(cost, dy, dx, inf), img))
        new = torch.where(seeded, cost0, torch.where(m, best, inf))
        if torch.equal(new, cost):
            return cost, True
        cost = new
    return cost, False


def _basins(cost, img, m, seeded, inf):
    """The tunnel's quotient graph: segment ids (a basin's least linear
    index, any other pixel's own, each offset by its plane) and the level
    distance a hop onto each pixel adds (1 at level, 0 below)."""
    B, H, W = img.shape
    at_level = img == cost
    below = m & ~seeded & ~at_level & (cost < inf)
    comp, converged = plain.ccl(below.to(torch.uint8), 4, background=0)
    lin = torch.arange(H * W, dtype=torch.int64, device=img.device).reshape(1, H, W)
    off = (H * W) * torch.arange(B, dtype=torch.int64, device=img.device).reshape(B, 1, 1)
    seg = torch.where(below, comp.to(torch.int64), lin) + off
    return seg, at_level.to(torch.int32), converged


def _segment_min(seg_flat, bd, be, bs, bl, big, inf):
    """Each segment's lexicographic least (d, e, s, lab), gathered back to
    its pixels: (d, e, lab)."""
    n = seg_flat.numel()

    def seg_min(x, fill):
        buf = torch.full((n,), fill, dtype=x.dtype, device=x.device)
        buf.scatter_reduce_(0, seg_flat, x, reduce="amin")
        return buf[seg_flat]

    d, e, s, lab = (t.reshape(-1) for t in (bd, be, bs, bl))
    dm = seg_min(d, big)
    t = d == dm
    em = seg_min(torch.where(t, e, inf), inf)
    t &= e == em
    sm = seg_min(torch.where(t, s, inf), inf)
    t &= s == sm
    lm = seg_min(torch.where(t, lab, big), big)
    return dm.reshape(bd.shape), em.reshape(bd.shape), lm.reshape(bd.shape)


def _claims(cost, img, lab0, m, seeded, inf, basins):
    """Phase 2: the watershed labels (0 outside the objects and where no
    seed reaches)."""
    big = plain.I32_BIG
    seg, inc = basins if basins is not None else (None, 1)
    seg_flat = None if seg is None else seg.reshape(-1)
    lab = torch.where(seeded, lab0, big)
    dist = torch.where(seeded, 0, torch.full_like(lab0, big))
    eimg = torch.where(seeded, torch.full_like(img, -inf), torch.full_like(img, inf))
    converged = False
    for _ in range(plain.MAX_ROUNDS):
        bd = torch.full_like(lab0, big)
        be = torch.full_like(img, inf)
        bs = torch.full_like(img, inf)
        bl = torch.full_like(lab0, big)
        for dy, dx in plain.OFFSETS4:
            nc = plain.shifted(cost, dy, dx, inf)
            nim = plain.shifted(img, dy, dx, inf)
            nl = plain.shifted(lab, dy, dx, big)
            nd = plain.shifted(dist, dy, dx, big)
            ne = plain.shifted(eimg, dy, dx, inf)
            valid = (torch.maximum(nc, img) == cost) & (nl != big)
            if seg is not None:
                valid &= plain.shifted(seg, dy, dx, -1) != seg
            reset = nc < cost  # a strictly uphill crossing starts a new level
            cd = torch.where(valid, torch.where(reset, 0, torch.where(nd < big, nd + inc, big)),
                             big)
            ce = torch.where(valid, torch.where(reset, nim, ne), inf)
            cs = torch.where(valid, nim, inf)
            cl = torch.where(valid, nl, big)
            take = ((cd < bd) | ((cd == bd) & (ce < be)) | ((cd == bd) & (ce == be) & (cs < bs))
                    | ((cd == bd) & (ce == be) & (cs == bs) & (cl < bl)))
            bd, be, bs, bl = (torch.where(take, c, b) for c, b in
                              ((cd, bd), (ce, be), (cs, bs), (cl, bl)))
        if seg_flat is not None:
            bd, be, bl = _segment_min(seg_flat, bd, be, bs, bl, big, inf)
        new_l = torch.where(seeded, lab0, torch.where(m, bl, big))
        new_d = torch.where(seeded, 0, torch.where(m, bd, big))
        new_e = torch.where(seeded, -inf, torch.where(m, be, inf))
        if torch.equal(new_l, lab) and torch.equal(new_d, dist) and torch.equal(new_e, eimg):
            converged = True
            break
        lab, dist, eimg = new_l, new_d, new_e
    reached = m & (cost < inf) & (lab != big)
    return torch.where(reached, lab, 0), converged


def watershed(img, markers, m, tunnel_basins: bool, inf):
    """The 4-connected marker watershed of ``img`` within ``m``:
    (labels int32, converged)."""
    lab0 = markers.to(torch.int32)
    seeded = (lab0 > 0) & m
    cost, ok1 = _costs(img, m, seeded, inf)
    basins, ok3 = None, True
    if tunnel_basins:
        seg, inc, ok3 = _basins(cost, img, m, seeded, inf)
        basins = (seg, inc)
    labels, ok2 = _claims(cost, img, lab0, m, seeded, inf, basins)
    return labels, ok1 and ok2 and ok3


def compute(x: torch.Tensor, options: dict, control: bool = False, full: bool = False):
    """(readback, held): num, converged and the centroid table of each
    plane as NumPy arrays, and, with ``full``, the labels, markers and
    distance as tensors."""
    fdt = torch.bfloat16 if control else torch.float32
    inf = torch.finfo(fdt).max if control else plain.F32_INF
    R = options["max_regions"]
    rows = {k: [] for k in ("num", "converged", "area", "sum_row", "sum_col")}
    held = {k: [] for k in ("labels", "markers", "distance")}
    for b0 in range(0, x.shape[0], BLOCK):
        bmap = x[b0:b0 + BLOCK].to(fdt)
        objects = bmap < options["boundary_threshold"]
        dsq = plain.edt_sq(~objects)
        distance = torch.sqrt(dsq.to(torch.float64)).to(fdt)
        maxima = plain.local_maxima(dsq)
        raw, ok_m = plain.ccl(maxima.to(torch.uint8), 8, background=0)
        markers, num = plain.compact(raw)
        labels, ok_w = watershed(bmap, markers, objects, options["tunnel_basins"], inf)
        B, H, W = labels.shape
        r = torch.arange(H, device=x.device).reshape(1, H, 1)
        c = torch.arange(W, device=x.device).reshape(1, 1, W)
        rows["num"].append(num)
        rows["converged"].append(torch.full_like(num, int(ok_m and ok_w)))
        rows["area"].append(plain.binned_sums(labels, None, R))
        rows["sum_row"].append(plain.binned_sums(labels, r, R))
        rows["sum_col"].append(plain.binned_sums(labels, c, R))
        if full:
            held["labels"].append(labels)
            held["markers"].append(markers)
            held["distance"].append(distance)
    readback = {k: torch.cat(v).cpu().numpy().astype(np.int64) for k, v in rows.items()}
    return readback, ({k: torch.cat(v) for k, v in held.items()} if full else None)
