"""Marker watershed by two-phase minimax flooding (plain version and dispatch).

Counterpart of ``particle_col_image_segmentation_tpu/ops/watershed.py``
(``_offsets``, ``_shifted``, ``claim_candidates``, ``fold_claim``,
``watershed``, ``watershed_auto``); see that module for the derivation.

  1. costs: every masked pixel's minimax distance to the seeds — min over
     paths of the largest relief on the path — by Jacobi relaxation;
  2. labels: with the costs fixed, every masked non-seed pixel takes the
     least claim (level distance, entry img, claimer img, marker id) over its
     optimal edges (n → p is optimal iff max(cost[n], img[p]) == cost[p]),
     recomputed from scratch from its neighbours' states each step.

Both phases have a unique fixpoint, so the plain Jacobi loop here, the JAX
package's XLA loop and band sweeps, and the port's CUDA tile passes
(``ops.watershed_tiles``, K10 and K11) give the same labels bit for bit.
The plain loop is the XLA loop step for step, so even a plane that runs out
of ``max_iters`` gets the JAX package's labels and ``converged`` flag.

``tunnel_basins=True`` models the priority flood's basin tunnelling: a
below-level pixel (img < its flood level) pops before every at-level one,
so a wave that reaches a basin's rim floods the whole basin in one round.
Phase 2 then runs on the quotient graph of the basins: the connected
components of the below-level mask (``basin_segments``; K2 on CUDA
tensors), where claims cross only segment boundaries, the level distance
grows only onto at-level pixels, and every basin adopts the least claim of
its pixels each step (``_segment_broadcast``, four segment minima).  Phase
1 is unchanged.  On CUDA tensors ``watershed_auto`` runs this phase 2 on
K12 (``ops.watershed_tiles.claim_labels_tunnel_cuda``, ``csrc/tunnel.cu``):
the plain loop's Jacobi steps, one kernel step (three launches) a step,
with the same flags, steps and budget.  The plain loop here serves CPU
tensors and ``watershed``, as XLA code serves the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.ccl import connected_components_auto
from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
    _BIG_LAB,
    _INF,
    PhaseLog,
    claim_labels_band_cuda,
    claim_labels_tunnel_cuda,
    minimax_costs_band_cuda,
    minimax_costs_cuda,
    watershed_cuda,
)
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

__all__ = [
    "watershed", "watershed_auto", "minimax_costs", "claim_labels",
    "claim_candidates", "fold_claim", "basin_segments",
    "minimax_costs_band", "claim_labels_band", "minimax_costs_band_auto",
    "claim_labels_band_auto",
]


def _offsets(connectivity: int):
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    return offsets


def _shifted(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[..., r, c] = x[..., r - dy, c - dx]``, ``fill`` where that lies
    outside the plane."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(0, dy):H - max(0, -dy), max(0, dx):W - max(0, -dx)] = (
        x[..., max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)]
    )
    return out


def claim_candidates(cost, img, lab, dist, eimg, dy, dx, shifted=None, inc=1, seg=None):
    """The phase-2 claim of the neighbour at offset (−dy, −dx) of every pixel,
    as (level distance, entry img, claimer img, label); (BIG, INF, INF, BIG)
    where that edge is not optimal or the neighbour holds no label.

    ``inc`` is the level distance a hop adds: 1 on the pixel graph, the
    int32 ``at_level`` plane on the basins' quotient graph.  ``seg`` (the
    quotient graph's segment ids) keeps only edges between segments.

    The JAX package takes a ``shifted`` callback here, one for each of its
    schedules; the port's schedules all read neighbours through this
    module's own shift, so ``shifted`` holds JAX's slot and only None binds."""
    if shifted is not None:
        raise ValueError(
            "claim_candidates: the port takes no shifted callback (its neighbour "
            "view is ops.watershed's own shift); pass shifted=None"
        )
    nc = _shifted(cost, dy, dx, _INF)
    nim = _shifted(img, dy, dx, _INF)
    nl = _shifted(lab, dy, dx, _BIG_LAB)
    nd = _shifted(dist, dy, dx, _BIG_LAB)
    ne = _shifted(eimg, dy, dx, _INF)
    valid = (torch.maximum(nc, img) == cost) & (nl != _BIG_LAB)
    if seg is not None:
        valid &= _shifted(seg, dy, dx, -1) != seg
    reset = nc < cost  # strictly uphill crossing: a new flooding level
    big = torch.full_like(nd, _BIG_LAB)
    inf = torch.full_like(nim, _INF)
    cd = torch.where(
        valid,
        torch.where(reset, 0, torch.where(nd < _BIG_LAB, nd + inc, big)),
        big,
    )
    ce = torch.where(valid, torch.where(reset, nim, ne), inf)
    cs = torch.where(valid, nim, inf)
    cl = torch.where(valid, nl, big)
    return cd, ce, cs, cl


def fold_claim(best, cand):
    """Lexicographic (d, eimg, simg, lab) min of two claim sets."""
    bd, be, bs, bl = best
    cd, ce, cs, cl = cand
    take = (
        (cd < bd)
        | ((cd == bd) & (ce < be))
        | ((cd == bd) & (ce == be) & (cs < bs))
        | ((cd == bd) & (ce == be) & (cs == bs) & (cl < bl))
    )
    return (
        torch.where(take, cd, bd),
        torch.where(take, ce, be),
        torch.where(take, cs, bs),
        torch.where(take, cl, bl),
    )


def _inputs(image, markers, mask):
    """(img f32, lab0 i32, m bool, seeded bool), all [..., H, W]."""
    img = image.to(torch.float32)
    lab0 = markers.to(torch.int32)
    m = torch.ones(image.shape, dtype=torch.bool, device=image.device) if mask is None \
        else mask.to(torch.bool)
    return img, lab0, m, (lab0 > 0) & m


def _check_args(connectivity: int) -> None:
    if connectivity not in (1, 2):
        raise ValueError(f"watershed: connectivity must be 1 or 2, got {connectivity}")


def minimax_costs(img, m, seeded, connectivity: int = 1, max_iters: int = 1024):
    """Phase 1 (plain Jacobi): every masked pixel's minimax distance to the
    seeds; +INF outside the mask and where no seed reaches.  Returns (cost,
    per-plane bool still changing when the loop stopped)."""
    inf = torch.tensor(_INF, dtype=torch.float32, device=img.device)
    cost0 = torch.where(seeded, img, inf)
    cost = cost0
    changed = torch.ones(img.shape[:-2], dtype=torch.bool, device=img.device)
    i = 0
    while i < max_iters and bool(changed.any()):
        best = cost
        for dy, dx in _offsets(connectivity):
            best = torch.minimum(best, torch.maximum(_shifted(cost, dy, dx, _INF), img))
        new = torch.where(seeded, cost0, torch.where(m, best, inf))
        changed = (new != cost).flatten(-2).any(-1)
        cost = new
        i += 1
    return cost, changed


def basin_segments(cost, img, m, seeded, connectivity: int = 1):
    """The tunnel's quotient graph for phase 2.  A basin is a connected
    component (4-connected for ``connectivity`` 1, else 8) of the
    below-level mask: masked, unseeded, reached pixels whose relief lies
    under their cost.  Adjacent below-level pixels share one flood level,
    so each component floods as one.

    Returns (seg, inc, converged): int32 [..., H, W] segment ids, unique
    across the whole batch (a basin's id is its least per-plane linear
    index, any other pixel's its own, each plus its plane's offset); the
    int32 level distance a hop onto each pixel adds (1 at level, 0 below);
    and the per-plane flag of the basin CCL (K2 on CUDA tensors, always
    True; the plain 64-round fixpoint on CPU tensors)."""
    H, W = img.shape[-2:]
    at_level = img == cost
    below = m & ~seeded & ~at_level & (cost < _INF)
    comp, conv = connected_components_auto(
        below.int().reshape(-1, H, W), background=0,
        connectivity=4 if connectivity == 1 else 8, num_classes=2, with_flag=True,
    )
    lin = torch.arange(H * W, dtype=torch.int32, device=img.device).reshape(H, W)
    plane_off = torch.arange(comp.shape[0], dtype=torch.int32,
                             device=img.device).reshape(-1, 1, 1) * (H * W)
    seg = torch.where(below.reshape(comp.shape), comp, lin) + plane_off
    return (seg.reshape(img.shape), at_level.int(),
            conv.reshape(img.shape[:-2]))


def _segment_broadcast(seg_flat, bd, be, bs, bl):
    """The lexicographic (d, e, s, lab) minimum of each segment, gathered back
    to its pixels: (d, e, lab).  ``seg_flat`` is the int64 flat segment ids.
    Four scatter minima, each exact in any order, as the JAX package's four
    ``segment_min`` calls."""
    n = seg_flat.numel()

    def seg_min(x, fill):
        buf = torch.full((n,), fill, dtype=x.dtype, device=x.device)
        buf.scatter_reduce_(0, seg_flat, x, reduce="amin", include_self=True)
        return buf[seg_flat]

    d, e, c, lab = (x.reshape(-1) for x in (bd, be, bs, bl))
    dm = seg_min(d, _BIG_LAB)
    t = d == dm
    em = seg_min(torch.where(t, e, _INF), _INF)
    t &= e == em
    cm = seg_min(torch.where(t, c, _INF), _INF)
    t &= c == cm
    lm = seg_min(torch.where(t, lab, _BIG_LAB), _BIG_LAB)
    return dm.reshape(bd.shape), em.reshape(bd.shape), lm.reshape(bd.shape)


def claim_labels(cost, img, lab0, m, seeded, connectivity: int = 1, max_iters: int = 1024,
                 basins=None):
    """Phase 2 (plain Jacobi): with ``cost`` fixed, relax the claims from
    the seeds.  ``basins`` = (seg, inc) from ``basin_segments`` runs it on
    the basins' quotient graph (``tunnel_basins``).  Returns (watershed
    labels — 0 outside the mask and where no seed reaches —, per-plane bool
    still changing when the loop stopped); the steps run are kept in
    ``claim_labels.last_steps``."""
    big = torch.full(img.shape, _BIG_LAB, dtype=torch.int32, device=img.device)
    seg, inc = basins if basins is not None else (None, 1)
    seg_flat = None if seg is None else seg.reshape(-1).to(torch.int64)
    lab = torch.where(seeded, lab0, big)
    dist = torch.where(seeded, 0, big)
    eimg = torch.where(seeded, -_INF, _INF)  # float32, as the scalars round
    changed = torch.ones(img.shape[:-2], dtype=torch.bool, device=img.device)
    # one host sync a step, reading the step's flags; the first step needs
    # none (every plane starts as changing)
    sync = "pcis.sync.tunnel_step" if seg is not None else "pcis.sync.claim_step"
    i, going = 0, changed.numel() > 0
    while i < max_iters and going:
        best = (big, torch.full_like(img, _INF), torch.full_like(img, _INF), big)
        for dy, dx in _offsets(connectivity):
            best = fold_claim(best, claim_candidates(cost, img, lab, dist, eimg, dy, dx,
                                                     inc=inc, seg=seg))
        bd, be, bs, bl = best
        if seg_flat is not None:
            bd, be, bl = _segment_broadcast(seg_flat, bd, be, bs, bl)
        new_l = torch.where(seeded, lab0, torch.where(m, bl, big))
        new_d = torch.where(seeded, 0, torch.where(m, bd, big))
        new_e = torch.where(seeded, -_INF, torch.where(m, be, _INF))
        changed = ((new_l != lab) | (new_d != dist) | (new_e != eimg)).flatten(-2).any(-1)
        lab, dist, eimg = new_l, new_d, new_e
        i += 1
        with stage(sync):
            going = bool(changed.any())
    claim_labels.last_steps = i
    reached = m & (cost < _INF) & (lab != _BIG_LAB)
    return torch.where(reached, lab, 0), changed


claim_labels.last_steps = 0


def _tunnelled_phase2(cost, c_changed, img, lab0, m, seeded, connectivity, max_iters,
                      with_flag, kernel=False):
    """Phase 2 on the basins' quotient graph after phase 1's ``cost``: on
    K12 with ``kernel`` (CUDA tensors), else the plain loop.  Either way the
    steps run are kept in ``claim_labels.last_steps``."""
    with stage("pcis.watershed.tunnel"):
        seg, inc, basin_conv = basin_segments(cost, img, m, seeded, connectivity)
        if kernel:
            H, W = img.shape[-2:]
            out, l_changed, claim_labels.last_steps = claim_labels_tunnel_cuda(
                *(t.reshape(-1, H, W) for t in (cost, img, lab0, m, seeded, seg, inc)),
                connectivity, max_iters)
            out, l_changed = out.reshape(img.shape), l_changed.reshape(img.shape[:-2])
        else:
            out, l_changed = claim_labels(cost, img, lab0, m, seeded, connectivity,
                                          max_iters, basins=(seg, inc))
    if with_flag:
        return out, ~(c_changed | l_changed) & basin_conv
    return out


def _own_rows(x: torch.Tensor) -> torch.Tensor:
    """bool [..., h+2, W]: True on a band's own rows 1..h."""
    own = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    own[..., 0, :] = False
    own[..., -1, :] = False
    return own


def _band_edges(state, before) -> torch.Tensor:
    H = state.shape[-2]
    return (state[..., [1, H - 2], :] != before).flatten(-2).any(-1)


def _band_log(steps: int) -> PhaseLog:
    """The plain loop's steps as a PhaseLog (a step a pass, a sync a step)."""
    return PhaseLog(steps, steps, steps, ())


def minimax_costs_band(img, m, seeded, cost, connectivity: int = 1, max_iters: int = 1024):
    """Phase 1 on a row band of a plane (plain Jacobi): [..., h+2, W]
    ``img``, bool ``m`` and ``seeded`` and the float32 ``cost`` to resume
    from, whose rows 0 and h+1 are frozen halo rows (the neighbouring bands'
    rows, or ``_INF`` past the plane's edge: read, never written).  Relaxes
    the band's own rows to their local fixpoint under the halo rows, at most
    ``max_iters`` steps.  Returns (cost, per-plane bool still changing,
    per-plane bool whether the first or last own row changed, PhaseLog)."""
    upd = m & ~seeded & _own_rows(cost)
    before = cost[..., [1, cost.shape[-2] - 2], :]
    changed = torch.ones(cost.shape[:-2], dtype=torch.bool, device=cost.device)
    i = 0
    while i < max_iters and bool(changed.any()):
        best = cost
        for dy, dx in _offsets(connectivity):
            best = torch.minimum(best, torch.maximum(_shifted(cost, dy, dx, _INF), img))
        new = torch.where(upd, best, cost)
        changed = (new != cost).flatten(-2).any(-1)
        cost = new
        i += 1
    return cost, changed, _band_edges(cost, before), _band_log(i)


def claim_labels_band(cost, img, m, seeded, lab, dist, eimg, connectivity: int = 1,
                      max_iters: int = 1024):
    """Phase 2 on a row band (plain Jacobi): resume the claims (``lab``,
    ``dist``, ``eimg``) of [..., h+2, W] bands with frozen halo rows against
    the converged ``cost`` (halo rows included), to the band's local
    fixpoint, at most ``max_iters`` steps.  Returns (lab, dist, eimg, still
    changing, own edge rows changed, PhaseLog), as ``minimax_costs_band``."""
    upd = m & ~seeded & _own_rows(lab)
    H = lab.shape[-2]
    before = [x[..., [1, H - 2], :] for x in (lab, dist, eimg)]
    big = torch.full(lab.shape, _BIG_LAB, dtype=torch.int32, device=lab.device)
    changed = torch.ones(lab.shape[:-2], dtype=torch.bool, device=lab.device)
    i = 0
    while i < max_iters and bool(changed.any()):
        best = (big, torch.full_like(img, _INF), torch.full_like(img, _INF), big)
        for dy, dx in _offsets(connectivity):
            best = fold_claim(best, claim_candidates(cost, img, lab, dist, eimg, dy, dx))
        bd, be, _, bl = best
        new_l = torch.where(upd, bl, lab)
        new_d = torch.where(upd, bd, dist)
        new_e = torch.where(upd, be, eimg)
        changed = ((new_l != lab) | (new_d != dist) | (new_e != eimg)).flatten(-2).any(-1)
        lab, dist, eimg = new_l, new_d, new_e
        i += 1
    edges = (_band_edges(lab, before[0]) | _band_edges(dist, before[1])
             | _band_edges(eimg, before[2]))
    return lab, dist, eimg, changed, edges, _band_log(i)


def minimax_costs_band_auto(img, m, seeded, cost, connectivity: int = 1,
                            max_iters: int = 1024):
    """K10's band mode for CUDA [B, h+2, W] bands (``cost`` relaxed in
    place; ``max_iters`` bounds the passes), ``minimax_costs_band`` for CPU
    tensors (the steps); the same costs wherever both reach the band's local
    fixpoint."""
    _check_args(connectivity)
    if use_kernel(img, m, seeded, cost):
        return minimax_costs_band_cuda(img, m, seeded, cost, connectivity, max_iters)
    return minimax_costs_band(img, m, seeded, cost, connectivity, max_iters)


def claim_labels_band_auto(cost, img, m, seeded, lab, dist, eimg, connectivity: int = 1,
                           max_iters: int = 1024):
    """K11's band mode for CUDA bands (the claims relaxed in place), or
    ``claim_labels_band`` for CPU tensors."""
    _check_args(connectivity)
    if use_kernel(cost, img, m, seeded, lab, dist, eimg):
        return claim_labels_band_cuda(cost, img, m, seeded, lab, dist, eimg, connectivity,
                                      max_iters)
    return claim_labels_band(cost, img, m, seeded, lab, dist, eimg, connectivity, max_iters)


def watershed(
    image: torch.Tensor,
    markers: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    connectivity: int = 1,
    max_iters: int = 1024,
    with_flag: bool = False,
    tunnel_basins: bool = False,
):
    """Flood ``markers`` over the relief ``image`` within ``mask`` (plain
    Jacobi loops).

    Args:
      image: [..., H, W] relief; leading axes are planes flooded together,
        each with its own result.
      markers: [..., H, W] integer marker labels (> 0 seeds, 0 elsewhere).
      mask: optional [..., H, W] bool; pixels outside stay 0.
      connectivity: 1 (4 neighbours) or 2 (8).
      max_iters: bound on the Jacobi steps of each phase.
      with_flag: also return a per-plane bool ``converged`` (batch shape);
        False means a phase ran out of ``max_iters`` with that plane still
        changing (or, with ``tunnel_basins``, the basin CCL did not
        converge), and its labels are not valid.
      tunnel_basins: model the priority flood's basin tunnelling (module
        docstring): better agreement with the priority flood on plateaued or
        quantized reliefs with sparse markers.

    Returns [..., H, W] int32 labels.
    """
    _check_args(connectivity)
    img, lab0, m, seeded = _inputs(image, markers, mask)
    with stage("pcis.watershed.phase1"):
        cost, c_changed = minimax_costs(img, m, seeded, connectivity, max_iters)
    if tunnel_basins:
        return _tunnelled_phase2(cost, c_changed, img, lab0, m, seeded, connectivity,
                                 max_iters, with_flag)
    with stage("pcis.watershed.phase2"):
        out, l_changed = claim_labels(cost, img, lab0, m, seeded, connectivity, max_iters)
    if with_flag:
        return out, ~(c_changed | l_changed)
    return out


def watershed_auto(
    image: torch.Tensor,
    markers: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    connectivity: int = 1,
    with_flag: bool = False,
    max_iters: int = 1024,
    max_sweeps: int = 16,
    *,
    tunnel_basins: bool = False,
):
    """K10 + K11 for CUDA tensors (``max_iters`` bounds the passes of each
    phase), the plain Jacobi loops for CPU tensors (``max_iters`` bounds
    their steps).  The labels are the same wherever both converge.
    ``max_sweeps`` is the JAX package's band-sweep budget, accepted and not
    read (as ``RefineConfig.watershed_max_sweeps``); ``tunnel_basins`` binds
    by keyword only.

    With ``tunnel_basins``, CUDA tensors take K10 for phase 1 and the
    tunnelled phase 2 (K2 for the basins, then K12's Jacobi steps, at most
    ``max_iters``); CPU tensors take ``watershed(..., tunnel_basins=True)``."""
    del max_sweeps
    _check_args(connectivity)
    tensors = [image, markers] + ([] if mask is None else [mask])
    if not use_kernel(*tensors):
        return watershed(image, markers, mask, connectivity=connectivity,
                         max_iters=max_iters, with_flag=with_flag,
                         tunnel_basins=tunnel_basins)
    if not tunnel_basins:
        return watershed_cuda(image, markers, mask, connectivity=connectivity,
                              max_iters=max_iters, with_flag=with_flag)
    img, lab0, m, seeded = _inputs(image, markers, mask)
    H, W = img.shape[-2:]
    with stage("pcis.watershed.phase1"):
        cost, c_changed, _ = minimax_costs_cuda(
            img.reshape(-1, H, W), m.reshape(-1, H, W), seeded.reshape(-1, H, W),
            connectivity, max_iters)
    return _tunnelled_phase2(cost.reshape(img.shape), c_changed.reshape(img.shape[:-2]),
                             img, lab0, m, seeded, connectivity, max_iters, with_flag,
                             kernel=True)
