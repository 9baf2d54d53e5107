"""K10 and K11: the watershed's two CUDA tile passes and the loop that drives
them; K12: the tunnelled phase 2's step and its loop.

Counterpart of ``particle_col_image_segmentation_tpu/ops/watershed_tiles.py``
(``watershed_sweeps`` and its ``_cost_kernel`` / ``_label_kernel`` band
sweeps with their ``_need`` band skipping).  ``csrc/watershed.cu`` relaxes
32×32 tiles with a one-pixel halo in shared memory.  The pass loop stays on
the card: the host enqueues a phase's passes in chunks (8, 16, 32, … passes,
never past ``max_iters``) and syncs once a chunk to read the per-pass,
per-plane change flags.  Pass 1 runs every tile; a later pass runs, from a
worklist the pass before built, only the live tiles (those with a pixel
that can change) whose 3×3-tile neighbourhood changed in the pass before,
so a plane that changed nothing runs no tile again and the passes enqueued
past the fixpoint cost one idle wave each.  Both phases have a unique
fixpoint, so the labels equal the plain ``ops.watershed.watershed`` exactly
wherever both report ``converged``.

The band mode (``minimax_costs_band_cuda``, ``claim_labels_band_cuda``)
runs the same loop on row bands of a plane split over a mesh: each band
carries one frozen halo row above and below, and pass 1 resumes from the
band's state instead of the seeds (``parallel.sharded`` couples the bands).

K12 (``csrc/tunnel.cu``, ``claim_labels_tunnel_cuda``) is phase 2 on the
basins' quotient graph (``ops.watershed.basin_segments``): the plain
Jacobi loop of ``ops.watershed.claim_labels(basins=...)`` step for step,
each step three launches, with the same per-plane flags read by the host
once a step, so the steps and the budget are the plain loop's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import as_planes
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

__all__ = [
    "watershed_cuda", "minimax_costs_cuda", "claim_labels_cuda",
    "minimax_costs_band_cuda", "claim_labels_band_cuda",
    "watershed_cost_pass_cuda", "watershed_label_pass_cuda", "passes_from_history",
    "PhaseLog", "claim_labels_tunnel_cuda", "tunnel_init_cuda",
]

_INF = 3.4e38  # rounds to the float32 the kernels write as 3.4e38f
_BIG_LAB = torch.iinfo(torch.int32).max
_TILE = 32  # csrc/watershed.cu kTile
_FIRST_CHUNK = 8
_MAX_CHUNK = 64


class PhaseLog(NamedTuple):
    """What one phase's loop did: ``passes`` as ``_run`` counts them (the
    last is the first that changed no plane, or ``max_iters``), ``launches``
    (passes enqueued, the chunks' tails past the fixpoint included),
    ``syncs`` (the chunks' readbacks, one a chunk) and ``tiles`` (the tiles each
    launched pass ran, summed over planes; a plane has
    ceil(H/32)·ceil(W/32))."""

    passes: int
    launches: int
    syncs: int
    tiles: tuple


def watershed_cost_pass_cuda(img, flags, cost, prev_row, row, tiles, pass_no: int,
                             connectivity: int, resume: bool = False) -> None:
    """K10: pass ``pass_no`` (1, 2, …) of phase 1 over [B, H, W] planes,
    ``cost`` relaxed in place; pass 1 writes the starting costs itself, or
    with ``resume`` (the band mode) relaxes the costs it is given.
    ``prev_row`` / ``row`` are the previous and this pass's int32 rows of
    the history, B + 3 each, ``row`` zeroed by the caller: changed[b] = 1
    where plane b changed, then the tiles run, the length of the next
    pass's tile list and the count of this pass's list entries claimed.  ``tiles`` is the phase's int32
    scratch, 4 a 32×32 tile (two tile lists, stamps that the caller zeroes
    before pass 1, live bits)."""
    B, H, W = as_planes("watershed_cost_pass_cuda", cost)
    lib = _kernels.library()
    with torch.cuda.device(cost.device):
        err = lib.pcis_watershed_cost(
            img.data_ptr(), flags.data_ptr(), cost.data_ptr(), prev_row.data_ptr(),
            row.data_ptr(), tiles.data_ptr(), pass_no, B, H, W, connectivity, int(resume),
            _kernels.stream_of(cost),
        )
    _kernels.check(err, "watershed_cost_pass_cuda")
    _kernels.count_launch(watershed_cost_pass_cuda)


watershed_cost_pass_cuda.launches = 0


def watershed_label_pass_cuda(cost, img, flags, markers, lab, dist, eimg, prev_row, row,
                              tiles, pass_no: int, connectivity: int,
                              resume: bool = False) -> None:
    """K11: pass ``pass_no`` of phase 2, (``lab``, ``dist``, ``eimg``)
    relaxed in place against the converged ``cost``; pass 1 writes the
    starting state from ``flags`` and the int32 ``markers``, or with
    ``resume`` relaxes the state it is given (``markers`` may then be
    None).  Rows and scratch as for K10."""
    B, H, W = as_planes("watershed_label_pass_cuda", lab)
    lib = _kernels.library()
    with torch.cuda.device(lab.device):
        err = lib.pcis_watershed_label(
            cost.data_ptr(), img.data_ptr(), flags.data_ptr(),
            None if markers is None else markers.data_ptr(),
            lab.data_ptr(), dist.data_ptr(), eimg.data_ptr(), prev_row.data_ptr(),
            row.data_ptr(), tiles.data_ptr(), pass_no, B, H, W, connectivity, int(resume),
            _kernels.stream_of(lab),
        )
    _kernels.check(err, "watershed_label_pass_cuda")
    _kernels.count_launch(watershed_label_pass_cuda)


watershed_label_pass_cuda.launches = 0


def passes_from_history(changed, max_iters: int):
    """(passes, per-plane bool converged) from the per-pass change flags
    ``changed`` [passes run, B] of a phase, or None while undecided.

    A phase stops after the first pass that changed no plane, or after
    ``max_iters`` passes; a plane has converged when it changed nothing in
    that last pass.  Passes run past the stop (a chunk's tail, in which
    every plane is idle) do not count."""
    changed = np.asarray(changed) != 0
    idle = np.flatnonzero(~changed.any(axis=1))
    if idle.size:
        passes = int(idle[0]) + 1
    elif changed.shape[0] >= max_iters:
        passes = max_iters
    else:
        return None
    return passes, ~changed[passes - 1]


def _run(pass_fn, B: int, H: int, W: int, device, max_iters: int):
    """Enqueue passes ``pass_fn(prev_row, row, tiles, pass_no)`` in chunks
    of 8, 16, 32, … (at most 64, never past ``max_iters``), reading the
    chunk's rows once at its end, until ``passes_from_history`` decides.
    Returns (per-plane bool converged on ``device``, PhaseLog)."""
    if max_iters < 1:
        raise ValueError(f"watershed: max_iters must be >= 1, got {max_iters}")
    n_tiles = B * -(-H // _TILE) * -(-W // _TILE)
    tiles = torch.empty(4 * n_tiles, dtype=torch.int32, device=device)
    tiles[2 * n_tiles:3 * n_tiles] = 0  # stamps
    last = torch.zeros(B + 3, dtype=torch.int32, device=device)  # "pass 0"
    history, tiles_run, syncs, done, chunk = [], [], 0, 0, _FIRST_CHUNK
    while True:
        n = min(chunk, max_iters - done)
        rows = torch.zeros((n + 1, B + 3), dtype=torch.int32, device=device)
        rows[0] = last
        for j in range(n):
            pass_fn(rows[j], rows[j + 1], tiles, done + j + 1)
        with stage("pcis.sync.watershed_chunk"):
            host = rows[1:].cpu().numpy()  # the chunk's one host sync
        syncs += 1
        history.append(host[:, :B])
        tiles_run.extend(host[:, B].tolist())
        done += n
        decided = passes_from_history(np.concatenate(history), max_iters)
        if decided is not None:
            passes, converged = decided
            with stage("pcis.sync.watershed_flags"):  # a copy from pageable memory
                converged = torch.from_numpy(converged).to(device)
            return converged, PhaseLog(passes, done, syncs, tuple(tiles_run))
        last = rows[n]
        chunk = min(2 * chunk, _MAX_CHUNK)


def _flags(m: torch.Tensor, seeded: torch.Tensor) -> torch.Tensor:
    """uint8 flags of the kernels: bit 0 in the mask, bit 1 a seed."""
    return m.view(torch.uint8) | (seeded.view(torch.uint8) << 1)


def minimax_costs_cuda(img, m, seeded, connectivity: int = 1, max_iters: int = 1024):
    """Phase 1 on K10, for CUDA [B, H, W] float32 ``img`` and bool ``m`` and
    ``seeded``: (cost, per-plane bool still changing, PhaseLog).  The costs
    equal ``ops.watershed.minimax_costs``'s wherever both converge."""
    img = img.contiguous()
    flags = _flags(m.contiguous(), seeded.contiguous())
    _kernels.require_cuda("minimax_costs_cuda", img, flags)
    B, H, W = img.shape
    cost = torch.empty_like(img)  # the first pass writes every pixel
    converged, log = _run(
        lambda *state: watershed_cost_pass_cuda(img, flags, cost, *state, connectivity),
        B, H, W, img.device, max_iters)
    return cost, ~converged, log


def claim_labels_cuda(cost, img, lab0, m, seeded, connectivity: int = 1,
                      max_iters: int = 1024):
    """Phase 2 on K11 against a converged ``cost``: (labels, per-plane bool
    still changing, PhaseLog), as ``ops.watershed.claim_labels``."""
    img = img.contiguous()
    markers = lab0.to(torch.int32).contiguous()
    flags = _flags(m.contiguous(), seeded.contiguous())
    _kernels.require_cuda("claim_labels_cuda", cost, img, flags, markers)
    B, H, W = img.shape
    # the first pass writes every pixel's starting state
    lab = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    dist = torch.empty_like(lab)
    eimg = torch.empty_like(img)
    converged, log = _run(
        lambda *state: watershed_label_pass_cuda(cost, img, flags, markers, lab, dist, eimg,
                                                 *state, connectivity),
        B, H, W, img.device, max_iters)
    reached = m & (cost < _INF) & (lab != _BIG_LAB)
    return torch.where(reached, lab, 0), ~converged, log


def _band_flags(m: torch.Tensor, seeded: torch.Tensor) -> torch.Tensor:
    """The kernels' flags of [B, h+2, W] bands: the halo rows (0 and h+1)
    carry none, so the kernels read them and never write them."""
    flags = _flags(m.contiguous(), seeded.contiguous())
    flags[:, 0] = 0
    flags[:, -1] = 0
    return flags


def _edge_rows_changed(state, before) -> torch.Tensor:
    """Per plane: whether the band's first or last own row (rows 1 and h of
    [B, h+2, W]) differs from ``before``."""
    H = state.shape[-2]
    return (state[:, [1, H - 2]] != before).flatten(1).any(1)


def minimax_costs_band_cuda(img, m, seeded, cost, connectivity: int = 1,
                            max_iters: int = 1024):
    """Phase 1 on K10's band mode: resume the costs ``cost`` (relaxed in
    place) of CUDA [B, h+2, W] bands, whose rows 0 and h+1 are frozen halo
    rows, to the bands' local fixpoint (at most ``max_iters`` passes).
    Returns (cost, per-plane bool still changing, per-plane bool whether the
    first or last own row changed, PhaseLog); equal to
    ``ops.watershed.minimax_costs_band``."""
    img = img.contiguous()
    flags = _band_flags(m, seeded)
    _kernels.require_cuda("minimax_costs_band_cuda", img, flags, cost)
    B, H, W = cost.shape
    before = cost[:, [1, H - 2]]
    converged, log = _run(
        lambda *state: watershed_cost_pass_cuda(img, flags, cost, *state, connectivity,
                                                resume=True),
        B, H, W, img.device, max_iters)
    return cost, ~converged, _edge_rows_changed(cost, before), log


def claim_labels_band_cuda(cost, img, m, seeded, lab, dist, eimg, connectivity: int = 1,
                           max_iters: int = 1024):
    """Phase 2 on K11's band mode: resume the claims (``lab``, ``dist``,
    ``eimg``, relaxed in place) of CUDA [B, h+2, W] bands with frozen halo
    rows against the converged ``cost``.  Returns (lab, dist, eimg, still
    changing, own edge rows changed, PhaseLog); equal to
    ``ops.watershed.claim_labels_band``."""
    img = img.contiguous()
    flags = _band_flags(m, seeded)
    _kernels.require_cuda("claim_labels_band_cuda", cost, img, flags, lab, dist, eimg)
    B, H, W = lab.shape
    before = [x[:, [1, H - 2]] for x in (lab, dist, eimg)]
    converged, log = _run(
        lambda *state: watershed_label_pass_cuda(cost, img, flags, None, lab, dist, eimg,
                                                 *state, connectivity, resume=True),
        B, H, W, img.device, max_iters)
    edges = (_edge_rows_changed(lab, before[0]) | _edge_rows_changed(dist, before[1])
             | _edge_rows_changed(eimg, before[2]))
    return lab, dist, eimg, ~converged, edges, log


def watershed_cuda(
    image: torch.Tensor,
    markers: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    connectivity: int = 1,
    max_iters: int = 1024,
    with_flag: bool = False,
):
    """The watershed of CUDA [..., H, W] planes on K10 and K11.

    Same arguments and result as ``ops.watershed.watershed``, except that
    ``max_iters`` bounds the passes of each phase (one pass relaxes every
    32×32 tile that may change to its local fixpoint).  A plane still
    changing when a phase's budget runs out reports ``converged`` False;
    phase 2 starts once phase 1 has stopped on every plane.  The pass counts
    of the last call are kept in ``watershed_cuda.last_passes`` as (phase 1,
    phase 2), and each phase's PhaseLog in ``watershed_cuda.last_logs``."""
    if connectivity not in (1, 2):
        raise ValueError(f"watershed_cuda: connectivity must be 1 or 2, got {connectivity}")
    for t in (markers, mask):
        if t is not None and t.shape != image.shape:
            raise ValueError(
                f"watershed_cuda: shapes differ: {tuple(t.shape)} and {tuple(image.shape)}"
            )
    B, H, W = as_planes("watershed_cuda", image)
    img = image.to(torch.float32).reshape(B, H, W)
    lab0 = markers.to(torch.int32).reshape(B, H, W)
    m = (torch.ones_like(lab0, dtype=torch.bool) if mask is None
         else mask.to(torch.bool).reshape(B, H, W))
    seeded = (lab0 > 0) & m
    with stage("pcis.watershed.phase1"):
        cost, c_changed, log1 = minimax_costs_cuda(img, m, seeded, connectivity, max_iters)
    with stage("pcis.watershed.phase2"):
        out, l_changed, log2 = claim_labels_cuda(cost, img, lab0, m, seeded, connectivity,
                                                 max_iters)
    watershed_cuda.last_passes = (log1.passes, log2.passes)
    watershed_cuda.last_logs = (log1, log2)
    out = out.reshape(image.shape)
    if with_flag:
        return out, ~(c_changed | l_changed).reshape(image.shape[:-2])
    return out


watershed_cuda.last_passes = (0, 0)
watershed_cuda.last_logs = ()


def tunnel_init_cuda(flags, markers, seg, kind, lab, dist, eimg, slots, lists, changed,
                     counts, connectivity: int) -> None:
    """K12's set-up before step 0, one launch: both halves of the state pairs
    ``lab``, ``dist`` (int32) and ``eimg`` (float32) [2, B, H, W] from the
    uint8 ``flags`` and int32 ``markers``, the uint8 pixel kinds ``kind``
    from the flags and the int32 segment ids ``seg``, the roots' entries of
    the int64 ``slots`` [3, B, H, W], the int32 ``lists`` [5, words] (step
    0's list of words, the words every step visits, the basins' words, the
    stamps; a word is 32 pixels of a row), and the int32 ``changed`` [2, B]
    zeroed; ``counts`` (int32 [4]) arrives zeroed."""
    B, H, W = as_planes("tunnel_init_cuda", seg)
    lib = _kernels.library()
    with torch.cuda.device(seg.device):
        err = lib.pcis_tunnel_init(
            flags.data_ptr(), markers.data_ptr(), seg.data_ptr(), kind.data_ptr(),
            lab.data_ptr(), dist.data_ptr(), eimg.data_ptr(), slots.data_ptr(),
            lists.data_ptr(), changed.data_ptr(), counts.data_ptr(), B, H, W, connectivity,
            _kernels.stream_of(seg),
        )
    _kernels.check(err, "tunnel_init_cuda")
    _kernels.count_launch(tunnel_init_cuda)


tunnel_init_cuda.launches = 0


def claim_labels_tunnel_cuda(cost, img, lab0, m, seeded, seg, inc, connectivity: int = 1,
                             max_iters: int = 1024):
    """Phase 2 on the basins' quotient graph on K12, for CUDA [B, H, W]
    tensors: ``cost``, ``img`` (float32), ``lab0`` (the markers), bool ``m``
    and ``seeded``, and the int32 ``seg`` and ``inc`` of
    ``ops.watershed.basin_segments``.  Runs the steps of
    ``ops.watershed.claim_labels(basins=(seg, inc))``, at most
    ``max_iters``, reading each step's per-plane flags on the host, and
    returns what it returns: (labels, per-plane bool still changing), and
    the steps run.  ``claim_labels_tunnel_cuda.launches`` counts the steps'
    launches, three a step."""
    img, cost, seg, inc = (t.contiguous() for t in (img, cost, seg, inc))
    markers = lab0.to(torch.int32).contiguous()
    flags = _flags(m.contiguous(), seeded.contiguous())
    _kernels.require_cuda("claim_labels_tunnel_cuda", cost, img, seg, inc, flags, markers)
    if seg.dtype != torch.int32 or inc.dtype != torch.int32:
        raise ValueError("claim_labels_tunnel_cuda: seg and inc must be int32")
    B, H, W = as_planes("claim_labels_tunnel_cuda", cost)
    dev = cost.device
    words = B * H * -(-W // 32)
    lab = torch.empty((2, B, H, W), dtype=torch.int32, device=dev)  # init writes both
    dist = torch.empty_like(lab)
    eimg = torch.empty((2, B, H, W), dtype=torch.float32, device=dev)
    kind = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    slots = torch.empty((3, B, H, W), dtype=torch.int64, device=dev)
    lists = torch.empty((5, words), dtype=torch.int32, device=dev)
    rim = torch.empty(words, dtype=torch.int32, device=dev)
    changed = torch.empty((2, B), dtype=torch.int32, device=dev)
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    tunnel_init_cuda(flags, markers, seg, kind, lab, dist, eimg, slots, lists, changed, counts,
                     connectivity)
    # a step's flags land in page-locked memory (the step's own copy), and
    # the host reads them after waiting on the stream: the loop holds its
    # arguments, the device guard and the stream from the first step on
    host = torch.empty(B, dtype=torch.int32, pin_memory=True)
    host_flags = host.numpy()
    stream = torch.cuda.current_stream(dev)
    args = tuple(t.data_ptr() for t in (cost, img, inc, seg, kind, lab, dist, eimg, slots, rim,
                                        lists, changed, counts))
    shape = (B, H, W, connectivity, stream.cuda_stream, host.data_ptr())
    lib = _kernels.library()
    steps, going, err = 0, True, 0
    with torch.cuda.device(dev):
        while steps < max_iters and going:
            err = lib.pcis_tunnel_step(*args, steps, *shape)
            if err:
                break
            steps += 1
            with stage("pcis.sync.tunnel_step"):  # the step's flags: one host sync a step
                stream.synchronize()
                going = bool(host_flags.any())
    _kernels.count_launch(claim_labels_tunnel_cuda, 3 * steps)
    _kernels.check(err, "claim_labels_tunnel_cuda")
    state = lab[steps % 2]
    still = (changed[(steps - 1) % 2] != 0 if steps
             else torch.ones(B, dtype=torch.bool, device=dev))
    reached = m & (cost < _INF) & (state != _BIG_LAB)
    return torch.where(reached, state, 0), still, steps


claim_labels_tunnel_cuda.launches = 0
