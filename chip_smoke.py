#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one Hopper card.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases (each prints as it goes; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. environment — card name and power limit, torch/CUDA versions, compute
     capability (must be 9.x), whether triton, h5py and matplotlib import
     (nothing below needs them), the nvcc in use, whether g++ runs and
     finds zlib.h (the native TIFF codec's build) and whether PIL imports;
     the port's subpackages import (with their re-exports) and pull in
     neither h5py nor matplotlib;
  2. build — the eleven kernels K1-K11 from csrc/ (one nvcc per source,
     in parallel), timed;
  3. kernel vs plain — each kernel against its plain PyTorch version on the
     same card tensors, exact equality (all outputs are integers, so the
     tolerance is 0): 2048² bench planes, odd [3,97,130] batches, 2-D
     planes, background=0 and 4-connected CCL, int32 values, saturating
     sums (both K4 wrappers: class tables and the dedup's clamped sums),
     table overflow (max_regions=8), out-of-range lookup ids, fill steps
     with and without particles; K6 on ``k6_inputs`` (ids and table values
     at INT32_MIN/MAX, R = 1 to 40000 with [R] and [B,R] tables, H*W not a
     multiple of 4, B = 64, views off a 16-byte boundary); K4 as the Otsu
     histogram (bin ids, R+1 = 256, uint8 zeros) against the plain bincount
     on ``hist_inputs`` (a constant plane, 1x1 planes, every bin hit), on
     config #1's [16,512,512] batch and on config #2's blurred
     [24,2048,2048] stack; K9 on ``k9_inputs`` over both routes (caps
     0-3, 8, 9, 31-33 on sparse, dense, empty and full masks, the largest
     one-kernel cap and the one past it, features at cap and cap + 1 from
     tile edges, cap > H, odd shapes, a view off a 16-byte boundary), each
     cap's route and the flag "some d² > cap²" checked; the float32 square
     root (``sqrt_f32``) equal to numpy's for every d² below 2^24 and 2^20
     d² past it; K2's adversarial inputs (``k2_inputs``:
     one value, a serpentine crossing every tile, checkerboards, 1-px
     stripes, binary noise, int32 extremes, widths 1-129), each equal to
     scipy's min-index labels (``scipy_min_index``) and, where the plain
     fixpoint converges in 256 rounds, to it; K1 at sizes 3-9 on [3,2,5]
     and planes around its 32 x 64 tile, past num_classes, and off a
     16-byte boundary; and the refine slice on the 2048² relief
     (480 touching cell pairs, plane b rolled by 17·b columns): the exact
     EDT (K9 probe, and a plane that forces the exact fallback), local
     maxima through K2 (connectivity 1 and 2), each watershed phase — K10's
     costs and K11's labels — on smooth and 16-level reliefs at
     [2,2048,2048] (connectivity 1 and 2), an unreachable masked island, a
     random [3,97,130] relief, a serpentine corridor (``ws_corridor``: tiles
     go quiet and wake again) and a batch of a few- and a many-pass plane
     (``ws_mixed``), and budgets of 1, 2, need − 1 and need passes
     (``ws_budgets``: planes that report converged equal plain, one pass
     converges none), refine_plane_device's distance equal to numpy's
     sqrt of its d², and K7 on the [8,2048,2048] watershed labels, a 2-D
     plane and ``k7_inputs`` (one id over 2048², runs crossing rows and
     planes, ids past R, R+1 = 4096 and 4097 with colliding slots, R+1 =
     30001, an id a pixel, B = 64, a view off a 16-byte boundary); K3 on raw
     that is not CCL output (``k3_inputs``: forward references, non-root
     targets, values past the plane, INT32_MIN/MAX, 1x1 planes, widths
     1-129, H*W not a multiple of 4 or of its 4096-px tile, a view off a
     16-byte boundary, B = 64) and both K4 wrappers on ``k4_inputs`` (one
     id over a 2048² plane at 255, every pixel its own id, ids < 0 and
     > R, R+1 = 40000, int32 sums that saturate, odd H*W, views off a
     16-byte boundary); K5 on ``k5_inputs`` (those, then runs meeting row
     and plane ends at widths 1-130, B = 1 and 64, an id a pixel over
     2048², ids sharing their low 12 bits); K8 on ``k8_inputs`` over both
     routes (caps 0, 1, 2, 20, 32, 33, the largest one-kernel cap and the
     one past it, particles at cap and cap + 1 from tile edges, dt2 > (cap + 1)²
     with and without particles, no cell pixel, odd shapes, B = 1), each
     cap's route checked;
  4. batch path — run_batch over 40 bench planes in batches of 32 (the last
     one short and padded), max_regions=16383: every plane converged, no
     overflow, particle_px equal to scipy's median count; plane 0's labels
     equal to scipy's; planes 0-3 equal to the plain path on the card; K1-K4
     launched (launch counts reset just before the run);
  5. times — the fused pass on a device-resident [32,2048,2048] batch (and
     its peak device memory) and K1-K4 at that shape, K3 and K4 beside
     their library yardsticks (one sorted torch.unique with inverse, whose
     ids are checked against K3's once; two torch.bincount) and K3's
     torch.profiler split (bits / scan / ranks); K5 and K8 at [8,2048,2048]
     (R+1 = 16385, cap 20) and at [1,2048,2048], by CUDA events and by
     their device time a call under torch.profiler,
     K9 at [16,2048,2048] (cap 2, the merge contexts) and at [8,2048,2048]
     cap 32 (refine's probe, with its bound), K6 at [2048,2048];
     K2 on its three callers' inputs — [32,2048,2048] uint8 den,
     [16,2048,2048] uint8 merge contexts, [8,2048,2048] int32 EDT² — by
     CUDA events, with torch.profiler's local / merge / flatten split;
     analyze_planes_device on a device-resident [8,2048,2048] batch — each
     through the kernels and through the plain versions, by CUDA events (no
     thresholds); K7 at [8,2048,2048] (R = 4096) beside one ``index_add_``
     of its five digit columns; each watershed phase on the [8,2048,2048]
     relief (its whole pass loop inside the events; its passes, launches,
     host syncs, the device time of its passes by torch.profiler, and the
     tiles each pass ran);
     refine_plane_device on that relief, kernels and plain, on the card;
     K6 by device time too; the threshold path (``threshold_times``):
     config #1's single plane and [16,512,512] batch and config #2's
     stack_stats at [24,512,512] and [24,2048,2048], kernels and plain,
     by CUDA events and device time, the [24,2048,2048] call split by step
     (blur, min/max, bin ids, K4 histogram, Otsu, mask, K2, K3, K4 counts),
     K4's histogram launch beside one torch.bincount of the offset ids and
     K2 on the binary mask, each with its bound;
  6. analyze path — run_analysis over a folder tree of 2048² bench planes
     (8 single-file 3D05 folders, batched 8 at a time, and one 3D05+6B07
     folder with RFP and DAPI files: per-channel analysis, DAPI dedup,
     fusion, merged re-analysis), the default AnalysisConfig, read through
     a load_fn from empty placeholder .h5 files: every K1-K6, K8, K9 launched
     (counts reset just before the run); every CSV of one single-file
     folder and of the RFP+DAPI folder (and their density rows)
     byte-identical to the same flow through the plain versions on the CPU;
     dapi_dedup_device at 2048² and a [2,1024,1024] crop through
     analyze_planes_device, kernels on the card equal to plain on the CPU;
  7. profile, only with --profile — see ``profile_phase``;
  8. refine path — refine_boundaries_stack over the [8,2048,2048] relief on
     the card: K2, K3, K7, K9, K10 and K11 launched (counts reset just
     before the run), labels, cell counts, areas and centroids equal to the
     plain run on the card; the stack CSV of a [2,1024,1024] crop equal to
     the plain CPU run's byte for byte; the passes, launches and host syncs
     of each watershed phase;
  9. threshold path (``threshold_phase``) — threshold_and_count on config
     #1's 512² uint16 plane, threshold_and_count_batch on its [16,512,512]
     batch (plane b rolled by 7·b columns) and config #2's stack_stats on
     [24,512,512] and [24,2048,2048] stacks (bench.py's recipes; 30 and 480
     discs a plane), max_regions=4095: K2, K3 and K4 launched (K4 twice a
     call: the Otsu histogram and the region table; counts reset just
     before the run), thresholds bit for bit, masks, labels, count, num_fg
     and num_total equal to the plain versions on the card (labels where
     the plain CCL converged, K2 equal to scipy's on the other planes),
     each plane's count and num_total equal to scipy.ndimage.label's on
     img > t, the [16,512,512] batch's thresholds, masks and counts equal
     to the plain CPU run's, the [24,512,512] stack's blur and
     thresholds (plane 6 holds an Otsu near-tie) equal to the CPU's, and
     the single-plane histogram and otsu_threshold of config #1's plane
     (one K4 launch each) equal to the plain CPU histogram and the call's
     threshold.  The [24,2048,2048] stack is made once on the host and is
     on the card only in phase 3's histogram check, phase 5's threshold
     times and phase 9;
 10. config #2 from TIFFs on disk (``zstack_phase``) — four [24,512,512]
     and two [24,2048,2048] stacks (``config2_stacks``) written as
     multi-page uint16 TIFFs, each decoded by the port's native codec bit
     for bit (no PIL time is taken for it); host copies into a fresh and
     a reused buffer, the pinned host-to-device copy, stack_stats,
     bench.py's end-to-end MP/s (decode inside the timer) and the same
     loop stepped (decode, pageable copy, compute per stack) by CUDA events
     and the host's clock, K2, K3 and K4 launched (counts reset just before
     the end-to-end runs); every
     stack's blur and thresholds equal to the plain CPU run's, masks to
     the CPU's den > t, counts and num_total to scipy's; a CPU baseline
     (scipy blur, numpy Otsu, scipy label) for vs_cpu; then the split and
     normalize verbs in fresh interpreters (``split_and_normalize``).
 11. the morphology/EDT API and config #4 — ``morph_phase``: erode, open
     and close_disk at r 2 and 20, fill_holes, edt at cap 20 and
     boundary_mask on the bench planes' [4,2048,2048] cell masks once with
     launch counts (K9 and K2), then each by CUDA events beside its plain
     route; ``nanosims_phase``: two acquisitions (the 768² painting of 121
     squares and the grid painted at 700x650, eight [514,514] .mat images
     each) through run_nanosims on the card (K2 and K3 launched) against
     the plain CPU run (ROI counts, labels, resized masks and positions bit
     for bit, sums and every CSV within rtol 1e-6), the ``nanosims`` verb
     in a fresh interpreter, and times: run_nanosims and the same flow
     stepped, the per-ROI reduction alone (bench.py's
     ``4_nanosims_ms_per_acq``, ``4_nanosims_rois_per_s``) and bench's
     scipy baseline (``4_vs_cpu``);
 12. the tunnelled refine (``tunnel_phase``) — refine_boundaries_stack with
     tunnel_basins=True over the [8,2048,2048] relief, smooth and at 16
     levels: K2, K3, K7, K9 and K10 launched and K11 not (counts reset
     just before each run); labels, cell counts, areas and centroids equal
     to the plain run on the card on every plane where the plain run
     converged; every plane's basin segments (K2 on the below-level mask)
     equal to scipy's min-index labels (``basins_vs_scipy``); boundary IoU
     of the card's default and tunnelled labels against the port's oracle
     priority flood (``tunnel_quality``: bench.py's 512² relief, smooth
     and 16 levels, where the tunnel may lose at most 0.005, and an 8-level
     sparse-seed relief, where it must gain 0.2); CUDA-event times
     (tunnelled and default refine_plane_device, phase 2's steps and ms a
     step, the basin segments and K2 alone) and peak device memory; the
     ``refine --tunnel-basins`` verb in a fresh interpreter where h5py
     imports (the card's machine has none: the phase says it skipped it).
 13. the data axis (``data_axis_phase``) — see its docstring;
 14. the space axis (``space_axis_phase``) — meshes that name ``cuda:0`` 2
     and 4 times: run_batch over phase 4's 40 planes on 1x2, 1x4 and 2x2
     (and 1x4 with the positions in the main thread) equal to phase 4's
     stats; analyze_plane_device_sharded of plane 0 at n_space 2 and 4 and
     of an [8192,2048] plane at 4 equal to analyze_plane_device field for
     field; run_analysis on a 1x4 mesh over folder 0 and the RFP+DAPI
     folder equal to phase 6's CSVs byte for byte; K1-K6, K8 and K9
     launched; each run's wall, launches, the card's peak, one position's
     working set and the seam joins' host time;
 15. the spatial refine (``space_refine_phase``) — refine_boundaries_sharded
     over phase 8's [8,2048,2048] relief on 1x2, 1x4 and 2x2 meshes of
     ``cuda:0`` equal to phase 8's results field for field and its stack
     CSV byte for byte; an [8192,2048] relief plane (``tall_relief``) at
     n_space 4 and a [2,2048,2048] relief with a disc deeper than the probe
     cap across the seam (``deep_seam_relief``: the exact-EDT fallback) at
     n_space 2 and 4 equal to refine_plane_device (labels, markers, counts,
     centroid sums); K2, K3, K6, K7, K9, K10 and K11 launched; each run's
     wall, each watershed phase's rounds, passes a round and host syncs,
     the card's peak and one position's working set;
 16. multi-host (``multihost_phase``) — two fresh interpreters
     (``MULTIHOST_CHILD``, a free loopback port, a time limit of
     ``MULTIHOST_TIMEOUT_S``; a failed child has its peer killed), each
     ``initialize_multihost(coordinator, 2, pid, devices=["cuda:0",
     "cuda:0"])`` (a global 2x2 mesh), then again with the default devices
     (one card a process: 2x1); each runs make_sharded_segment_fn with
     tables on its rows of phase 4's first [4,2048,2048] planes and gathers
     with process_allgather(tiled=True); both processes' gathered outputs
     equal to the one-device pass on the card at tolerance 0; K1-K4, K6
     and K8 launched in each child's counted run (after a warm-up); each
     child's launches, wall, gather time and peak, beside the same
     function on a 1x1 mesh and fused_segment_batch;
 17. the oracle at full width (``oracle_phase``) — the card's
     analyze_plane(merged=True) on bench plane 0 (one strain) and on phase
     6's RFP and DAPI planes fused (two strains), each held field for field
     to the port's oracle (``oracle.parity.assert_plane_parity``); the
     oracle's host seconds.
Phase 3 also holds the band modes of the space axis (``band_checks``): K1
on row-padded bands, K5 with a row offset (its value sums too; one offset of
2^20 + 77 whose digits carry) and K8 counting its own rows (both routes), on
512-row bands of the bench planes and 48-row bands of the odd batch, where
the halos reach over several bands, each against its plain version; and
those of the spatial refine (``refine_band_checks``): K7 with a row offset
(and 2^20 + 77), K9's flag over the band's own rows (cap 32 and 2, 32 halo
rows) and K10 and K11 resuming each band in every round of the band-coupled
watershed against the plain band phases from the same state, on 512-row
bands of a relief plane and 48-row bands of three corridors at the odd
batch's size (``ws_corridor``, whose flood crosses the seam).
Phase 3 also holds the morphology/EDT API (``morph_checks``): erode, open
and close_disk (K9) at r 0, 1, 2, 20, the largest one-kernel cap and one
past it, fill_holes (K2; a serpentine past a budget of 3 compared where
the plain flood converged), edt at cap 20 (bit patterns) and boundary_mask
(card against CPU) on the bench planes' cell and particle masks and the
odd [3,97,130] batch, each against its plain route on the card.
The line before the last is the per-kernel JSON record (``launches`` sums
the batch, analyze, refine, threshold, zstack, morphology, nanosims,
tunnel, data axis, space axis, spatial refine, multi-host (both phase 16
children of both runs) and oracle paths' runs,
``bound_ms`` is the bytes each function must move over 3.35 TB/s,
``more_shapes`` holds K2's and K4's threshold-path shapes and K6's device
time; ``zstack`` holds phase 10's numbers, ``nanosims`` and
``morphology`` phase 11's, ``tunnel`` phase 12's, ``data_axis`` phase 13's,
``space_axis`` phase 14's, ``space_refine`` phase 15's, ``multihost``
phase 16's, ``oracle`` phase 17's); the last line is {"ok": true, ...}.

The script (and phase 16's children) imports the port, bench.py's plane
generator, numpy, scipy and PIL: nothing of JAX and nothing of the JAX
package, which it checks before the record line.  CSV parity of the port with the JAX package is held in
tests/test_torch_analysis.py, tests/test_torch_refine.py and
tests/test_torch_nanosims.py.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

H = W = 2048
BATCH = 32
MAX_REGIONS = 16383
N_MAIN = 40
ANALYZE_REGIONS = 16384  # AnalysisConfig().max_regions: R+1 = 16385
REFINE_REGIONS = 4095  # refine's default: R+1 = 4096
REFINE_PLANES = 8
TH_REGIONS = 4095  # configs #1 and #2 in bench.py
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SRC = "particle_col_image_segmentation_tpu_torch/csrc/"
TPU = "particle_col_image_segmentation_tpu/ops/"
KERNELS = [  # key, name, source, TPU kernel it replaces
    ("K1", "K1 median", "median.cu", "filters_tiles.py:36"),
    ("K2", "K2 ccl", "ccl.cu", "ccl_tiles.py:177"),
    ("K3", "K3 compact", "compact.cu", "ccl_tiles.py:375"),
    ("K4", "K4 region counts", "counts.cu", "regionprops_tiles.py:80"),
    ("K5", "K5 region table", "table.cu", "regionprops_tiles.py:226"),
    ("K6", "K6 table lookup", "lookup.cu", "regionprops_tiles.py:558"),
    ("K7", "K7 centroid table", "table.cu", "regionprops_tiles.py:435"),
    ("K8", "K8 particle fill", "fill.cu", "fill_tiles.py:37"),
    ("K9", "K9 capped edt", "edt.cu", "edt_tiles.py:41"),
    ("K10", "K10 watershed costs", "watershed.cu", "watershed_tiles.py:191"),
    ("K11", "K11 watershed labels", "watershed.cu", "watershed_tiles.py:244"),
]
SINGLE = ((1, "3D05"), (2, "Particle"), (3, "Background"))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def imports(name: str) -> str:
    try:
        mod = __import__(name)
    except ImportError as e:
        return f"does not import ({e})"
    return f"imports ({getattr(mod, '__version__', '?')})"


def host_compiler() -> str:
    """Whether g++ runs and finds zlib.h, which the port's native TIFF codec
    (io/native/pcis_io.cpp) needs."""
    try:
        res = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                             input="#include <zlib.h>\n", capture_output=True, text=True,
                             timeout=60)
    except OSError as e:
        return f"does not run ({e})"
    if res.returncode != 0:
        return f"runs, zlib.h not found ({res.stderr.strip()[:200]})"
    return "runs, zlib.h found"


def scipy_labels(den):
    """Reference labels of a class plane, independent of the port: every
    pixel labelled, 8-connected equal values (one scipy.ndimage.label per
    class), ids 1..N in raster order of each component's first pixel."""
    import numpy as np
    from scipy import ndimage as ndi

    lab = np.zeros(den.shape, np.int64)
    n = 0
    for v in np.unique(den):
        part, k = ndi.label(den == v, structure=np.ones((3, 3), int))
        lab[part > 0] = part[part > 0] + n
        n += k
    _, first = np.unique(lab, return_index=True)  # first pixel of ids 1..n
    rank = np.empty(n, np.int64)
    rank[np.argsort(first)] = np.arange(1, n + 1)
    return rank[lab - 1], n


def scipy_min_index(img, background=None, connectivity: int = 8):
    """K2's contract from scipy, independent of the port: every pixel the
    minimum linear index of its component of equal values (8- or
    4-connected, one scipy.ndimage.label per value; a component's first
    pixel in raster order is its minimum), pixels equal to ``background``
    -1.  ``img`` is [H, W] or [B, H, W]."""
    import numpy as np
    from scipy import ndimage as ndi

    out = np.full(img.shape, -1, np.int32)
    structure = np.ones((3, 3), int) if connectivity == 8 else None
    for b in np.ndindex(img.shape[:-2]):
        plane, dst = img[b], out[b]
        for v in np.unique(plane):
            if background is not None and v == background:
                continue
            part, k = ndi.label(plane == v, structure=structure)
            ids, first = np.unique(part.ravel(), return_index=True)
            lut = np.zeros(k + 1, np.int32)
            lut[ids[ids > 0]] = first[ids > 0]
            on = part > 0
            dst[on] = lut[part[on]]
    return out


def k2_inputs(n: int, seed: int = 11):
    """K2's adversarial inputs at n² (case, values, background, connectivity):
    one value everywhere; a serpentine of 1-px rows joined at alternate ends,
    crossing every tile; checkerboards at both connectivities; 1-px stripes;
    50 % binary noise with background 0 and None; int32 values at INT32_MIN
    and INT32_MAX with background INT32_MIN; planes 1, 31, 33, 63, 65 and
    129 px wide (and tall), a majority class spanning each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    yield f"single value [{n},{n}]", np.full((n, n), 3, np.uint8), None, 8
    serp = np.zeros((n, n), np.uint8)
    serp[::2] = 1
    serp[1::4, -1] = serp[3::4, 0] = 1
    for conn in (8, 4):
        yield f"serpentine [{n},{n}]", serp, 0, conn
        yield f"checkerboard [{n},{n}]", ((yy + xx) % 2).astype(np.uint8), None, conn
    yield f"2-px checkerboard [{n},{n}]", ((yy // 2 + xx // 2) % 2).astype(np.uint8), 0, 8
    yield f"1-px stripes across [{n},{n}]", (yy % 2).astype(np.uint8), None, 8
    yield f"1-px stripes down [{n},{n}]", (xx % 2).astype(np.uint8), 0, 4
    del yy, xx
    noise = (rng.random((2, n, n)) < 0.5).astype(np.uint8)
    for bg in (0, None):
        for conn in (8, 4):
            yield f"50 % binary noise [2,{n},{n}]", noise, bg, conn
    extremes = np.array([-(2**31), 2**31 - 1, -1, 0, 7], np.int64)
    ext = extremes[rng.choice(5, (2, n, n), p=[0.2, 0.4, 0.1, 0.2, 0.1])].astype(np.int32)
    for conn in (8, 4):
        yield f"int32 extremes [2,{n},{n}]", ext, -(2**31), conn
    for w in (1, 31, 33, 63, 65, 129):
        maj = np.where(rng.random((n, w)) < 0.7, 1, rng.integers(0, 3, (n, w))).astype(np.uint8)
        yield f"width {w} [{n},{w}]", maj, None, 8
        yield f"height {w} [{w},{n}]", np.ascontiguousarray(maj.T), 0, 4


def k3_raw(shape, seed: int, lo: int = -5, roots: float = 0.3):
    """K3 input that is not CCL output: int32 in [lo, H*W+5) with forward
    references, non-root targets and values past the plane; a share
    ``roots`` of pixels point at themselves."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = shape[-2] * shape[-1]
    raw = rng.integers(lo, n + 5, shape, dtype=np.int64)
    own = np.broadcast_to(np.arange(n).reshape(shape[-2:]), shape)
    return np.where(rng.random(shape) < roots, own, raw).astype(np.int32)


def k3_inputs(seed: int = 21):
    """K3's edge inputs (case, int32 raw, whether to pass the view x[1:]):
    random raw at several shapes, INT32_MIN/INT32_MAX, 1x1 planes, widths
    1-129, planes of H*W not a multiple of 4 or of the 4096-px tile (one of
    2049 x 2047, thousands of tiles deep), a view off a 16-byte boundary,
    and B = 64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yield "random [2,97,130]", k3_raw((2, 97, 130), seed), False
    ext = k3_raw((2, 64, 80), seed + 1)
    pick = rng.random(ext.shape)
    ext[pick < 0.2] = -(2**31)
    ext[(pick >= 0.2) & (pick < 0.4)] = 2**31 - 1
    yield "INT32_MIN and INT32_MAX [2,64,80]", ext, False
    yield "1x1 planes [64,1,1]", rng.integers(-2, 3, (64, 1, 1)).astype(np.int32), False
    for w in (1, 2, 3, 5, 31, 32, 33, 63, 64, 65, 127, 128, 129):
        yield f"width {w} [2,33,{w}]", k3_raw((2, 33, w), seed + w), False
    yield "H*W = 4095 [3,45,91]", k3_raw((3, 45, 91), seed + 2), False
    yield "H*W = 4097 [2,241,17]", k3_raw((2, 241, 17), seed + 3), False
    yield "H*W = 2049*2047 [2,2049,2047]", k3_raw((2, 2049, 2047), seed + 4, roots=0.05), False
    yield "view x[1:] of [5,33,65] (off 16 bytes)", k3_raw((5, 33, 65), seed + 5), True
    yield "B = 64 [64,17,19]", k3_raw((64, 17, 19), seed + 6), False


def k4_inputs(seed: int = 23):
    """K4's edge inputs (case, int32 ids, uint8 or int32 values, max_regions,
    whether to pass views off a 16-byte boundary): one id over a whole 2048²
    plane at 255 (the hot bin, the widest 32-bit run sums); every pixel its
    own id; ids negative and >= R+1; R+1 = 40000 (several id tiles); int32
    values at ±2^31 that saturate; uint8 planes of odd H*W; views off a
    16-byte boundary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yield ("one id at 255 [2048,2048]", np.ones((2048, 2048), np.int32),
           np.full((2048, 2048), 255, np.uint8), 16383, False)
    yield ("every pixel its own id [150,200]", np.arange(30000, dtype=np.int32).reshape(150, 200),
           rng.integers(0, 256, (150, 200)).astype(np.uint8), 30000, False)
    blocks = (np.arange(97)[:, None] // 5 * 40 + np.arange(131)[None, :] // 4).astype(np.int32)
    for vals in (rng.integers(0, 256, (3, 97, 131)).astype(np.uint8),
                 rng.integers(-(2**31), 2**31, (3, 97, 131), dtype=np.int64).astype(np.int32)):
        ids = np.where(rng.random((3, 97, 131)) < 0.1,
                       rng.integers(-5, 800, (3, 97, 131)), blocks[None] - 5).astype(np.int32)
        yield f"ids -5..799, R=700, {vals.dtype} values [3,97,131]", ids, vals, 700, False
    wide = rng.integers(0, 40010, (2, 256, 256)).astype(np.int32)
    yield ("R+1 = 40000 [2,256,256] uint8", wide,
           rng.integers(0, 256, wide.shape).astype(np.uint8), 39999, False)
    yield ("R+1 = 40000 [2,256,256] int32", wide,
           rng.integers(-1000, 1000, wide.shape).astype(np.int32), 39999, False)
    sat = np.zeros((2, 512, 512), np.int32)
    sat[:, :, 400:] = 1
    sat[:, 300:, :] = 2
    sv = np.full((2, 512, 512), 2**31 - 1, np.int32)
    sv[1] = -(2**31)
    sv[:, 300:, :] = rng.integers(-(2**31), 2**31, (2, 212, 512), dtype=np.int64)
    yield "int32 values at ±2^31, saturating [2,512,512]", sat, sv, 4, False
    odd_ids = np.broadcast_to(blocks[:, :129], (3, 97, 129)).copy()  # H*W = 12513, odd
    odd_ids[1] += 7
    yield ("uint8 odd H*W [3,97,129]", odd_ids,
           rng.integers(0, 256, odd_ids.shape).astype(np.uint8), 2000, False)
    yield ("views off 16 bytes [3,97,129] uint8", odd_ids,
           rng.integers(0, 256, odd_ids.shape).astype(np.uint8), 2000, True)
    yield ("views off 16 bytes [3,97,129] int32", odd_ids,
           rng.integers(-5000, 5000, odd_ids.shape).astype(np.int32), 2000, True)


def k5_inputs(seed: int = 29):
    """K5's edge inputs, in K4's form: ``k4_inputs`` (the hot bin at 2048²,
    an id a pixel, dropped ids, R+1 = 40000, saturating int32 sums, odd H*W,
    views off a 16-byte boundary), then runs that meet row and plane ends:
    widths 1-130 (W % 16 != 0 mostly) of one id over the whole plane, of
    row bands and of 4x3 blocks; B = 1 and B = 64; an id a pixel over a
    2048² plane (every block's table overflows); ids that all share their
    low 12 bits (long probe chains)."""
    import numpy as np

    yield from k4_inputs()
    rng = np.random.default_rng(seed)
    for w in (1, 2, 3, 5, 15, 16, 17, 31, 33, 63, 65, 127, 128, 129, 130):
        shape = (2, 37, w)
        yy, xx = np.mgrid[:37, :w]
        vals = rng.integers(0, 256, shape).astype(np.uint8)
        yield f"one id, width {w} [2,37,{w}]", np.full(shape, 3, np.int32), vals, 8, False
        bands = np.broadcast_to((yy // 5 + 1).astype(np.int32), shape).copy()
        bands[1, ::7] = 0
        yield f"row bands, width {w} [2,37,{w}]", bands, vals, 16, False
        blocks = np.ascontiguousarray(np.broadcast_to((yy // 4 * 40 + xx // 3).astype(np.int32), shape))
        yield (f"4x3 blocks, width {w} [2,37,{w}] int32", blocks,
               rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32), 500, False)
    one = (np.arange(97)[:, None] // 6 * 30 + np.arange(131)[None] // 9).astype(np.int32)[None]
    yield "B = 1 [1,97,131]", one, rng.integers(0, 256, one.shape).astype(np.uint8), 600, False
    many = rng.integers(-1, 40, (64, 17, 19)).astype(np.int32)
    many[::3] = 5
    yield "B = 64 [64,17,19]", many, rng.integers(0, 256, many.shape).astype(np.uint8), 30, False
    yield ("an id a pixel [1,2048,2048]", np.arange(2048 * 2048, dtype=np.int32).reshape(1, 2048, 2048),
           rng.integers(0, 256, (1, 2048, 2048)).astype(np.uint8), 2048 * 2048, False)
    chains = (4096 * rng.integers(0, 24, (2, 300, 301)) + 7).astype(np.int32)
    yield ("ids 4096 k + 7 [2,300,301]", chains,
           rng.integers(0, 256, chains.shape).astype(np.uint8), 4096 * 24, False)


def k8_inputs(max_cap: int, seed: int = 31):
    """K8's edge inputs (case, uint8 planes, (particle_val, sval, cap, dt2,
    dr2)) for both routes, the one-kernel route up to ``max_cap``: caps 0,
    1, 2, 20, 32 and 33 (the window's column halo grows by a word past 32),
    ``max_cap`` and ``max_cap + 1`` on sparse particles among dense cells;
    particle pixels at exactly cap and cap + 1 from a 64-row or 128-column
    tile edge, on either side; dt2 > (cap + 1)² (every cell
    fills) with and without particles; T = (cap + 1)² − 1; a plane with no
    cell pixel; odd shapes and B = 1."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def scatter(shape, p_particle, p_cell):
        u = rng.random(shape)
        return np.where(u < p_particle, 2, np.where(u < p_particle + p_cell, 1, 3)).astype(np.uint8)

    for cap in (0, 1, 2, 20, 32, 33, max_cap, max_cap + 1):
        big = cap > 64
        shape = (1, 700, 1400) if big else (2, 150, 300)
        x = scatter(shape, 2e-5 if big else 2e-3, 0.5)
        for dt2, dr2 in ((4, cap * cap), (0, (cap + 1) ** 2 - 1), ((cap + 1) ** 2 + 1, -1)):
            yield f"cap {cap} scattered {list(shape)}", x, (2, 1, cap, dt2, dr2)
        if not big:
            none = np.where(x == 2, 3, x)
            yield f"cap {cap} no particle {list(shape)}", none, (2, 1, cap, (cap + 1) ** 2 + 1, 0)
            yield f"cap {cap} no particle {list(shape)}", none, (2, 1, cap, 4, cap * cap)
    for cap in (1, 2, 20, 32):
        for at in (cap, cap + 1):  # distance from the tile edge
            x = np.ones((1, 200, 300), np.uint8)
            x[0, 63 + at, 10] = x[0, 64 - at, 200] = 2  # rows: below / above the 64-row edge
            x[0, 150, 127 + at] = x[0, 20, 128 - at] = 2  # columns: across the 128-column edge
            for dt2, dr2 in ((0, cap * cap), (0, (cap + 1) ** 2 - 1), (1, 0)):
                yield (f"particles {at} px from tile edges, cap {cap} [1,200,300]", x,
                       (2, 1, cap, dt2, dr2))
    x = scatter((3, 97, 130), 0.01, 0.0)
    yield "no cell pixel [3,97,130]", x, (2, 1, 20, 4, 400)
    yield "no cell pixel [3,97,130]", x, (2, 1, 20, 500, 400)
    for shape in ((1, 1, 1), (1, 65, 129), (1, 3, 250), (1, 250, 3), (3, 97, 130)):
        x = scatter(shape, 0.02, 0.5)
        for params in ((2, 1, 20, 4, 400), (2, 1, 5, 9, 4), (4, 2, 2, 4, 4), (1, 1, 3, 4, 9)):
            yield f"odd {list(shape)}", x, params


def k9_inputs(max_cap: int, seed: int = 37):
    """K9's edge inputs (case, bool or uint8 mask, cap, whether to pass a
    view off a 16-byte boundary) for both routes, the one-kernel route up to
    ``max_cap``: caps 0, 1, 2, 3, 8, 9, 31, 32 and 33 on sparse, dense,
    empty and full masks, odd [3,97,130] (W not a multiple of the 128-column
    tile, nor of 16); ``max_cap`` and ``max_cap + 1`` on sparse features over
    long rows (features further apart than a 32-column word); features at
    exactly cap and cap + 1 from a 128-row or 128-column tile edge, on either
    side; cap > H; uint8 masks with values past 1; 1-pixel and 1-row planes;
    a view off a 16-byte boundary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for cap in (0, 1, 2, 3, 8, 9, 31, 32, 33):
        yield f"sparse [2,150,300] cap {cap}", rng.random((2, 150, 300)) < 0.01, cap, False
        yield f"dense [2,150,300] cap {cap}", rng.random((2, 150, 300)) < 0.5, cap, False
        yield f"odd [3,97,130] cap {cap}", rng.random((3, 97, 130)) < 0.02, cap, False
        ef = np.zeros((2, 70, 260), bool)
        ef[1] = True
        yield f"empty and full [2,70,260] cap {cap}", ef, cap, False
    for cap in (max_cap, max_cap + 1):
        yield (f"sparse long rows [2,400,1500] cap {cap}", rng.random((2, 400, 1500)) < 2e-5,
               cap, False)
        yield f"odd [3,97,130] cap {cap}", rng.random((3, 97, 130)) < 0.002, cap, False
    for cap in (1, 2, 31, 32, 33, 40):
        for at in (cap, cap + 1):  # distance from the tile edge
            x = np.zeros((1, 300, 300), bool)
            x[0, 127 + at, 10] = x[0, 128 - at, 200] = True  # rows: across the 128-row edge
            x[0, 250, 127 + at] = x[0, 20, 128 - at] = True  # columns: across the 128-column edge
            yield f"features {at} px from tile edges [1,300,300] cap {cap}", x, cap, False
    short = rng.random((3, 20, 130)) < 0.02
    for cap in (32, 40):
        yield f"cap {cap} > H [3,20,130]", short, cap, False
    u8 = rng.integers(0, 4, (2, 64, 160)).astype(np.uint8) * (rng.random((2, 64, 160)) < 0.05)
    yield "uint8 values 0-3 [2,64,160] cap 5", u8, 5, False
    for shape in ((1, 1, 1), (1, 1, 300), (1, 300, 1), (1, 3, 5)):
        yield f"{list(shape)} cap 2", rng.random(shape) < 0.3, 2, False
    yield "a view off 16 bytes [2,128,256] cap 32", rng.random((2, 128, 256)) < 0.01, 32, True


def k7_inputs(seed: int = 41):
    """K7's edge inputs (case, int32 ids, max_regions, whether to pass a
    view off a 16-byte boundary): one id over a whole 2048² plane (the hot
    bin); W % 16 != 0 and H*W % 16 != 0 (runs crossing rows and planes);
    ids -3..4999 past R; a 2-D plane; R+1 = 4096 and 4097 with ids sharing
    their low 12 bits (the shared table's slots); R+1 = 30001; an id a pixel
    over 2048² (every block's shared table overflows); B = 64; a view off a
    16-byte boundary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yield "one id [1,2048,2048]", np.zeros((1, 2048, 2048), np.int32), 4095, False
    yield "one id 7 [2048,2048] (2-D)", np.full((2048, 2048), 7, np.int32), 4095, False
    blocks = (np.arange(97)[:, None] // 5 * 40 + np.arange(129)[None, :] // 4).astype(np.int32)
    yield "4x5 blocks [3,97,129] (W % 16, H*W % 16 != 0)", np.stack([blocks] * 3), 4095, False
    for w in (1, 3, 15, 17, 33, 130):
        yy = np.broadcast_to(np.arange(37)[:, None] // 5, (37, w))
        yield f"row bands width {w} [2,37,{w}]", np.stack([yy, yy + 1]).astype(np.int32), 30, False
    yield ("ids -3..4999 [3,97,130]", rng.integers(-3, 5000, (3, 97, 130)).astype(np.int32),
           4095, False)
    yield ("2-D [301,777] blocks", (np.arange(301)[:, None] // 9 * 90 + np.arange(777)[None] // 9)
           .astype(np.int32), 4095, False)
    collide = (4096 * rng.integers(0, 2, (2, 300, 301)) + rng.integers(0, 40, (2, 300, 301)))
    for mr in (4095, 4096):
        yield f"ids k * 4096 + 0..39 [2,300,301] R+1 = {mr + 1}", collide.astype(np.int32), mr, False
    yield ("R+1 = 30001 [2,512,512]", rng.integers(0, 40000, (2, 512, 512)).astype(np.int32),
           30000, False)
    yield ("an id a pixel [1,2048,2048]", np.arange(2048 * 2048, dtype=np.int32)
           .reshape(1, 2048, 2048), 2048 * 2048 - 1, False)
    many = rng.integers(-1, 40, (64, 17, 19)).astype(np.int32)
    many[::3] = 5
    yield "B = 64 [64,17,19]", many, 30, False
    yield "view off 16 bytes [3,97,129]", np.stack([blocks] * 3) - 3, 4095, True


def k6_inputs(seed: int = 43):
    """K6's edge inputs (case, int32 ids, int32 table, whether to pass views
    off a 16-byte boundary): ids -2..R+1 with INT32_MIN and INT32_MAX among
    them and table values INT32_MIN and INT32_MAX, at R = 1, 2, 16385 and
    40000 (past the kernel's 32768-entry shared-memory table) with an [R] and a
    [B, R] table; H*W not a multiple of 4 at widths 1-9; B = 64 with a
    [B, R] table; views of ids and table off a 16-byte boundary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = -(2**31), 2**31 - 1

    def ids(shape, R):
        x = rng.integers(-2, R + 2, shape)
        pick = rng.random(shape)
        x[pick < 0.05] = lo
        x[pick > 0.95] = hi
        return x.astype(np.int32)

    def tab(shape):
        t = rng.integers(lo, hi, shape, dtype=np.int64, endpoint=True).astype(np.int32)
        t[..., 0], t[..., -1] = lo, hi
        return t

    for R in (1, 2, 16385, 40000):
        x = ids((2, 97, 131), R)
        yield f"R = {R} [2,97,131], table [{R}]", x, tab((R,)), False
        yield f"R = {R} [2,97,131], table [2,{R}]", x, tab((2, R)), False
    for w in range(1, 10):
        for h in (1, 3, 7):
            yield f"H*W = {h * w} [3,{h},{w}], table [3,50]", ids((3, h, w), 50), tab((3, 50)), False
        yield f"2-D [5,{w}], table [50]", ids((5, w), 50), tab((50,)), False
    yield "B = 64 [64,17,19], table [64,300]", ids((64, 17, 19), 300), tab((64, 300)), False
    yield "B = 64 [64,1,3], table [64,7]", ids((64, 1, 3), 7), tab((64, 7)), False
    x = ids((3, 97, 129), 600)
    yield "views off 16 bytes [3,97,129], table [600]", x, tab((600,)), True
    yield "views off 16 bytes [3,97,129], table [3,600]", x, tab((3, 600)), True
    yield "views off 16 bytes 2-D [1,1], table [1]", ids((1, 1), 1), tab((1,)), True


def add_discs(plane, rng, discs: int) -> None:
    """The bench's bright particles (bench.py config #1 and #2), in place on
    a uint16 plane: ``discs`` discs of +20000, centres in [20, n − 20), r² in
    [30, 200), the same draws as the bench's full-plane masks, each drawn in
    its own window."""
    import numpy as np

    n = plane.shape[-1]
    for _ in range(discs):
        cy, cx = rng.integers(20, n - 20, 2)
        r2 = int(rng.integers(30, 200))
        window = np.s_[cy - 15:cy + 16, cx - 15:cx + 16]  # r < 15, inside the plane
        yy, xx = np.mgrid[window]
        plane[window][(yy - cy) ** 2 + (xx - cx) ** 2 <= r2] += 20000


def config1_plane(n: int = 512, seed: int = 1, discs: int = 40):
    """Config #1's 16-bit plane (bench.py's bench_config1 at n²): uniform
    noise below 400 and ``discs`` bright particles."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = (rng.random((n, n)) * 400).astype(np.uint16)
    add_discs(img, rng, discs)
    return img


def config2_stacks(stacks: int, n: int = 512, discs: int = 30, planes: int = 24,
                   seed: int = 2) -> list:
    """Config #2's z-stacks (bench.py's bench_config2 at n², uint16
    [planes, n, n] each, drawn in sequence from one generator): noise below
    400 on every plane, then ``discs`` bright particles a plane (30 at 512²,
    480 at 2048²: the same density)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(stacks):
        stack = (rng.random((planes, n, n)) * 400).astype(np.uint16)
        for p in range(planes):
            add_discs(stack[p], rng, discs)
        out.append(stack)
    return out


# phase 10's cells (name, stacks, n, discs a plane): bench.py's four
# [24,512²] stacks, and two at the pipeline's plane size with the same
# density of particles; each measured ZSTACK_REPS times
ZSTACK_CELLS = (("[24,512,512]", 4, 512, 30), (f"[24,{H},{W}]", 2, H, 480))
ZSTACK_REPS = 3


def config2_stack(planes: int = 24, n: int = 512, discs: int = 30, seed: int = 2):
    """Config #2's first z-stack (``config2_stacks``' first)."""
    return config2_stacks(1, n, discs, planes, seed)[0]


def stack_stats(x):
    """Config #2's compute (bench.py's stack_stats): the Gaussian blur at
    σ 1, then ``threshold_and_count_batch`` at max_regions 4095.  Returns
    the blurred stack and the six outputs."""
    from particle_col_image_segmentation_tpu_torch.ops import (
        gaussian_blur,
        threshold_and_count_batch,
    )

    den = gaussian_blur(x, 1.0)
    return den, threshold_and_count_batch(den, max_regions=TH_REGIONS)


def hist_inputs(seed: int = 47):
    """K4's inputs as the Otsu histogram (case, float32 [B, H, W] stack):
    config #1's [4,128,128] batch rolled by 7·b columns, a constant plane
    (span 1e-12, every pixel in bin 0), 1x1 planes, planes where every bin
    is hit, normal noise with a bright half, and a plane whose maximum sits
    alone in bin 255."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c1 = config1_plane(128, discs=10)
    yield "config-1 [4,128,128] rolled 7·b", np.stack([np.roll(c1, 7 * b, axis=1)
                                                       for b in range(4)]).astype(np.float32)
    yield "constant [1,64,64]", np.full((1, 64, 64), 3.0, np.float32)
    yield "1x1 planes [3,1,1]", np.array([7, 0, 65535], np.float32).reshape(3, 1, 1)
    ramp = (np.arange(64 * 128) % 256).astype(np.float32).reshape(64, 128)
    yield "every bin hit [2,64,128]", np.stack([ramp, ramp[::-1, ::-1] * 3.5 - 100])
    noise = rng.normal(900.0, 200.0, (2, 97, 131)).astype(np.float32)
    noise[1, :48] += 4000.0
    yield "normal, a bright half [2,97,131]", noise
    lone = rng.random((1, 50, 70)).astype(np.float32)
    lone[0, 7, 9] = 1e6
    yield "one bright pixel [1,50,70]", lone


def plain_otsu(x):
    """Per-plane Otsu thresholds of a float32 [B, H, W] stack through the
    plain histogram (one ``bincount``) on x's device."""
    from particle_col_image_segmentation_tpu_torch.ops.threshold import (
        _bin_index,
        _bincount,
        _centers,
        _otsu_from_hist,
        _value_range,
    )

    lo, span = _value_range(x)
    return _otsu_from_hist(_bincount(_bin_index(x, lo, span, 256), 256),
                           _centers(lo[..., 0], span[..., 0], 256))


def plain_threshold_batch(x, max_regions: int, min_area: int = 1):
    """``threshold_and_count_batch`` through the plain versions on x's
    device (float32 [B, H, W]): (thresholds, its six outputs)."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import (
        compact_labels,
        connected_components,
        region_counts,
    )

    t = plain_otsu(x)
    mask = x > t[:, None, None]
    m8 = mask.to(torch.uint8)
    raw, conv = connected_components(m8, background=None, num_classes=2, with_flag=True)
    seg, num_total = compact_labels(raw, max_regions)
    areas, classes = region_counts(seg, m8, max_regions)
    fg = (classes == 1) & (areas > 0)
    count = (fg & (areas >= min_area)).sum(dim=-1, dtype=torch.int32)
    return t, (mask, seg, count, fg.sum(dim=-1, dtype=torch.int32), num_total, conv)


def plain_threshold(img, max_regions: int, min_area: int = 1):
    """``threshold_and_count`` through the plain versions on img's device:
    (threshold, the plain CCL's converged flag, its four outputs)."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import (
        compact_labels,
        connected_components,
        region_counts,
    )
    from particle_col_image_segmentation_tpu_torch.ops.filters import as_float32

    x = as_float32(img)
    t = plain_otsu(x[None])[0]
    mask = x > t
    raw, conv = connected_components(mask.to(torch.uint8), background=0, num_classes=2,
                                     with_flag=True)
    seg, num = compact_labels(raw, max_regions)
    area, _ = region_counts(seg, mask.to(torch.int32), max_regions)
    return t, conv, (mask, seg, (area[1:] >= min_area).sum(dtype=torch.int32), num)


def off16(x):
    """A contiguous copy of card tensor x whose data starts 4 bytes past a
    16-byte boundary (the slice [1:] of a flat buffer)."""
    import torch

    step = 4 // x.element_size()
    buf = torch.empty(x.numel() + step, dtype=x.dtype, device=x.device)
    view = buf[step:].view(x.shape)
    view.copy_(x)
    return view


def refine_relief(n: int = H, pairs: int = 480, seed: int = 0):
    """The bench's touching-cell relief (bench.py config #3) at n², the same
    draws: ``pairs`` touching disc pairs with centres in [40, n−40), r² in
    [150, 400), prob = 1 − edt/max.  Each pair is drawn in its own window,
    which gives the full-plane masks at a fraction of the time."""
    import numpy as np
    from scipy import ndimage as ndi

    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), bool)
    for _ in range(pairs):
        cy, cx = rng.integers(40, n - 40, 2)
        r2 = int(rng.integers(150, 400))
        dx2 = int(1.5 * np.sqrt(r2))
        r = int(np.ceil(np.sqrt(r2)))
        y0, y1, x0, x1 = max(cy - r, 0), min(cy + r + 1, n), max(cx - r, 0), min(cx + dx2 + r + 1, n)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        m[y0:y1, x0:x1] |= (((yy - cy) ** 2 + (xx - cx) ** 2 <= r2)
                            | ((yy - cy) ** 2 + (xx - cx - dx2) ** 2 <= r2))
    dist = ndi.distance_transform_edt(m)
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def ws_corridor(h: int = 128, w: int = 192, pitch: int = 4, seed: int = 12):
    """A serpentine corridor for the watershed, (img, markers, mask) as numpy
    [h, w]: 1-px rows every ``pitch`` rows joined at alternate ends, on a
    random relief, a seed at each end.  The flood crosses every 32-px tile
    row 32 / pitch times, so a tile goes quiet and wakes again, and each
    phase needs many passes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = np.zeros((h, w), bool)
    rows = list(range(1, h - pitch, pitch))
    for i, r in enumerate(rows):
        mask[r, 1:w - 1] = True
        if i + 1 < len(rows):
            c = w - 2 if i % 2 == 0 else 1
            mask[r:r + pitch + 1, c] = True
    mk = np.zeros((h, w), np.int32)
    mk[rows[0], 1] = 1
    mk[rows[-1], w - 2 if (len(rows) - 1) % 2 == 0 else 1] = 2
    return rng.random((h, w)).astype(np.float32), mk, mask


def ws_mixed(h: int = 128, w: int = 192, seed: int = 13):
    """[2, h, w] planes whose phases need very different pass counts: plane 0
    a random relief seeded every 16 px (a few passes), plane 1
    ``ws_corridor`` (many).  Returns (img, markers, mask) as numpy."""
    import numpy as np

    img0 = np.random.default_rng(seed).random((h, w)).astype(np.float32)
    mk0 = np.zeros((h, w), np.int32)
    ys, xs = np.meshgrid(np.arange(8, h, 16), np.arange(8, w, 16), indexing="ij")
    mk0[ys, xs] = np.arange(1, ys.size + 1).reshape(ys.shape)
    img1, mk1, mask1 = ws_corridor(h, w)
    return (np.stack([img0, img1]), np.stack([mk0, mk1]),
            np.stack([np.ones((h, w), bool), mask1]))


def ws_budgets(img, mk, m, conn: int, want):
    """The watershed kernels under budgets of 1, 2, need − 1 and need passes
    a phase (need: the larger phase's passes without a budget), held to the
    loop's rules: no phase counts more passes than its budget, a phase that
    reports a plane still changing used its whole budget, every plane that
    reports converged has ``want``'s labels, and one pass converges no
    plane.  Returns [(budget, (passes), [converged])]."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import watershed_cuda

    watershed_cuda(img, mk, m, connectivity=conn)
    need = max(watershed_cuda.last_passes)
    out = []
    for budget in sorted({1, 2, max(1, need - 1), need}):
        got, conv = watershed_cuda(img, mk, m, connectivity=conn, max_iters=budget,
                                   with_flag=True)
        logs = watershed_cuda.last_logs
        torch.cuda.synchronize()
        for log in logs:
            if log.passes > budget or log.launches > budget:
                raise AssertionError(f"budget {budget}: a phase ran {log}")
        if not bool(conv.all()) and max(log.passes for log in logs) != budget:
            raise AssertionError(f"budget {budget}: a plane stopped early: {logs}")
        for z in conv.nonzero().flatten().tolist():
            if not torch.equal(got[z], want[z]):
                raise AssertionError(f"budget {budget}: plane {z} reports converged "
                                     "with labels that differ from plain")
        if budget == 1 and bool(conv.any()):
            raise AssertionError("a one-pass budget reported a converged plane")
        out.append((budget, watershed_cuda.last_passes, conv.tolist()))
    return out


def plain_refine(x, cfg):
    """refine_plane_device through the plain versions on x's device: (labels,
    num, CentroidTable, per-plane converged).  ``cfg.tunnel_basins`` floods
    with the tunnelled phase 2."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import (
        centroid_sums, compact_labels, connected_components, edt_sq, edt_sq_exact,
        local_maxima, watershed)

    bm = x < cfg.boundary_threshold
    cap = cfg.edt_probe_cap
    dsq = edt_sq(~bm, cap)
    if bool((dsq > cap * cap).any()):
        dsq = edt_sq_exact(~bm)
    maxima, conv_max = local_maxima(dsq, with_flag=True)
    raw, conv_ccl = connected_components(maxima.to(torch.uint8), background=0,
                                         num_classes=2, with_flag=True)
    markers, num = compact_labels(raw, REFINE_REGIONS)
    labels, conv_ws = watershed(x, markers, bm, with_flag=True, max_iters=cfg.watershed_max_iters,
                                tunnel_basins=cfg.tunnel_basins)
    return labels, num, centroid_sums(labels, REFINE_REGIONS), conv_max & conv_ccl & conv_ws


def make_tree(root: str, singles) -> dict:
    """A folder tree of empty placeholder .h5 files (discovery reads names
    only): one single-file 3D05 folder per index in ``singles``, and one
    3D05+6B07 folder with an RFP and a DAPI file.  Returns {path: index of
    the bench plane a load_fn gives for it}."""
    seed_of = {}
    for i in singles:
        folder = os.path.join(root, "exp", "24h", f"Tp_3D05_{i}_24h_60X")
        seed_of[os.path.join(folder, f"Tp_3D05_{i}_24h_60X_labels.h5")] = i
    folder = os.path.join(root, "3D05_6B07", "24h", "Tp_1_24h_60X")
    for j, ch in enumerate(("RFP", "DAPI")):
        seed_of[os.path.join(folder, f"Tp_1_24h_60X_{ch}_labels.h5")] = 8 + j
    for path in seed_of:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
    return seed_of


def csv_lines(root: str) -> dict:
    """{path relative to root: its lines as bytes} of every CSV under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".csv"):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read().splitlines()
    return out


def device_intervals(prof) -> list:
    """(start, end) µs of every device activity (kernels, copies, fills) in
    a torch.profiler trace, with its name: [(start, end, name), ...].  The
    ``record_function`` ranges the profiler mirrors onto the device's
    timeline (user annotations, such as the ``stage`` spans) are left out:
    they reach from a range's first launch to its last, host work between
    included."""
    import torch

    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_us(intervals) -> float:
    """Length of the union of the intervals: time the device was doing
    something."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_phase(planes, cfg, dev, card: str) -> None:
    """``--profile``: where the analyze path's time goes.

    (a) torch.profiler over three ``analyze_planes_device`` calls on a
        device-resident [8,2048,2048] batch: device ms per call of each
        kernel;
    (b) ``run_analysis`` over 16 single-file folders and the RFP+DAPI folder,
        batch_planes 1, 8, 8, 1: wall time and the ``stage`` totals;
    (c) one more batch_planes=8 run under torch.profiler: the union of the
        device's activity against the run's wall time, so the idle share
        comes from the trace."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from particle_col_image_segmentation_tpu_torch.labels.analysis import analyze_planes_device
    from particle_col_image_segmentation_tpu_torch.models.experiment import run_analysis
    from particle_col_image_segmentation_tpu_torch.utils import profiling

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x8 = torch.from_numpy(np.stack(planes[:8])).to(dev)
    analyze_planes_device(x8, SINGLE, cfg)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(3):
            analyze_planes_device(x8, SINGLE, cfg)
        torch.cuda.synchronize()
    per_name = {}
    for s, e, name in device_intervals(prof):
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 3e3
    if not per_name:
        raise AssertionError("phase 7: the trace holds no device activity")
    total = sum(per_name.values())
    log(f"phase 7 profile [{card}]: analyze_planes_device [8,{H},{W}], "
        f"{total:.3f} ms of device time a call (torch.profiler, 3 calls)")
    for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:14]:
        log(f"phase 7 profile:   {t:8.3f} ms {100 * t / total:5.1f} %  {name[:90]}")
    del x8

    def analyze_tree(batch_planes: int, traced: bool = False):
        with tempfile.TemporaryDirectory(prefix="pcis_profile_") as tmp:
            seed_of = make_tree(tmp, range(16))
            profiling.STAGE_TOTALS.clear()
            with profile(activities=acts) if traced else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                run_analysis(tmp, cfg, make_figures=False, device=dev,
                             batch_planes=batch_planes, load_fn=lambda p: planes[seed_of[p]])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        return wall, dict(profiling.STAGE_TOTALS), prof

    for bp in (1, 8, 8, 1):
        wall, stages, _ = analyze_tree(bp)
        log(f"phase 7 profile [{card}]: run_analysis, 18 planes, batch_planes={bp}: "
            f"{wall:.3f} s wall; stages (s) "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items())))
    wall, _, prof = analyze_tree(8, traced=True)
    intervals = device_intervals(prof)
    busy = busy_us(intervals) / 1e6
    per_name = {}
    for s, e, name in intervals:
        t, n = per_name.get(name, (0.0, 0))
        per_name[name] = (t + (e - s) / 1e6, n + 1)
    log(f"phase 7 profile [{card}]: run_analysis, batch_planes=8, under torch.profiler: "
        f"device busy {busy:.3f} s of {wall:.3f} s wall, idle {100 * (1 - busy / wall):.1f} %; "
        f"{len(intervals)} device activities, the longest in sum:")
    for name, (t, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"phase 7 profile:   {t:8.4f} s {n:6d}x  {name[:90]}")


def idle_within(intervals, start: float, end: float) -> float:
    """µs of [start, end] in which the device ran none of the intervals."""
    clipped = [(max(s, start), min(e, end), n) for s, e, n in intervals if e > start and s < end]
    return (end - start) - busy_us(clipped)


def profile_refine(x, rcfg, card: str) -> None:
    """``--profile``: torch.profiler over three ``refine_plane_device`` calls
    on the device-resident relief x: device ms per call of each kernel, the
    device's busy share of the calls' wall time, and where the idle time
    falls: inside each watershed phase's host call (``minimax_costs_cuda``,
    ``claim_labels_cuda``, spanned by a ``record_function`` for the trace
    only) — and of that, between its first pass's start and its last
    pass's end — or elsewhere (the EDT certificate, K2, K3, K7 and the
    glue)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from particle_col_image_segmentation_tpu_torch.models.refine import refine_plane_device
    from particle_col_image_segmentation_tpu_torch.ops import watershed_tiles

    spans = {"minimax_costs_cuda": "cost_pass", "claim_labels_cuda": "label_pass"}
    originals = {fn: getattr(watershed_tiles, fn) for fn in spans}

    def spanned(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    refine_plane_device(x, rcfg, REFINE_REGIONS)
    torch.cuda.synchronize()
    for fn in spans:
        setattr(watershed_tiles, fn, spanned(fn, originals[fn]))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                refine_plane_device(x, rcfg, REFINE_REGIONS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for fn, orig in originals.items():
            setattr(watershed_tiles, fn, orig)
    intervals = device_intervals(prof)
    if not intervals:
        raise AssertionError("phase 7: the refine trace holds no device activity")
    per_name = {}
    for s, e, name in intervals:
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 3e3
    total = sum(per_name.values())
    busy = busy_us(intervals) / 1e6
    log(f"phase 7 profile [{card}]: refine_plane_device {list(x.shape)}, {total:.3f} ms of "
        f"device time a call; device busy {busy:.4f} s of {wall:.4f} s wall "
        f"(idle {100 * (1 - busy / wall):.1f} %) over 3 calls")
    for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:14]:
        log(f"phase 7 profile:   {t:8.3f} ms {100 * t / total:5.1f} %  {name[:90]}")
    idle_ms = (wall - busy) * 1e3 / 3
    inside = 0.0
    for fn, kernel in spans.items():
        windows = [(e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == fn and e.device_type == DeviceType.CPU]
        if len(windows) != 3:
            raise AssertionError(f"phase 7: {len(windows)} {fn} spans in the refine trace")
        span_ms = idle_ms_a = loop_ms = before = between = after = 0.0
        for a, b in windows:
            passes = [(s, e) for s, e, n in intervals if kernel in n and a <= s < b]
            first, last = min(s for s, _ in passes), max(e for _, e in passes)
            span_ms += (b - a) / 3e3
            idle_ms_a += idle_within(intervals, a, b) / 3e3
            loop_ms += (last - first) / 3e3
            before += idle_within(intervals, a, first) / 3e3
            between += idle_within(intervals, first, last) / 3e3
            after += idle_within(intervals, last, b) / 3e3
        inside += idle_ms_a
        log(f"phase 7 profile [{card}]: refine idle inside {fn}: {idle_ms_a:.3f} ms of its "
            f"{span_ms:.3f} ms host call, a call: {before:.3f} before its first pass starts, "
            f"{between:.3f} between its first pass's start and its last pass's end "
            f"({loop_ms:.3f} ms), {after:.3f} after its last pass ends (read-back, return)")
    log(f"phase 7 profile [{card}]: refine idle {idle_ms:.3f} ms a call: "
        f"{inside:.3f} inside the two watershed phases' host calls, "
        f"{idle_ms - inside:.3f} elsewhere (EDT certificate, K2, K3, K7, glue, "
        f"the calls' own host work)")


K2_PHASES = (("local", ("ccl_local",)), ("merge", ("ccl_merge",)),
             ("flatten", ("ccl_roots", "ccl_flatten")))
K3_PHASES = (("bits", ("compact_bits",)), ("scan", ("scan_tiles",)),
             ("ranks", ("compact_ranks",)))


def traced_calls(fn, reps: int) -> list:
    """``device_intervals`` of reps fn() calls under torch.profiler, after
    one untraced call.  The profiler now and then hands back a short
    window's trace with no device activity at all; such a trace is taken
    again, three times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        intervals = device_intervals(prof)
        if intervals:
            break
    return intervals


def kernel_split(fn, phases, reps: int = 5) -> dict:
    """Device ms a call of each phase of a kernel (torch.profiler over reps
    calls of fn): phases are (name, substrings of its CUDA kernels' names),
    K2_PHASES — local (ccl_local), merge (ccl_merge_rows, ccl_merge_cols)
    and flatten (ccl_roots, ccl_flatten) — or K3_PHASES — bits
    (compact_bits), scan (scan_tiles) and ranks (compact_ranks)."""
    split = {phase: 0.0 for phase, _ in phases}
    for s, e, name in traced_calls(fn, reps):
        for phase, kernels in phases:
            if any(k in name for k in kernels):
                split[phase] += (e - s) / (1e3 * reps)
    if not all(split.values()):
        raise AssertionError(f"phase 5: the trace lacks a phase: {split}")
    return split


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 5) -> float:
    """Device time of one fn() call: the union of its device activity under
    torch.profiler over reps calls (memsets included), without the host's
    launch gaps that CUDA events around a fast call also hold."""
    intervals = traced_calls(fn, reps)
    if not intervals:
        raise AssertionError("the trace holds no device activity")
    return busy_us(intervals) / reps / 1e3


def threshold_times(card: str, x1, x1b, x2, x2k) -> dict:
    """Phase 5's threshold path (configs #1 and #2) on the card: each call
    through the kernels (CUDA events, and device time a call by
    torch.profiler) and through the plain versions; config #2 at
    [24,2048,2048] step by step (blur, min/max, bin ids, the K4 histogram,
    the Otsu reduction, the mask, K2, K3, K4 counts; device time a call of
    each on the previous step's output) against the whole call; K4's
    histogram launch beside one ``torch.bincount`` of the offset ids, and K2
    on the binary mask.  Returns K4's and K2's entries for the record's
    ``more_shapes``."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        compact_labels_cuda,
        connected_components,
        gaussian_blur,
        region_counts_cuda,
        threshold_and_count,
        threshold_and_count_batch,
    )
    from particle_col_image_segmentation_tpu_torch.ops.filters import as_float32
    from particle_col_image_segmentation_tpu_torch.ops.threshold import (
        _bin_counts,
        _bin_index,
        _bincount,
        _centers,
        _otsu_from_hist,
        _value_range,
    )

    dev, B2 = x1.device, x2k.shape[0]
    big = f"[{B2},{x2k.shape[1]},{x2k.shape[2]}]"

    def plain_stack_stats(x):
        den = gaussian_blur(x, 1.0)
        return den, plain_threshold_batch(den, TH_REGIONS)

    def traced(fn, reps: int = 5):
        """(device ms, device activities) a call, by torch.profiler."""
        intervals = traced_calls(fn, reps)
        if not intervals:
            raise AssertionError("the trace holds no device activity")
        return busy_us(intervals) / reps / 1e3, len(intervals) / reps

    th_times = {}
    for name, fn, plain_fn, px in (
            (f"config #1 threshold_and_count {list(x1.shape)}",
             lambda: threshold_and_count(x1, max_regions=TH_REGIONS),
             lambda: plain_threshold(x1, TH_REGIONS), x1.numel()),
            (f"config #1 threshold_and_count_batch {list(x1b.shape)}",
             lambda: threshold_and_count_batch(x1b, max_regions=TH_REGIONS),
             lambda: plain_threshold_batch(as_float32(x1b), TH_REGIONS), x1b.numel()),
            (f"config #2 stack_stats {list(x2.shape)}", lambda: stack_stats(x2),
             lambda: plain_stack_stats(x2), x2.numel()),
            (f"config #2 stack_stats {big}", lambda: stack_stats(x2k),
             lambda: plain_stack_stats(x2k), x2k.numel())):
        th_times[name] = (time_ms(fn, reps=10), *traced(fn), time_ms(plain_fn, reps=1))
        ev, dv, acts, pl = th_times[name]
        log(f"phase 5 times [{card}]: {name}: kernels {ev:.4f} ms by CUDA events "
            f"({px / ev / 1e3:.1f} MP/s), device {dv:.4f} ms in {acts:.0f} device "
            f"activities a call; plain {pl:.3f} ms")
    # config #2 at its large shape step by step, each step's device time a
    # call on the previous step's output
    den2k = gaussian_blur(x2k, 1.0)
    lo, span = _value_range(den2k)
    idx2k = _bin_index(den2k, lo, span, 256)
    counts2k = _bin_counts(idx2k, 256)
    centers2k = _centers(lo[..., 0], span[..., 0], 256)
    t2k = _otsu_from_hist(counts2k, centers2k)
    m8_2k = (den2k > t2k[:, None, None]).to(torch.uint8)
    raw2k = ccl_cuda(m8_2k)
    seg2k, _ = compact_labels_cuda(raw2k, TH_REGIONS)
    steps = {
        "blur": lambda: gaussian_blur(x2k, 1.0),
        "min/max": lambda: _value_range(den2k),
        "bin ids": lambda: _bin_index(den2k, lo, span, 256),
        "K4 histogram (zeros + K4)": lambda: _bin_counts(idx2k, 256),
        "Otsu reduction": lambda: (_centers(lo[..., 0], span[..., 0], 256),
                                   _otsu_from_hist(counts2k, centers2k)),
        "mask": lambda: (den2k > t2k[:, None, None]).to(torch.uint8),
        "K2": lambda: ccl_cuda(m8_2k),
        "K3": lambda: compact_labels_cuda(raw2k, TH_REGIONS),
        "K4 counts": lambda: region_counts_cuda(seg2k, m8_2k, TH_REGIONS),
    }
    th_split = {k: traced(fn) for k, fn in steps.items()}
    whole = th_times[f"config #2 stack_stats {big}"][1]
    log(f"phase 5 times [{card}]: config #2 stack_stats {big} by step, device ms a "
        f"call (device activities): " + ", ".join(f"{k} {v:.4f} ({n:.0f})"
                                                  for k, (v, n) in th_split.items())
        + f"; sum {sum(v for v, _ in th_split.values()):.4f} against {whole:.4f} for the "
        f"whole call (blur {100 * th_split['blur'][0] / whole:.1f} %)")
    # K4's histogram launch beside one torch.bincount of the offset ids
    # b * 256 + idx (its library yardstick at this shape), and K2 on the
    # binary mask
    zeros2k = torch.zeros(idx2k.shape, dtype=torch.uint8, device=dev)
    offs = (idx2k.to(torch.int64)
            + 256 * torch.arange(B2, device=dev).view(-1, 1, 1)).reshape(-1)
    if not torch.equal(torch.bincount(offs, minlength=B2 * 256).view(B2, 256).to(torch.int32),
                       region_counts_cuda(idx2k, zeros2k, 255)[0]):
        raise AssertionError("phase 5: torch.bincount's histogram differs from K4's")
    k4h = (lambda: region_counts_cuda(idx2k, zeros2k, 255))
    k2m = (lambda: ccl_cuda(m8_2k))
    # the histogram's own bytes: an int32 bin id a pixel in, an int32 count a
    # bin out (the uint8 zeros and the class table come of reusing K4)
    hist_px, hist_bins = x2k.numel(), B2 * 256
    more_shapes = {
        "K4": {"shape": f"Otsu histogram {big} R+1=256, uint8 zeros",
               "ms": time_ms(k4h, reps=10), "device_ms": device_ms(k4h),
               "plain_ms": time_ms(lambda: _bincount(idx2k, 256), reps=3),
               "bound_ms": (4 * hist_px + 4 * hist_bins) / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": time_ms(lambda: torch.bincount(offs, minlength=hist_bins), reps=10)},
        "K2": {"shape": f"binary mask {big} uint8, background=None",
               "ms": time_ms(k2m, reps=10), "device_ms": device_ms(k2m),
               "plain_ms": time_ms(lambda: connected_components(m8_2k, num_classes=2), reps=1),
               "bound_ms": 5 * hist_px / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "library_ms": None},
    }
    for k in ("K4", "K2"):
        m = more_shapes[k]
        lib = f", one torch.bincount {m['library_ms']:.4f} ms" if m["library_ms"] else ""
        log(f"phase 5 times [{card}]: {k} {m['shape']}: {m['ms']:.4f} ms by CUDA events, "
            f"device {m['device_ms']:.4f}, bound {m['bound_ms']:.4f}; plain "
            f"{m['plain_ms']:.3f} ms{lib}")
    return more_shapes


def threshold_phase(card: str, c1, x1, x1b, x2, x2k, reset_counts, read_counts) -> dict:
    """Phase 9: the threshold path on the card, through the entry points
    (config #1's plane c1 = x1 through ``threshold_and_count``, its
    [16,512,512] batch x1b through ``threshold_and_count_batch``, config
    #2's stacks x2 and x2k through ``stack_stats``).  Launch counts are
    reset just before and read just after; every output is then held to
    the plain versions on the card and to scipy's component counts, and the
    batch to the plain CPU run.  Returns the launch counts."""
    import numpy as np
    import torch
    from scipy import ndimage as ndi

    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        gaussian_blur,
        histogram,
        otsu_threshold,
        otsu_threshold_batch,
        region_counts_cuda,
        threshold_and_count,
        threshold_and_count_batch,
    )
    from particle_col_image_segmentation_tpu_torch.ops.filters import as_float32

    reset_counts()
    t0 = time.perf_counter()
    single = threshold_and_count(x1, max_regions=TH_REGIONS)
    batch1 = threshold_and_count_batch(x1b, max_regions=TH_REGIONS)
    den2, stats2 = stack_stats(x2)
    den2k, stats2k = stack_stats(x2k)
    torch.cuda.synchronize()
    threshold_s = time.perf_counter() - t0
    threshold_launches = read_counts()
    # four calls: K2 and K3 once each; K4 twice, the Otsu histogram and the
    # region table
    want_launches = {k: {"K2": 4, "K3": 4, "K4": 8}.get(k, 0) for k in threshold_launches}
    log(f"phase 9 threshold path: threshold_and_count {list(x1.shape)}, "
        f"threshold_and_count_batch {list(x1b.shape)}, stack_stats {list(x2.shape)} and "
        f"{list(x2k.shape)}: {threshold_s:.2f} s wall "
        f"[{card}]; kernel launches {threshold_launches}")
    if threshold_launches != want_launches:
        raise AssertionError(f"phase 9: launches {threshold_launches}, expected {want_launches} "
                             "(the histogram is K4's launch on the card)")

    def same(case: str, name: str, got, want) -> None:
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"phase 9 {case}: {name} differs from the plain versions'")

    def labelled(fg):
        """scipy's 8-connected components of a bool plane: (areas, count)."""
        lab, n = ndi.label(fg, structure=np.ones((3, 3), int))
        return np.bincount(lab.ravel(), minlength=n + 1)[1:], n

    def check_batch(case: str, x, got) -> None:
        """The kernels' six outputs against the plain versions on the card
        (thresholds bit for bit, labels where the plain CCL converged, K2's
        labels against scipy's where it did not) and scipy's counts."""
        t_k = otsu_threshold_batch(x)
        t_p, want = plain_threshold_batch(x, TH_REGIONS)
        same(case, "thresholds", t_k.view(torch.int32), t_p.view(torch.int32))
        mask, seg, count, num_fg, num_total, conv = got
        if not bool(conv.all()):
            raise AssertionError(f"phase 9 {case}: the kernels report a plane unconverged")
        same(case, "mask", mask, want[0])
        conv_p = want[5].cpu().tolist()
        for b, ok in enumerate(conv_p):
            if ok:
                for name, g, w in zip(("seg", "count", "num_fg", "num_total"), got[1:5], want[1:5]):
                    same(f"{case} plane {b}", name, g[b], w[b])
            else:
                m8 = mask[b].to(torch.uint8)
                want_raw = scipy_min_index(m8.cpu().numpy(), None, 8)
                if not np.array_equal(ccl_cuda(m8).cpu().numpy(), want_raw):
                    raise AssertionError(f"phase 9 {case} plane {b}: K2 differs from scipy")
        img, t_h, m_h = x.cpu().numpy(), t_k.cpu().numpy(), mask.cpu().numpy()
        counts, totals = count.cpu().tolist(), num_total.cpu().tolist()
        for b in range(img.shape[0]):
            fg = img[b] > t_h[b]
            areas, n_fg = labelled(fg)
            n_bg = labelled(~fg)[1]
            if not np.array_equal(fg, m_h[b]) or totals[b] != n_fg + n_bg:
                raise AssertionError(f"phase 9 {case} plane {b}: mask or num_total differs "
                                     f"from scipy's ({totals[b]} vs {n_fg} + {n_bg})")
            if totals[b] <= TH_REGIONS and counts[b] != int((areas >= 1).sum()):
                raise AssertionError(f"phase 9 {case} plane {b}: count {counts[b]}, scipy "
                                     f"{int((areas >= 1).sum())}")
        over = [b for b, n in enumerate(totals) if n > TH_REGIONS]
        log(f"phase 9 {case}: == plain on the card ({sum(conv_p)} of {len(conv_p)} planes "
            f"converged in the plain CCL's 64 rounds, K2 == scipy on the others), count and "
            f"num_total == scipy's; overflowing planes {over}")
        log(f"phase 9 {case}: thresholds {[float(v) for v in t_h]}")
        log(f"phase 9 {case}: count {counts}; num_total {totals}")

    t_p, conv_p, want = plain_threshold(x1, TH_REGIONS)
    if not bool(conv_p):
        raise AssertionError("phase 9: the plain CCL did not converge on config #1's plane")
    for name, g, w in zip(("mask", "seg", "count", "num"), single, want, strict=True):
        same(f"config #1 single {list(x1.shape)}", name, g, w)
    areas, n = labelled(c1.astype(np.float32) > float(t_p))
    if int(single[3]) != n or (n <= TH_REGIONS and int(single[2]) != int((areas >= 1).sum())):
        raise AssertionError(f"phase 9 config #1 single: count {int(single[2])}, num "
                             f"{int(single[3])}; scipy {n}")
    log(f"phase 9 config #1 single {list(x1.shape)}: == plain on the card; threshold "
        f"{float(t_p)}, count {int(single[2])} == scipy's")
    # the single-plane histogram and otsu_threshold: K4 on [1,512,512] bin ids
    launches = region_counts_cuda.launches
    counts, centers = histogram(x1)
    t1 = otsu_threshold(x1)
    if region_counts_cuda.launches != launches + 2:
        raise AssertionError("phase 9: histogram and otsu_threshold did not launch K4 once each")
    want_counts, want_centers = histogram(x1.cpu())
    same("config #1 histogram", "counts", counts.cpu(), want_counts)
    same("config #1 histogram", "centres", centers.cpu().view(torch.int32),
         want_centers.view(torch.int32))
    same("config #1 otsu_threshold", "threshold", t1.view(torch.int32), t_p.view(torch.int32))
    log(f"phase 9 config #1 histogram and otsu_threshold {list(x1.shape)}: one K4 launch "
        f"each, == the plain CPU histogram and the call's threshold")
    check_batch(f"config #1 batch {list(x1b.shape)}", as_float32(x1b), batch1)
    check_batch(f"config #2 stack_stats {list(x2.shape)}", den2, stats2)
    check_batch(f"config #2 stack_stats {list(x2k.shape)}", den2k, stats2k)
    # the [16,512,512] batch through the plain versions on the CPU
    t0 = time.perf_counter()
    cpu = threshold_and_count_batch(x1b.cpu(), max_regions=TH_REGIONS)
    cpu_s = time.perf_counter() - t0
    same("config #1 batch on the CPU", "thresholds",
         otsu_threshold_batch(x1b).cpu().view(torch.int32),
         otsu_threshold_batch(x1b.cpu()).view(torch.int32))
    for i, name in ((0, "mask"), (2, "count"), (3, "num_fg"), (4, "num_total")):
        same("config #1 batch on the CPU", name, batch1[i].cpu(), cpu[i])
    log(f"phase 9 config #1 batch {list(x1b.shape)}: thresholds, masks, count, num_fg and "
        f"num_total == the plain CPU run's ({cpu_s:.1f} s)")
    # config #2's smaller stack holds a near-tie (plane 6 at 512²: two cuts
    # within 1.5e-7 of each other), which a sum in another order flips: the
    # card's blur and thresholds equal the CPU's
    den_cpu = gaussian_blur(x2.cpu(), 1.0)
    same("config #2 on the CPU", "blur", den2.cpu().view(torch.int32), den_cpu.view(torch.int32))
    same("config #2 on the CPU", "thresholds", otsu_threshold_batch(den2).cpu().view(torch.int32),
         otsu_threshold_batch(den_cpu).view(torch.int32))
    log(f"phase 9 config #2 stack_stats {list(x2.shape)}: the blur and the thresholds == the "
        f"CPU's bit for bit")
    return threshold_launches


def write_tiff_pages(path: str, pages, description: str = "", **kw) -> None:
    """[N,H,W] pages as one multi-page TIFF, written by PIL as bench.py
    writes config #2's stacks (uncompressed unless ``kw`` passes PIL a
    ``compression``); ``description`` goes into tag 270 (an ImageJ
    hyperstack's ``channels=``)."""
    from PIL import Image

    ims = [Image.fromarray(p) for p in pages]
    if description:
        kw["tiffinfo"] = {270: description}
    ims[0].save(path, save_all=True, append_images=ims[1:], **kw)


def run_verbs(*argvs) -> list:
    """Run the port's CLI once for each argv, each in a fresh interpreter
    from the checkout root, all at once; each run's stdout lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-m", "particle_col_image_segmentation_tpu_torch",
                               *argv], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for argv, p, (_, err) in zip(argvs, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"the {argv[0]} verb exited {p.returncode}:\n"
                                 f"{err[-4000:]}")
    return [out.splitlines() for out, _ in outs]


def files_under(root: str) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs}


def split_and_normalize(tmp: str) -> float:
    """Phase 10's host verbs, each through ``python -m
    particle_col_image_segmentation_tpu_torch`` (both at once).  ``split``
    runs over a tree with a 4-channel ImageJ hyperstack [3 z x 4 ch, H²], a
    2-channel stack without metadata (its token says RFP_GFP) and a mip:
    every written plane must read back equal to its source plane, the
    stacks and the mip must be moved whole, and the files must be those
    split_zstack.py's naming gives (the clean name drops the channel token
    and "_zstack"; planes go to <clean>/<clean>_zstack_<ch>/
    <clean>_zstack_z<i>_<ch>.tif; RFP and GFP are channels 1 and 2 of four,
    0 and 1 of two).  ``normalize`` runs over a raw-capture tree and must
    move each z-stack and its own mip siblings (not "Tp_RFP_30"'s into
    "Tp_RFP_3"'s) into one clean folder, and skip dot-folders.  Returns the
    wall seconds of the two verbs."""
    import numpy as np

    from particle_col_image_segmentation_tpu_torch.io.tiff import read_tiff_stack

    n = H
    rng = np.random.default_rng(5)
    top = os.path.join(tmp, "top")
    acq = os.path.join(top, "acq1")
    os.makedirs(acq)
    four = rng.integers(0, 1 << 16, (3, 4, n, n), dtype=np.uint16)
    two = rng.integers(0, 1 << 16, (2, 2, n, n), dtype=np.uint16)
    write_tiff_pages(os.path.join(acq, "Tp_CY5_RFP_GFP_DAPI_1_zstack.tif"), four.reshape(12, n, n),
                     "ImageJ=1.53c\nimages=12\nchannels=4\nslices=3\n")
    write_tiff_pages(os.path.join(acq, "Tp_RFP_GFP_2_zstack.tif"), two.reshape(4, n, n))
    write_tiff_pages(os.path.join(acq, "Tp_RFP_GFP_2_mip.tif"), two.max(axis=(0, 1))[None])
    moved = {}
    for name, clean in (("Tp_CY5_RFP_GFP_DAPI_1_zstack.tif", "Tp_1"),
                        ("Tp_RFP_GFP_2_zstack.tif", "Tp_2"), ("Tp_RFP_GFP_2_mip.tif", "Tp_2")):
        with open(os.path.join(acq, name), "rb") as f:
            moved[f"acq1/{clean}/{name}"] = f.read()
    planes = {}
    for clean, stack, chans in (("Tp_1", four, {"RFP": 1, "GFP": 2}),
                                ("Tp_2", two, {"RFP": 0, "GFP": 1})):
        for ch, c in chans.items():
            for z in range(stack.shape[0]):
                rel = f"acq1/{clean}/{clean}_zstack_{ch}/{clean}_zstack_z{z}_{ch}.tif"
                planes[rel] = stack[z, c]

    cap = os.path.join(tmp, "cap")
    run = os.path.join(cap, "run1")
    os.makedirs(run)
    os.makedirs(os.path.join(cap, ".hidden"))
    raw = {"Tp_3": ("Tp_RFP_3_zstack.tif", "Tp_RFP_3_mip.tif", "Tp_RFP_3_mip.jpg"),
           "Tp_30": ("Tp_RFP_30_zstack.tif", "Tp_RFP_30_mip.tif")}  # clean folder: files
    for names in raw.values():
        for name in names:
            with open(os.path.join(run, name), "wb") as f:
                f.write(name.encode())
    with open(os.path.join(cap, ".hidden", "Tp_RFP_4_zstack.tif"), "wb") as f:
        f.write(b"skipped")

    t0 = time.perf_counter()
    _, norm_out = run_verbs(["split", top], ["normalize", cap])
    verbs_s = time.perf_counter() - t0

    if files_under(top) != set(moved) | set(planes):
        raise AssertionError(f"phase 10 split: files {sorted(files_under(top))}, expected "
                             f"{sorted(set(moved) | set(planes))}")
    for rel, data in moved.items():
        with open(os.path.join(top, rel), "rb") as f:
            if f.read() != data:
                raise AssertionError(f"phase 10 split: {rel} was not moved whole")
    for rel, src in planes.items():
        got = read_tiff_stack(os.path.join(top, rel))
        if got.dtype != src.dtype or not np.array_equal(got, src):
            raise AssertionError(f"phase 10 split: {rel} differs from its source plane")
    want_lines = sorted(f"normalized: {os.path.join(run, clean)}" for clean in raw)
    want_files = {f"run1/{clean}/{name}" for clean, names in raw.items() for name in names}
    want_files.add(".hidden/Tp_RFP_4_zstack.tif")
    if sorted(norm_out) != want_lines or files_under(cap) != want_files:
        raise AssertionError(f"phase 10 normalize: printed {norm_out}, files "
                             f"{sorted(files_under(cap))}; expected {want_lines}, "
                             f"{sorted(want_files)}")
    log(f"phase 10 split [3 z x 4 ch, {n}²] ImageJ hyperstack, a 2-channel [2 z x 2 ch] "
        f"stack and a mip: {len(planes)} planes == their source planes, stacks and mip moved "
        f"whole, files == the naming rules'; normalize: {norm_out} == expected, tree moved; "
        f"both verbs {verbs_s:.1f} s wall")
    return verbs_s


def zstack_phase(card: str, dev, reset_counts, read_counts) -> tuple:
    """Phase 10: config #2 from TIFFs on disk (bench.py's bench_config2).
    For each of ZSTACK_CELLS the stacks (drawn in sequence from seed 2) are
    written as multi-page uint16 TIFFs; each must decode through the port's
    native codec (``native.read_tiff`` is not None, so no time below is
    PIL's) equal to what was written.  Page cache warm throughout: each file
    was just written.  Per stack, by the host's clock: a copy of the decoded
    stack into a fresh buffer and into a reused, pre-touched one (their
    difference is the host's first-touch cost) and the host copy into a
    pinned buffer; by CUDA events: host to device from that pinned buffer
    and ``stack_stats`` on a device-resident stack.  Every stack's blur and
    thresholds equal the plain CPU run's bit for bit, its mask the CPU's
    den > t, each plane's count and num_total scipy's components of it; the
    first stack of the first cell equals the plain CPU ``stack_stats`` in
    every output.  Then, ZSTACK_REPS times each, launch counts reset just
    before and read just after: end to end as bench.py times it (decode
    inside the timer, stacks in sequence, one sync at the end), and the same
    loop stepped (a sync after each step; decode, the pageable copy and
    ``stack_stats`` each by the host's clock, per stack).  A CPU baseline
    (scipy blur, numpy Otsu, scipy label, decode inside the timer) over the
    first cell's first stack gives ``vs_cpu``.  Then
    ``split_and_normalize``.  Returns (launch counts, the record's
    ``zstack`` entry)."""
    import numpy as np
    import torch
    from scipy import ndimage as ndi

    import bench
    from particle_col_image_segmentation_tpu_torch.io import native
    from particle_col_image_segmentation_tpu_torch.io.tiff import read_tiff_stack
    from particle_col_image_segmentation_tpu_torch.ops import gaussian_blur, otsu_threshold_batch

    if not native.available():
        raise AssertionError("phase 10: the port's native TIFF codec did not build or load "
                             "(g++'s output is logged above); decode times would be PIL's")
    eight = np.ones((3, 3), int)

    def median(xs):
        return float(np.median(xs))

    def spread(xs) -> str:
        return f"{median(xs):.3f} ({min(xs):.3f}–{max(xs):.3f})"

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def host_ms(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def bits(t):
        return t.cpu().view(torch.int32)

    t_phase = time.perf_counter()
    record = {"card": card, "page_cache": "warm: each file was just written",
              "timer": "CUDA events for the pinned copy and device-resident compute, the "
                       "host's clock for the host copies, the stepped loop and e2e",
              "cells": {}}
    with tempfile.TemporaryDirectory(prefix="pcis_zstack_") as tmp:
        t0 = time.perf_counter()
        files = {}
        for key, stacks, n, discs in ZSTACK_CELLS:
            files[key] = []
            for s, stack in enumerate(config2_stacks(stacks, n, discs)):
                path = os.path.join(tmp, f"stack{n}_{s}_zstack.tif")
                write_tiff_pages(path, stack)
                got = native.read_tiff(path)
                if got is None or got.dtype != np.uint16 or not np.array_equal(got, stack):
                    raise AssertionError(f"phase 10 {key} stack {s}: the native codec did not "
                                         "decode the written stack bit for bit")
                files[key].append(path)
        log(f"phase 10 zstack: {sum(len(v) for v in files.values())} stacks written and decoded "
            f"by the native codec bit for bit in {time.perf_counter() - t0:.1f} s")

        first = True
        for key, paths in files.items():
            c = {"stacks": len(paths), "fresh_fill_ms": [], "reused_fill_ms": [],
                 "h2d_pinned_ms": [], "pin_stage_ms": [], "compute_ms": []}
            for s, path in enumerate(paths):
                a = read_tiff_stack(path)
                # the control for first-touch page faults: the same copy into
                # a fresh buffer each time, and into one buffer touched before
                c["fresh_fill_ms"].append(median([host_ms(lambda: np.copyto(np.empty_like(a), a))
                                                  for _ in range(ZSTACK_REPS)]))
                reused = np.zeros_like(a)
                c["reused_fill_ms"].append(median([host_ms(lambda: np.copyto(reused, a))
                                                   for _ in range(ZSTACK_REPS)]))
                del reused
                src = torch.from_numpy(a)
                pin = torch.empty(a.shape, dtype=src.dtype, pin_memory=True)
                c["pin_stage_ms"].append(median([host_ms(lambda: pin.copy_(src))
                                                 for _ in range(ZSTACK_REPS)]))
                x = torch.empty(a.shape, dtype=src.dtype, device=dev)
                c["h2d_pinned_ms"].append(median([
                    event_ms(lambda: x.copy_(pin, non_blocking=True)) for _ in range(ZSTACK_REPS)]))
                if not np.array_equal(x.view(torch.int16).cpu().numpy().view(np.uint16), a):
                    raise AssertionError(f"phase 10 {key} stack {s}: the pinned copy differs")
                del pin
                c["compute_ms"].append(median([event_ms(lambda: stack_stats(x))
                                               for _ in range(ZSTACK_REPS + 2)][1:]))
                den, out = stack_stats(x)
                # the same decoded stack through the plain versions on the CPU
                den_cpu = gaussian_blur(src, 1.0)
                t_cpu = otsu_threshold_batch(den_cpu)
                if not (torch.equal(bits(den), den_cpu.view(torch.int32))
                        and torch.equal(bits(otsu_threshold_batch(den)), t_cpu.view(torch.int32))):
                    raise AssertionError(f"phase 10 {key} stack {s}: the blur or the thresholds "
                                         "differ from the plain CPU run's")
                mask = den_cpu > t_cpu[:, None, None]
                mask_k, count, num_total, conv = (out[0].cpu(), out[2].cpu().tolist(),
                                                  out[4].cpu().tolist(), bool(out[5].all()))
                if not conv or not torch.equal(mask_k, mask):
                    raise AssertionError(f"phase 10 {key} stack {s}: the mask differs from the "
                                         "CPU's den > t, or a plane is unconverged")
                for b, fg in enumerate(mask.numpy()):
                    n_fg = ndi.label(fg, structure=eight)[1]
                    n_all = n_fg + ndi.label(~fg, structure=eight)[1]
                    if num_total[b] != n_all or (n_all <= TH_REGIONS and count[b] != n_fg):
                        raise AssertionError(f"phase 10 {key} stack {s} plane {b}: count "
                                             f"{count[b]}, num_total {num_total[b]}; scipy "
                                             f"{n_fg}, {n_all}")
                if first:
                    t1 = time.perf_counter()
                    want = stack_stats(src)[1]
                    for i, name in ((0, "mask"), (1, "seg"), (2, "count"), (3, "num_fg"),
                                    (4, "num_total")):
                        if not torch.equal(out[i].cpu(), want[i]):
                            raise AssertionError(f"phase 10 {key} stack 0: {name} differs from "
                                                 "the plain CPU stack_stats'")
                    log(f"phase 10 {key} stack 0: mask, seg, count, num_fg and num_total == the "
                        f"plain CPU stack_stats' ({time.perf_counter() - t1:.1f} s)")
                    first = False
                del x, den, out, src, a
            torch.cuda.empty_cache()
            c["shape"] = key
            c["mb_per_stack"] = os.path.getsize(paths[0]) / 1e6
            record["cells"][key] = c
        log(f"phase 10 zstack: every stack's blur and thresholds == the plain CPU run's bit for "
            f"bit, masks == the CPU's den > t, counts and num_total == scipy's "
            f"({time.perf_counter() - t_phase:.1f} s into the phase)")

        # end to end as bench.py times it, then the same loop stepped; launch
        # counts over all their runs
        reset_counts()
        for key, paths in files.items():
            walls, stepped_walls, totals = [], [], set()
            steps = {"decode_ms": [], "h2d_pageable_ms": [], "stack_stats_ms": []}
            for _ in range(ZSTACK_REPS):
                acc, npx = [], 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for path in paths:
                    a = read_tiff_stack(path)
                    out = stack_stats(torch.from_numpy(a).to(dev))[1]
                    acc.append((out[2] + out[3]).sum())
                    npx += a.size
                totals.add(int(torch.stack(acc).sum()))
                walls.append(time.perf_counter() - t0)

                acc = []
                t0 = time.perf_counter()
                for path in paths:
                    t1 = time.perf_counter()
                    a = read_tiff_stack(path)
                    t2 = time.perf_counter()
                    x = torch.from_numpy(a).to(dev)
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    out = stack_stats(x)[1]
                    acc.append((out[2] + out[3]).sum())
                    torch.cuda.synchronize()
                    t4 = time.perf_counter()
                    for k, (u, v) in zip(steps, ((t1, t2), (t2, t3), (t3, t4))):
                        steps[k].append((v - u) * 1e3)
                totals.add(int(torch.stack(acc).sum()))
                stepped_walls.append(time.perf_counter() - t0)
            if len(totals) != 1:
                raise AssertionError(f"phase 10 {key}: the end-to-end runs disagree: {totals}")
            c = record["cells"][key]
            c["e2e_s"] = walls
            c["e2e_mps"] = npx / 1e6 / median(walls)
            c["stepped_s"] = stepped_walls
            c.update(steps)
        launches = read_counts()
        n_calls = 2 * ZSTACK_REPS * sum(len(p) for p in files.values())
        want_launches = {k: {"K2": n_calls, "K3": n_calls, "K4": 2 * n_calls}.get(k, 0)
                         for k in launches}
        if launches != want_launches:
            raise AssertionError(f"phase 10: launches {launches}, expected {want_launches}")

        # the CPU baseline (bench.py's), decode inside the timer
        base_key = next(iter(files))
        t0 = time.perf_counter()
        a = read_tiff_stack(files[base_key][0])
        for plane in a:
            den = ndi.gaussian_filter(plane.astype(np.float32), sigma=1.0)
            lab, _ = ndi.label(den > bench._cpu_otsu(den), structure=eight)
            np.bincount(lab.ravel())
        cpu_s = time.perf_counter() - t0
        record["cpu_baseline"] = {"shape": base_key, "s": cpu_s, "mps": a.size / 1e6 / cpu_s}
        record["vs_cpu"] = record["cells"][base_key]["e2e_mps"] / record["cpu_baseline"]["mps"]

        for key, c in record["cells"].items():
            log(f"phase 10 times [{card}] {key} x {c['stacks']} stacks ({c['mb_per_stack']:.1f} "
                f"MB a file), ms a stack, median (min–max) over stacks: a copy of the decoded "
                f"stack into a fresh buffer {spread(c['fresh_fill_ms'])}, into a reused "
                f"pre-touched one {spread(c['reused_fill_ms'])}; host to device pinned by events "
                f"{spread(c['h2d_pinned_ms'])} (+ {spread(c['pin_stage_ms'])} host copy into the "
                f"pinned buffer); stack_stats by events {spread(c['compute_ms'])}")
            log(f"phase 10 times [{card}] {key} stepped (the host's clock, a sync after each "
                f"step), ms a stack over {ZSTACK_REPS} runs x {c['stacks']} stacks: decode "
                f"{spread(c['decode_ms'])} {[round(v, 3) for v in c['decode_ms']]}; host to "
                f"device pageable {spread(c['h2d_pageable_ms'])} "
                f"{[round(v, 3) for v in c['h2d_pageable_ms']]}; stack_stats "
                f"{spread(c['stack_stats_ms'])}; stepped walls "
                f"{[round(w, 4) for w in c['stepped_s']]} s")
            log(f"phase 10 times [{card}] {key} end to end {c['e2e_mps']:.1f} MP/s (walls "
                f"{[round(w, 4) for w in c['e2e_s']]} s)")
        log(f"phase 10 times [{card}] CPU baseline {base_key} (decode, scipy blur, numpy Otsu, "
            f"scipy label): {cpu_s:.3f} s = {record['cpu_baseline']['mps']:.2f} MP/s; vs_cpu "
            f"{record['vs_cpu']:.1f}; launches {launches}")
        record["verbs_s"] = split_and_normalize(tmp)
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10 zstack: {record['phase_s']:.1f} s wall")
    return launches, record


# ---- the morphology/EDT API and config #4 (phases 3 and 11) ----------------


def serpentine(h: int = 41, w: int = 40, pitch: int = 4):
    """A one-pixel background corridor entering at the top border and winding
    through the whole plane: the plain hole flood needs one round a bend."""
    import numpy as np

    m = np.ones((h, w), bool)
    for k, r in enumerate(range(1, h - 1, pitch)):
        m[r, 1:w - 1] = False
        if r + pitch < h - 1:
            c = w - 2 if k % 2 == 0 else 1
            m[r:r + pitch + 1, c] = False
    m[0, 1] = False  # the corridor's mouth on the border
    return m


def plain_morphology():
    """erode/open/close_disk through the plain capped transform (the K9
    route's plain version), on any device."""
    from particle_col_image_segmentation_tpu_torch.ops import edt_sq

    def dilate(m, r):
        return edt_sq(m, r) <= r * r

    def erode(m, r):
        return ~dilate(~m, r)

    return {"erode_disk": erode, "open_disk": lambda m, r: dilate(erode(m, r), r),
            "close_disk": lambda m, r: erode(dilate(m, r), r)}


def morph_checks(dev, planes4, odd, tile_cap: int, compare) -> None:
    """Phase 3's morphology/EDT checks: each op's kernel route against its
    plain version on the card, exact (floats as bit patterns), on the 2048²
    bench planes' cell and particle masks and the odd [3,97,130] batch."""
    import numpy as np
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import (
        boundary_mask, close_disk, edt, edt_sq, erode_disk, fill_holes, fill_holes_fixpoint,
        open_disk, sqrt_f32)

    plain = plain_morphology()
    ops = {"erode_disk": erode_disk, "open_disk": open_disk, "close_disk": close_disk}
    x4 = torch.from_numpy(planes4).to(dev)
    masks = {f"[4,{H},{W}] cells": (x4 == 1).contiguous(),
             f"[4,{H},{W}] particles": (x4 == 2).contiguous(),
             "odd [3,97,130] cells": torch.from_numpy(odd == 1).to(dev)}
    for case, m in masks.items():
        for r in (0, 1, 2, 20, tile_cap, tile_cap + 1):
            for name, fn in ops.items():
                compare("K9", f"{name} r={r} {case}", [fn(m, r)], [plain[name](m, r)])
        got, conv = fill_holes(m, with_flag=True)
        want, want_conv = fill_holes_fixpoint(m, with_flag=True)
        if not (bool(conv) and bool(want_conv)):
            raise AssertionError(f"fill_holes {case}: the plain fixpoint did not converge")
        compare("K2", f"fill_holes {case}", [got], [want])
        compare("K9", f"edt cap 20 {case} (bit patterns)", [edt(m, 20).view(torch.int32)],
                [sqrt_f32(edt_sq(m, 20)).view(torch.int32)])
        if not torch.equal(boundary_mask(m).cpu(), boundary_mask(m.cpu())):
            raise AssertionError(f"boundary_mask {case}: the card differs from the CPU")
    # a corridor past a small budget: the plain flood stops short and says
    # so; compared where it converges
    s = torch.from_numpy(np.stack([serpentine(97, 130), serpentine(97, 130, 6)])).to(dev)
    short, short_conv = fill_holes_fixpoint(s, max_iters=3, with_flag=True)
    want, want_conv = fill_holes_fixpoint(s, max_iters=256, with_flag=True)
    if bool(short_conv) or torch.equal(short, want) or not bool(want_conv):
        raise AssertionError("fill_holes: the serpentine did not outlast a budget of 3")
    compare("K2", "fill_holes serpentine [2,97,130] (plain converged at 256, not at 3)",
            [fill_holes(s, max_iters=3)], [want])
    log(f"phase 3 morphology: erode/open/close_disk (K9), fill_holes (K2), edt and "
        f"boundary_mask == plain on the card for r in 0, 1, 2, 20, {tile_cap}, {tile_cap + 1}")


def morph_phase(card: str, dev, planes4, reset_counts, read_counts) -> tuple:
    """The morphology/EDT API on the bench planes' [4,2048,2048] cell masks:
    one run of each op with launch counts reset just before and read just
    after (K9 and K2 must launch), then each op's time by CUDA events, the
    kernel route beside the plain one on the card.  Returns (launch counts,
    times)."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import (
        boundary_mask, close_disk, edt, edt_sq, erode_disk, fill_holes, fill_holes_fixpoint,
        open_disk, sqrt_f32)

    m = (torch.from_numpy(planes4).to(dev) == 1).contiguous()
    plain = plain_morphology()
    kernel, plain_fn = {}, {}
    for r in (2, 20):
        for name, fn in (("erode_disk", erode_disk), ("open_disk", open_disk),
                         ("close_disk", close_disk)):
            kernel[f"{name} r={r}"] = lambda fn=fn, r=r: fn(m, r)
            plain_fn[f"{name} r={r}"] = lambda name=name, r=r: plain[name](m, r)
    kernel.update({"fill_holes": lambda: fill_holes(m), "edt cap 20": lambda: edt(m, 20),
                   "boundary_mask": lambda: boundary_mask(m)})
    reset_counts()
    for fn in kernel.values():
        fn()
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["K9"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"the morphology path launched {launches}")
    plain_fn.update({"fill_holes": lambda: fill_holes_fixpoint(m),
                     "edt cap 20": lambda: sqrt_f32(edt_sq(m, 20))})
    times = {}
    for k, fn in kernel.items():
        times[k] = {"ms": time_ms(fn, reps=5)}
        if k in plain_fn:
            times[k]["plain_ms"] = time_ms(plain_fn[k], reps=1)
        log(f"phase 11 morphology times [{card}] [4,{H},{W}] cells: {k}: "
            + ", ".join(f"{a} {b:.4f}" for a, b in times[k].items()))
    log(f"phase 11 morphology path: kernel launches {launches}")
    return launches, times


def config4_painting(h: int = 768, w: int = 768, size_y: int = 36, size_x: int = 36,
                     pitch_y: int = 66, pitch_x: int = 66):
    """Config #4's painted ROI image (bench.py's ``bench_nanosims`` recipe,
    seed-free): squares on a grid, the first 128 painted, odd ids red
    (255,0,0) and even ids green (0,255,0), on white; and their id image."""
    import numpy as np

    rgb = np.full((h, w, 3), 255, np.uint8)
    labels = np.zeros((h, w), np.int32)
    k = 1
    for gy in range(0, h - 48, pitch_y):
        for gx in range(0, w - 48, pitch_x):
            if k > 128:
                break
            sl = (slice(gy + 4, gy + 4 + size_y), slice(gx + 4, gx + 4 + size_x))
            labels[sl] = k
            rgb[sl] = (255, 0, 0) if k % 2 else (0, 255, 0)
            k += 1
    return rgb, labels


def write_acquisition(root: str, painted, seed: int) -> None:
    """An acquisition folder: the eight .mat count images of [514,514] (the
    1-px frame included; ``rng.random·50``), ``rois.png`` and ``bound.png``
    (a red stroke across the painted field)."""
    import numpy as np
    from PIL import Image
    from scipy.io import savemat

    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for name in ("12C", "13C", "14N12C", "15N12C", "16O", "17O", "18O", "Esi"):
        savemat(os.path.join(root, f"{name}.mat"), {"IM": rng.random((514, 514)) * 50})
    Image.fromarray(painted).save(os.path.join(root, "rois.png"))
    h, w = painted.shape[:2]
    bound = np.full((h, w, 3), 255, np.uint8)
    bound[h // 2 - 3:h // 2 + 3, w // 8:w - w // 8] = (255, 0, 0)
    bound[h // 4:h - h // 4, w // 2 - 3:w // 2 + 3] = (255, 0, 0)
    Image.fromarray(bound).save(os.path.join(root, "bound.png"))


def read_csvs(folder: str) -> dict:
    import numpy as np

    return {f: np.loadtxt(os.path.join(folder, f), delimiter=",", ndmin=2)
            for f in sorted(os.listdir(folder)) if f.endswith(".csv")}


def csvs_agree(got: dict, want: dict, rtol: float, case: str) -> None:
    """Same files and shapes, class and index columns exact, every value
    within rtol (or one unit in its 5th significant digit, the CSV's
    rounding)."""
    import numpy as np

    if sorted(got) != sorted(want):
        raise AssertionError(f"{case}: files {sorted(got)}, expected {sorted(want)}")
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape or not np.array_equal(g[:, :2], w[:, :2]):
            raise AssertionError(f"{case}: {name} differs in shape or class/index columns")
        mag = np.where(np.isfinite(w) & (w != 0), np.abs(w), 1.0)
        tol = rtol * np.abs(w) + 10.0 ** (np.floor(np.log10(mag)) - 4)
        ok = (np.isnan(g) == np.isnan(w)) & (np.isnan(w) | (np.abs(g - w) <= tol))
        if not ok.all():
            raise AssertionError(f"{case}: {name} differs at {np.argwhere(~ok)[:5].tolist()}")


def stepped_nanosims(acq: str, out_dir: str, cfg, dev) -> dict:
    """run_nanosims, figures off, step by step with a sync after each step;
    host-clock ms of each step."""
    import numpy as np
    import torch
    from PIL import Image

    from particle_col_image_segmentation_tpu_torch.models import nanosims as ns

    ms = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        torch.cuda.synchronize()
        t = time.perf_counter()
        ms[name] = (t - t0) * 1e3
        t0 = t

    iso = ns.load_isotope_mats(acq)
    step(".mat load")
    rois = ns.crop_to_content(np.asarray(Image.open(os.path.join(acq, "rois.png")).convert("RGB")))
    red_mask, green_mask = ns.class_masks(rois)
    bound = ns.crop_to_content(np.asarray(Image.open(os.path.join(acq, "bound.png"))
                                          .convert("RGB")))
    bmask = ns.boundary_class_mask(bound)
    step("PNG and class masks")
    labs = [ns.roi_labels(m, cfg.max_rois, dev) for m in (red_mask, green_mask)]
    step("K2+K3")
    red, green = (ns.roi_class_result(lab, n, iso) for lab, n in labs)
    step("resize+sums+centroids")
    result = ns.combine_classes(red, green, rois, cfg, dev)
    bd = ns.boundary_distances(result, bound, next(iter(iso.values())).shape[0], cfg,
                               bound_mask=bmask, device=dev)
    step("distances")
    ns.write_csvs(result, out_dir, bd)
    step("CSVs")
    return ms


NANOSIMS_REPS = 5


def nanosims_phase(card: str, dev, reset_counts, read_counts) -> tuple:
    """Phase 11: config #4 (bench.py's ``bench_nanosims`` acquisition).
    Two acquisitions written to a temp folder: the 768² painting of 121
    squares of 36² and the same grid painted at 700×650 (a resize ratio that
    is no integer, a content crop that is not square), each with eight
    [514,514] .mat images.  run_nanosims on the card, launch counts reset
    just before and read just after (K2 and K3 must launch), against the
    plain CPU run of the same folders: ROI counts, labels and each ROI's
    resized mask equal bit for bit (so the solid masks too), positions bit
    for bit, sums rtol 1e-6, every CSV value by value at that tolerance.
    The ``nanosims`` verb in a fresh interpreter (device default cuda)
    prints the CPU run's line and writes its CSVs.  Times, host clock,
    median and spread over NANOSIMS_REPS runs after a warm-up: run_nanosims
    a acquisition and the same flow stepped; the per-ROI reduction alone on
    bench's labels, as bench.py times ``_roi_batched`` (its keys
    ``4_nanosims_ms_per_acq``, ``4_nanosims_rois_per_s``), and bench's
    scipy CPU baseline for ``4_vs_cpu``.  Returns (launch counts, the
    record's ``nanosims`` entry)."""
    import statistics

    import numpy as np
    import torch
    from scipy.ndimage import zoom

    from particle_col_image_segmentation_tpu_torch.config import NanoSIMSConfig
    from particle_col_image_segmentation_tpu_torch.models import nanosims as ns
    from particle_col_image_segmentation_tpu_torch.ops.resize import resize_cubic

    cfg = NanoSIMSConfig()
    t_phase = time.perf_counter()
    record = {}
    launches = None
    with tempfile.TemporaryDirectory(prefix="pcis_nanosims_") as tmp:
        acqs = {"768x768": config4_painting()[0],
                "700x650": config4_painting(700, 650, 33, 30, 60, 56)[0]}
        for seed, (key, painted) in enumerate(acqs.items()):
            write_acquisition(os.path.join(tmp, key), painted, seed=3 + seed)

        def run(key, device, out):
            os.makedirs(out)
            acq = os.path.join(tmp, key)
            return ns.run_nanosims(acq, os.path.join(acq, "rois.png"),
                                   os.path.join(acq, "bound.png"), out, cfg,
                                   make_figures=False, device=device)

        reset_counts()
        card_res = {k: run(k, dev, os.path.join(tmp, "card", k)) for k in acqs}
        cpu_res = {}
        torch.cuda.synchronize()
        launches = read_counts()
        if launches["K2"] <= 0 or launches["K3"] <= 0:
            raise AssertionError(f"phase 11: the nanosims path launched {launches}")
        for key in acqs:
            t0 = time.perf_counter()
            cpu = cpu_res[key] = run(key, "cpu", os.path.join(tmp, "cpu", key))
            cpu_s = time.perf_counter() - t0
            got = card_res[key]
            for cls in ("red", "green"):
                g, w = getattr(got, cls), getattr(cpu, cls)
                if g.num_rois != w.num_rois or not np.array_equal(g.labels, w.labels):
                    raise AssertionError(f"phase 11 {key} {cls}: ROIs or labels differ")
                if not np.array_equal(g.positions, w.positions, equal_nan=True):
                    raise AssertionError(f"phase 11 {key} {cls}: positions differ")
                if not np.allclose(g.sums, w.sums, rtol=1e-6, atol=0):
                    raise AssertionError(f"phase 11 {key} {cls}: sums differ past rtol 1e-6")
                onehot = (g.labels[None] == np.arange(1, g.num_rois + 1)[:, None, None])
                onehot = torch.from_numpy(onehot.astype(np.float32))
                if not torch.equal(resize_cubic(onehot.to(dev), 512).cpu(),
                                   resize_cubic(onehot, 512)):
                    raise AssertionError(f"phase 11 {key} {cls}: a resized ROI mask differs")
            csvs_agree(read_csvs(os.path.join(tmp, "card", key)),
                       read_csvs(os.path.join(tmp, "cpu", key)), 1e-6, f"phase 11 {key}")
            log(f"phase 11 nanosims {key}: {got.red.num_rois} red and {got.green.num_rois} "
                f"green ROIs; labels, resized masks and positions == the plain CPU run's "
                f"({cpu_s:.1f} s) bit for bit, sums and every CSV within rtol 1e-6")
        # the verb in a fresh interpreter, on the card by default
        acq = os.path.join(tmp, "768x768")
        verb_out = os.path.join(tmp, "verb")
        os.makedirs(verb_out)
        lines = run_verbs(["nanosims", acq, os.path.join(acq, "rois.png"), "--bound-png",
                           os.path.join(acq, "bound.png"), "--out-dir", verb_out,
                           "--no-figures"])[0]
        cpu = cpu_res["768x768"]
        want_line = (f"red ROIs: {cpu.red.num_rois}, green ROIs: {cpu.green.num_rois}; "
                     f"CSVs written to {verb_out}")
        if lines[-1:] != [want_line]:
            raise AssertionError(f"phase 11: the nanosims verb printed {lines[-3:]}")
        csvs_agree(read_csvs(verb_out), read_csvs(os.path.join(tmp, "cpu", "768x768")), 1e-6,
                   "phase 11 nanosims verb")
        log("phase 11 nanosims verb (fresh interpreter, --device defaulting to cuda): exit 0, "
            "the CPU run's line and CSVs")

        # times: run_nanosims and the same flow stepped, the reduction alone
        walls, steps = [], []
        for rep in range(NANOSIMS_REPS + 1):
            out = os.path.join(tmp, "t", str(rep))
            t0 = time.perf_counter()
            run("768x768", dev, out)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            step_out = os.path.join(tmp, "s", str(rep))
            os.makedirs(step_out)
            st = stepped_nanosims(acq, step_out, cfg, dev)
            if rep:  # the first run warms up
                walls.append(wall)
                steps.append(st)
        if read_csvs(step_out).keys() != read_csvs(out).keys():
            raise AssertionError("phase 11: the stepped run wrote other files")
        for name in read_csvs(out):
            with open(os.path.join(out, name), "rb") as a, open(os.path.join(step_out, name),
                                                               "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"phase 11: the stepped run's {name} differs")

    def spread(vals):
        return {"median": statistics.median(vals), "min": min(vals), "max": max(vals)}

    record["run_nanosims_ms"] = spread(walls)
    record["stepped_ms"] = {k: spread([s[k] for s in steps]) for k in steps[0]}
    record["stepped_total_ms"] = spread([sum(s.values()) for s in steps])
    # the per-ROI reduction alone on bench's labels and isotopes (bench.py:394-407)
    _, labels = config4_painting()
    n_rois = int(labels.max())
    rng = np.random.default_rng(3)
    iso = torch.from_numpy(rng.random((7, 512, 512)).astype(np.float32)).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    red_ms = []
    for rep in range(NANOSIMS_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums, _ = ns.roi_sums_and_centroids(lab, iso, n_rois, 512)
        torch.cuda.synchronize()
        if rep:
            red_ms.append((time.perf_counter() - t0) * 1e3)
    # bench.py's CPU comparison: scipy's cubic zoom and masked sums a ROI
    # on 8 sample ROIs (bench.py:421-437)
    iso_np = iso.cpu().numpy()
    t0 = time.perf_counter()
    for rid in range(1, 9):
        m = (labels == rid).astype(np.float32)
        resized = zoom(m, 512 / 768, order=3, grid_mode=True, mode="grid-constant")
        _ = (resized[None] * iso_np).sum(axis=(1, 2))
        _ = np.nonzero(np.floor(resized) >= 1)
    cpu_rois_per_s = 8 / (time.perf_counter() - t0)
    med = statistics.median(red_ms)
    record.update({
        "roi_reduction_ms": spread(red_ms), "n_rois": n_rois,
        "4_nanosims_ms_per_acq": med, "4_nanosims_rois_per_s": n_rois / med * 1e3,
        "4_vs_cpu": n_rois / med * 1e3 / cpu_rois_per_s, "cpu_rois_per_s": cpu_rois_per_s,
    })
    record["phase_s"] = time.perf_counter() - t_phase
    r = record
    log(f"phase 11 times [{card}] run_nanosims 768² painting, 121 ROIs, 7 isotopes at 512², "
        f"host clock over {NANOSIMS_REPS} runs: median {r['run_nanosims_ms']['median']:.3f} ms "
        f"({r['run_nanosims_ms']['min']:.3f}-{r['run_nanosims_ms']['max']:.3f})")
    for k, v in r["stepped_ms"].items():
        log(f"phase 11 times [{card}]   stepped {k}: median {v['median']:.3f} ms "
            f"({v['min']:.3f}-{v['max']:.3f})")
    log(f"phase 11 times [{card}]   stepped total: median {r['stepped_total_ms']['median']:.3f} ms")
    log(f"phase 11 times [{card}] the per-ROI reduction [768²→512², {n_rois} ROIs, 7 isotopes]: "
        f"median {med:.3f} ms ({min(red_ms):.3f}-{max(red_ms):.3f}); "
        f"4_nanosims_rois_per_s {r['4_nanosims_rois_per_s']:.1f}, CPU baseline "
        f"{cpu_rois_per_s:.2f} ROIs/s, 4_vs_cpu {r['4_vs_cpu']:.1f}")
    log(f"phase 11 nanosims: {r['phase_s']:.1f} s wall")
    return launches, record



# ---- the tunnelled refine (phase 12) ----------------------------------------

def quantize16(x):
    """bench.py's 16-level quantization of a relief."""
    import numpy as np

    return (np.round(x * 15.0) / 15.0).astype(np.float32)


def sparse_seeds(n: int = 128, k: int = 8):
    """The tunnel's regime (the JAX package's test_sparse_quantized_parity_lift):
    a k-level noise relief with 20 unconfined point seeds, (img, markers)."""
    import numpy as np

    prob = np.random.default_rng(0).random((n, n)).astype(np.float32)
    q = (np.round(prob * (k - 1)) / (k - 1)).astype(np.float32)
    mk = np.zeros((n, n), np.int32)
    pts = sorted({(int(y), int(x)) for y, x in np.random.default_rng(2).integers(0, n, (20, 2))})
    for i, (cy, cx) in enumerate(pts):
        mk[cy, cx] = i + 1
    return q, mk


def basins_vs_scipy(img, mk, m, conn: int):
    """The card's basin segments (K10's costs, then ``basin_segments``: K2 on
    the below-level mask) against scipy's min-index labels of the same mask,
    plus plane offsets.  Returns (basins, pixels in basins, largest basin)."""
    import numpy as np

    from particle_col_image_segmentation_tpu_torch.ops.watershed import basin_segments
    from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
        _INF,
        minimax_costs_cuda,
    )

    seeded = (mk > 0) & m
    cost, busy, _ = minimax_costs_cuda(img, m, seeded, conn)
    if bool(busy.any()):
        raise AssertionError("the basins' phase 1 did not converge")
    seg, inc, conv = basin_segments(cost, img, m, seeded, conn)
    below = (m & ~seeded & (inc == 0) & (cost < _INF)).cpu().numpy()
    B, H, W = below.shape
    ref = scipy_min_index(below.astype(np.uint8), background=0,
                          connectivity=4 if conn == 1 else 8)
    lin = np.arange(H * W, dtype=np.int32).reshape(H, W)
    want = np.where(below, ref, lin) + (np.arange(B, dtype=np.int32) * (H * W))[:, None, None]
    if not bool(conv.all()) or not np.array_equal(seg.cpu().numpy(), want):
        raise AssertionError("the card's basin segments differ from scipy's")
    roots = (ref + (np.arange(B) * (H * W))[:, None, None])[below]
    sizes = np.unique(roots, return_counts=True)[1]
    return int(sizes.size), int(sizes.sum()), int(sizes.max(initial=0))


def tunnel_quality(dev) -> dict:
    """Boundary IoU against the port's oracle priority flood, the card's
    default and tunnelled labels: refine on bench.py's 512² relief (smooth
    and 16 levels; the tunnel may not lose more than 0.005), and the
    watershed on ``sparse_seeds`` (the tunnel must gain 0.2)."""
    import numpy as np
    import torch
    from scipy import ndimage as ndi

    from particle_col_image_segmentation_tpu_torch.config import RefineConfig
    from particle_col_image_segmentation_tpu_torch.models.refine import refine_boundaries
    from particle_col_image_segmentation_tpu_torch.ops import watershed, watershed_auto
    from particle_col_image_segmentation_tpu_torch.oracle import ndimage as ond
    from particle_col_image_segmentation_tpu_torch.utils.metrics import boundary_iou

    out = {}
    prob = refine_relief(512, 30)  # bench.py's config #3 relief, the same draws
    for name, p in (("512 smooth", prob), ("512 16-level", quantize16(prob))):
        binary = p < 0.5
        omark = ond.label(ond.local_maxima(ndi.distance_transform_edt(binary)).astype(np.uint8))
        oref = ond.watershed(p, omark, mask=binary)
        iou = {tun: boundary_iou(refine_boundaries(p, RefineConfig(tunnel_basins=tun),
                                                   device=dev).labels, oref)
               for tun in (False, True)}
        if iou[True] < iou[False] - 0.005:
            raise AssertionError(f"phase 12 {name}: the tunnel loses boundary IoU: {iou}")
        out[name] = {"default": iou[False], "tunnel": iou[True]}
    q, mk = sparse_seeds()
    orc = ond.watershed(q, mk)
    x, xm = torch.from_numpy(q).to(dev), torch.from_numpy(mk).to(dev)
    base = watershed_auto(x, xm, max_iters=4096).cpu().numpy()
    tun, conv = watershed_auto(x, xm, max_iters=4096, with_flag=True, tunnel_basins=True)
    want, wconv = watershed(x.cpu(), xm.cpu(), max_iters=4096, with_flag=True, tunnel_basins=True)
    if not (bool(conv) and bool(wconv)) or not torch.equal(tun.cpu(), want):
        raise AssertionError("phase 12: the sparse-seed tunnel differs from the plain CPU run")
    iou = {False: boundary_iou(base, orc), True: boundary_iou(tun.cpu().numpy(), orc)}
    if iou[True] < iou[False] + 0.2:
        raise AssertionError(f"phase 12 sparse seeds: the tunnel gains too little: {iou}")
    out["128 8-level sparse seeds"] = {"default": iou[False], "tunnel": iou[True]}
    return out


def tunnel_phase(card: str, dev, stack8, reset_counts, read_counts) -> tuple:
    """Phase 12: refine_boundaries_stack with ``tunnel_basins=True`` on the
    [8,2048,2048] relief, smooth and at 16 levels (launch counts reset just
    before each run: K2, K3, K7, K9 and K10 must launch, K11 must not);
    labels, cell counts, areas and centroids equal to the plain run on the
    card on every plane where it converged; every plane's basins equal to
    scipy's; the boundary IoU checks (``tunnel_quality``); CUDA-event times
    and peak device memory; the ``refine --tunnel-basins`` verb where h5py
    imports.  Returns (launch counts summed over both runs, record)."""
    import numpy as np
    import torch

    from particle_col_image_segmentation_tpu_torch.config import RefineConfig
    from particle_col_image_segmentation_tpu_torch.models.refine import (
        refine_boundaries_stack,
        refine_plane_device,
        write_refine_stack_csv,
    )
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        centroids_f64,
        connected_components,
    )
    from particle_col_image_segmentation_tpu_torch.ops.watershed import (
        _segment_broadcast,
        basin_segments,
        claim_labels,
    )
    from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
        _BIG_LAB,
        _INF,
        minimax_costs_cuda,
    )

    tcfg = RefineConfig(tunnel_basins=True)
    t_phase = time.perf_counter()
    launches, record = {}, {"reliefs": {}}
    for name, arr in (("smooth", stack8), ("16-level", quantize16(stack8))):
        shape = f"[{arr.shape[0]},{H},{W}] {name}"
        reset_counts()
        t0 = time.perf_counter()
        results = refine_boundaries_stack(arr, tcfg, REFINE_REGIONS, device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        got = read_counts()
        steps = claim_labels.last_steps
        if any(got[k] <= 0 for k in ("K2", "K3", "K7", "K9", "K10")) or got["K11"] != 0:
            raise AssertionError(f"phase 12 {shape}: the tunnelled path launched {got}")
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}

        # the plain run on the card, compared where it converged
        x = torch.from_numpy(arr).to(dev)
        t0 = time.perf_counter()
        p_labels, p_num, p_table, p_conv = plain_refine(x, tcfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        host = type(p_table)(*(t.cpu().numpy() for t in p_table))
        cy, cx = centroids_f64(host)
        compared = []
        for z in range(arr.shape[0]):
            if not bool(p_conv[z]):
                continue
            r, n = results[z], int(p_num[z])
            if (r.num_cells != n or not np.array_equal(r.labels, p_labels[z].cpu().numpy())
                    or not np.array_equal(r.areas, host.area[z][1:n + 1])
                    or not np.array_equal(r.centroids, np.stack([cy[z], cx[z]], 1)[1:n + 1])):
                raise AssertionError(f"phase 12 {shape} plane {z}: differs from plain")
            compared.append(z)
        del p_labels, p_table
        # every plane's basins against scipy's, on the markers refine seeds
        mask = x < tcfg.boundary_threshold
        markers = refine_plane_device(x, RefineConfig(), REFINE_REGIONS)[1]  # key-independent
        basins = basins_vs_scipy(x, markers, mask, 1)
        log(f"phase 12 tunnel {shape}: refine_boundaries_stack {wall_s:.2f} s wall [{card}], "
            f"{steps} phase-2 steps, launches {got}; == plain on the card on planes {compared} "
            f"(plain {plain_s:.1f} s); basins == scipy's: "
            f"{basins[0]} basins, {basins[1]} px, largest {basins[2]} px; cells a plane "
            f"{[r.num_cells for r in results]}")
        if not compared:
            raise AssertionError(f"phase 12 {shape}: the plain run converged on no plane")

        # times by CUDA events
        seeded = (markers > 0) & mask
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        refine_plane_device(x, tcfg, REFINE_REGIONS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        t = {"refine_ms": time_ms(lambda: refine_plane_device(x, tcfg, REFINE_REGIONS), reps=2),
             "default_refine_ms": time_ms(lambda: refine_plane_device(x, RefineConfig(),
                                                                       REFINE_REGIONS), reps=2)}
        cost = minimax_costs_cuda(x, mask, seeded)[0]
        t["basins_ms"] = time_ms(lambda: basin_segments(cost, x, mask, seeded), reps=3)
        seg, inc, _ = basin_segments(cost, x, mask, seeded)
        below = (mask & ~seeded & (inc == 0) & (cost < _INF)).int()
        t["basin_k2_ms"] = time_ms(lambda: ccl_cuda(below, background=0, connectivity=4), reps=5)
        t["basin_plain_ms"] = time_ms(lambda: connected_components(
            below, background=0, connectivity=4, num_classes=2), reps=1, warmup=0)
        t["basin_k2_bound_ms"] = 8 * x.numel() / HBM_BYTES_PER_S * 1e3  # int32 in, int32 out
        t["phase2_ms"] = time_ms(lambda: claim_labels(cost, x, markers, mask, seeded,
                                                      max_iters=tcfg.watershed_max_iters,
                                                      basins=(seg, inc)), reps=1)
        t["phase2_steps"] = claim_labels.last_steps
        t["ms_a_step"] = t["phase2_ms"] / t["phase2_steps"]
        # a step's least traffic: cost, img, eimg, lab, dist, markers, seg,
        # inc (4 B each) and the mask and seed flags (1 B each) read once,
        # lab, dist and eimg (4 B each) written once
        t["step_bound_ms"] = 46 * x.numel() / HBM_BYTES_PER_S * 1e3
        seg_flat = seg.reshape(-1).to(torch.int64)
        claims = (torch.zeros_like(seg), cost, x, torch.where(seeded, markers, _BIG_LAB))
        t["broadcast_ms"] = time_ms(lambda: _segment_broadcast(seg_flat, *claims), reps=5)
        del seg_flat, claims
        t.update(wall_s=wall_s, plain_s=plain_s, peak_gib=peak / 2**30,
                 planes_equal_to_plain=compared, basins=basins[0], basin_px=basins[1],
                 largest_basin_px=basins[2])
        record["reliefs"][name] = t
        log(f"phase 12 times [{card}] {shape}: tunnelled refine_plane_device "
            f"{t['refine_ms']:.3f} ms (default {t['default_refine_ms']:.3f}); phase 2 "
            f"{t['phase2_ms']:.3f} ms, {t['phase2_steps']} steps, {t['ms_a_step']:.3f} ms a "
            f"step (bound {t['step_bound_ms']:.3f}; its segment broadcast alone "
            f"{t['broadcast_ms']:.3f}); basin segments {t['basins_ms']:.3f} ms (K2 alone "
            f"{t['basin_k2_ms']:.3f}, bound {t['basin_k2_bound_ms']:.3f}, plain "
            f"{t['basin_plain_ms']:.3f}); peak device memory {t['peak_gib']:.3f} GiB above "
            f"the input")
        del x, mask, markers, seeded, cost, seg, inc, below
        torch.cuda.empty_cache()

    record["boundary_iou"] = tunnel_quality(dev)
    for k, v in record["boundary_iou"].items():
        log(f"phase 12 boundary IoU against the port's oracle, {k}: default {v['default']:.4f}, "
            f"tunnel {v['tunnel']:.4f}")

    if "does not import" in imports("h5py"):
        log("phase 12 refine --tunnel-basins verb: skipped (h5py does not import here)")
    else:
        import h5py

        crop = np.ascontiguousarray(quantize16(stack8[:2, :512, :512]))
        with tempfile.TemporaryDirectory(prefix="pcis_tunnel_") as tmp:
            src, card_csv = os.path.join(tmp, "probs.h5"), os.path.join(tmp, "card.csv")
            with h5py.File(src, "w") as f:
                f.create_dataset("exported_data", data=crop)
            run_verbs(["refine", src, "--stack", "--tunnel-basins", "--csv", card_csv])
            cpu_csv = os.path.join(tmp, "cpu.csv")
            write_refine_stack_csv(refine_boundaries_stack(crop, tcfg, device="cpu"), cpu_csv)
            with open(card_csv, "rb") as a, open(cpu_csv, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError("phase 12: the verb's CSV differs from the plain "
                                         "CPU run's")
        log("phase 12 refine --tunnel-basins verb (fresh interpreter, --device defaulting to "
            "cuda): exit 0, CSV == the plain CPU run's")
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 tunnel: {record['phase_s']:.1f} s wall")
    return launches, record


def launch_counters() -> tuple:
    """(reset_counts, read_counts) over every kernel wrapper's launch count,
    K1-K11: reset just before a path runs, read just after."""
    from particle_col_image_segmentation_tpu_torch import ops
    from particle_col_image_segmentation_tpu_torch.ops import watershed_tiles as wt

    counters = {
        "K1": [ops.median_label_filter_cuda, ops.median_label_filter_rows_padded_cuda],
        "K2": [ops.ccl_cuda],
        "K3": [ops.compact_labels_cuda], "K4": [ops.region_counts_cuda, ops.region_sums_cuda],
        "K5": [ops.region_table_cuda], "K6": [ops.table_lookup_cuda],
        "K7": [ops.centroid_sums_cuda], "K8": [ops.particle_fill_step_cuda],
        "K9": [ops.edt_sq_cuda], "K10": [wt.watershed_cost_pass_cuda],
        "K11": [wt.watershed_label_pass_cuda],
    }

    def reset_counts() -> None:
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0

    def read_counts() -> dict:
        return {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}

    return reset_counts, read_counts


# ---- the data axis (phase 13) ----------------------------------------------

def median_wall_s(fn, reps: int = 3) -> tuple:
    """(median wall seconds of fn() over reps runs, a sync after each; the
    last run's result)."""
    import statistics

    import torch

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), out


def same_refine(got, want, case: str, phase: int = 13) -> None:
    """Per-plane RefineResults equal at tolerance 0 (labels, counts, areas,
    centroids, nearest-neighbour distances)."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"phase {phase} {case}: {len(got)} planes, expected {len(want)}")
    for z, (g, w) in enumerate(zip(got, want)):
        if (g.num_cells != w.num_cells or not np.array_equal(g.labels, w.labels)
                or not np.array_equal(g.areas, w.areas)
                or not np.array_equal(g.centroids, w.centroids)
                or not np.array_equal(g.nn_distances, w.nn_distances)):
            raise AssertionError(f"phase {phase} {case} plane {z}: differs from "
                                 "refine_boundaries_stack")


def data_axis_phase(card: str, dev, planes, stats, stack8, results8, cfg, rcfg,
                    reset_counts, read_counts) -> tuple:
    """Phase 13: the data axis on emulated meshes (``cuda:0`` named 2 and 4
    times: the real split, workers, kernels and gather on one card) and, where
    the machine has more than one card, on all of them.  run_batch over phase
    4's 40 planes must give phase 4's stats at tolerance 0 with K1-K4 launched
    k times a batch; ``batch --data-parallel 1`` through the CLI must write
    the CSV of ``batch`` without the flag; refine_boundaries_sharded of phase
    8's relief (and, tunnelled, of its first two planes) must equal
    refine_boundaries_stack on the card, with K9, K2, K3, K10, K11 and K7
    launched; ``_check_tunnel_chunk_fits`` passes for that chunk and raises
    for 16 planes of 16384².  Times: run_batch MP/s for 1, 2 and 4 mesh
    positions (median of 3 walls), the refine data axis's wall against
    refine_boundaries_stack's, peak device memory.  Returns (launch counts of
    the mesh runs, record)."""
    import contextlib
    import io
    from unittest import mock

    import numpy as np
    import torch

    from particle_col_image_segmentation_tpu_torch import cli
    from particle_col_image_segmentation_tpu_torch.config import RefineConfig
    from particle_col_image_segmentation_tpu_torch.io import hdf5
    from particle_col_image_segmentation_tpu_torch.models.batch import run_batch
    from particle_col_image_segmentation_tpu_torch.models.refine import (
        _check_tunnel_chunk_fits,
        refine_boundaries_sharded,
        refine_boundaries_stack,
    )
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    paths = [str(i) for i in range(len(planes))]
    n_batches = -(-len(planes) // BATCH)
    mp = len(planes) * H * W / 1e6
    launches, record = {}, {"card": card, "cards": torch.cuda.device_count(), "batch": {}}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    def batch_on(name, mesh):
        kw = dict(batch_size=BATCH, particle_val=2, cell_vals=(1,))
        if mesh is None:
            kw["device"] = dev
        else:
            kw["mesh"] = mesh
        used = sorted({d.index for d in (mesh.flat if mesh is not None else [dev])})
        base = {}
        for c in used:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
            base[c] = torch.cuda.memory_allocated(c)
        reset_counts()
        got = dict(run_batch(paths, lambda p: planes[int(p)], cfg, **kw))
        counts = read_counts()
        peak = []
        for c in used:  # GiB above what the card held before, a card
            torch.cuda.synchronize(c)
            peak.append((torch.cuda.max_memory_allocated(c) - base[c]) / 2**30)
        k = 1 if mesh is None else len(mesh.flat)
        if mesh is not None:
            add(counts)
        for key in ("K1", "K2", "K3", "K4"):
            if counts[key] != k * n_batches:
                raise AssertionError(f"phase 13 batch {name}: {key} launched {counts[key]} "
                                     f"times, expected {k} x {n_batches} batches")
        if list(got) != paths:
            raise AssertionError(f"phase 13 batch {name}: yielded {list(got)[:5]}...")
        for p in paths:
            g, w = got[p], stats[p]
            if ((g.num_regions, g.particle_px, g.cell_px, g.overflow, g.converged)
                    != (w.num_regions, w.particle_px, w.cell_px, w.overflow, w.converged)
                    or not np.array_equal(g.class_px, w.class_px)):
                raise AssertionError(f"phase 13 batch {name} plane {p}: {g} != phase 4's {w}")
        wall, _ = median_wall_s(lambda: list(run_batch(paths, lambda p: planes[int(p)], cfg,
                                                         **kw)))
        record["batch"][name] = {"mps": mp / wall, "wall_s": wall, "peak_gib": peak,
                                 "launches": counts}
        log(f"phase 13 batch {name} [{card}]: run_batch over {len(planes)} planes of {H}x{W}, "
            f"batches of {BATCH}: stats == phase 4's (tolerance 0); launches {counts}; "
            f"{mp / wall:.1f} MP/s (median of 3 walls, {wall:.3f} s); peak device memory "
            f"{[round(p, 3) for p in peak]} GiB above what was allocated before, a card")

    batch_on("one device", None)
    for k in (2, 4):
        batch_on(f"cuda:0 x{k}", make_mesh(n_data=k, devices=[dev] * k))
    cards = torch.cuda.device_count()
    if cards > 1:  # every card that divides the batch
        n = max(d for d in range(1, cards + 1) if BATCH % d == 0)
        batch_on(f"{n} cards", make_mesh(n_data=n))

    # the batch verb with and without --data-parallel 1, reading the planes
    # through a stand-in for the HDF5 decode (the card's machine has no h5py)
    with tempfile.TemporaryDirectory(prefix="pcis_dp_") as tmp:
        seed_of = make_tree(os.path.join(tmp, "tree"), range(8))
        outs = {}
        with mock.patch.object(hdf5, "load_h5_plane",
                               lambda path, key=None: planes[seed_of[path]]):
            for name, flags in (("single", []), ("dp1", ["--data-parallel", "1"])):
                csv_path = os.path.join(tmp, f"{name}.csv")
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    rc = cli.main(["batch", os.path.join(tmp, "tree"), "--csv", csv_path,
                                   *flags])
                with open(csv_path, "rb") as f:
                    outs[name] = (rc, printed.getvalue(), f.read())
    if outs["single"] != outs["dp1"] or outs["single"][0] != 0 or \
            outs["single"][2].count(b",ok") != len(seed_of):
        raise AssertionError("phase 13: batch --data-parallel 1 differs from batch")
    log(f"phase 13 batch verb: --data-parallel 1 (the mesh path on one card) == without the "
        f"flag: exit 0, printed lines and CSV ({len(seed_of)} planes) byte for byte")

    # refine on the data axis against refine_boundaries_stack on the card
    def refine_on(name, mesh):
        reset_counts()
        got = refine_boundaries_sharded(stack8, rcfg, REFINE_REGIONS, mesh=mesh, stack=True)
        torch.cuda.synchronize()
        counts = read_counts()
        add(counts)
        for key in ("K2", "K3", "K7", "K9", "K10", "K11"):
            if counts[key] <= 0:
                raise AssertionError(f"phase 13 refine {name}: {key} was never launched")
        same_refine(got, results8, f"refine {name}")
        wall, _ = median_wall_s(lambda: refine_boundaries_sharded(
            stack8, rcfg, REFINE_REGIONS, mesh=mesh, stack=True))
        record[f"refine {name}"] = {"wall_ms": wall * 1e3, "launches": counts}
        log(f"phase 13 refine {name} [{card}]: refine_boundaries_sharded over "
            f"[{REFINE_PLANES},{H},{W}] == refine_boundaries_stack on the card (labels, cells, "
            f"areas, centroids, NN distances); launches {counts}; {wall * 1e3:.1f} ms wall "
            f"(median of 3)")

    stack_ms = median_wall_s(lambda: refine_boundaries_stack(stack8, rcfg, REFINE_REGIONS,
                                                             device=dev))[0] * 1e3
    record["refine_boundaries_stack_wall_ms"] = stack_ms
    log(f"phase 13 refine [{card}]: refine_boundaries_stack over [{REFINE_PLANES},{H},{W}] "
        f"{stack_ms:.1f} ms wall (median of 3)")
    refine_on("cuda:0 x2", make_mesh(n_data=2, devices=[dev] * 2))
    if torch.cuda.device_count() > 1:
        refine_on(f"{torch.cuda.device_count()} cards", make_mesh())

    # the tunnelled data axis: n_space = 2 routes data-parallel
    tcfg = RefineConfig(tunnel_basins=True)
    two = np.ascontiguousarray(stack8[:2])
    _check_tunnel_chunk_fits((H, W), 1, dev)
    try:
        _check_tunnel_chunk_fits((16384, 16384), 16, dev)
    except ValueError as e:
        if "exceeds one device" not in str(e):
            raise
    else:
        raise AssertionError("phase 13: a 16-plane 16384² tunnel chunk passed the size check")
    t0 = time.perf_counter()
    want = refine_boundaries_stack(two, tcfg, REFINE_REGIONS, device=dev)
    torch.cuda.synchronize()
    record["tunnel_stack_wall_ms"] = (time.perf_counter() - t0) * 1e3

    def tunnel_on(name, mesh):
        reset_counts()
        t0 = time.perf_counter()
        got = refine_boundaries_sharded(two, tcfg, REFINE_REGIONS, mesh=mesh, stack=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        add(counts)
        if any(counts[k] <= 0 for k in ("K2", "K3", "K7", "K9", "K10")) or counts["K11"] != 0:
            raise AssertionError(f"phase 13 tunnel {name}: launched {counts}")
        same_refine(got, want, f"tunnel {name}")
        record[f"tunnel {name}"] = {"wall_ms": wall_s * 1e3, "launches": counts}
        log(f"phase 13 tunnel {name} [{card}]: refine_boundaries_sharded(tunnel_basins=True) "
            f"of [2,{H},{W}], n_space=2 (data-parallel) == refine_boundaries_stack("
            f"tunnel_basins=True); launches {counts}; {wall_s * 1e3:.1f} ms wall (stack "
            f"{record['tunnel_stack_wall_ms']:.1f})")

    tunnel_on("cuda:0 x2", make_mesh(n_data=1, n_space=2, devices=[dev] * 2))
    if cards > 1:
        tunnel_on("2 cards", make_mesh(n_data=1, n_space=2))
    log(f"phase 13 tunnel: _check_tunnel_chunk_fits passes (2048², 1) and raises for "
        f"(16384², 16) on {torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f} GiB")
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 data axis: {record['phase_s']:.1f} s wall")
    return launches, record


# ---- the space axis: the band modes (phase 3) and the paths (phase 14) -----

def band_checks(x, n_space: int, compare, case: str, max_regions: int = ANALYZE_REGIONS) -> None:
    """The band modes of K1, K5 and K8 against their plain versions on the
    card, at tolerance 0.  ``x`` [B,H,W] uint8 on the card is cut into
    ``n_space`` row bands and each is padded as ``parallel.sharded`` pads
    it: neighbour rows inside the plane, reflected (K1) or constant (K8)
    rows at its edges.  K1 reads the row-padded band, K5 tables each band
    in the plane's rows (its sums too), K8 fills the cap-padded band
    counting its own rows, on both of its routes.  K3 has no band mode: it
    ranks each band's own roots, and the offsets and seam-crossing roots
    reach the pixels through K6's rank tables (phase 14)."""
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        compact_labels_cuda,
        max_fused_cap,
        median_label_filter_cuda,
        particle_fill_step,
        particle_fill_step_cuda,
        region_props,
        region_table_cuda,
    )
    from particle_col_image_segmentation_tpu_torch.ops.filters import (
        median_label_filter_rows_padded,
    )
    from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import (
        median_label_filter_rows_padded_cuda,
    )
    from particle_col_image_segmentation_tpu_torch.parallel.halo import pad_with_halo
    from particle_col_image_segmentation_tpu_torch.parallel.sharded import _neutral_value

    h = x.shape[-2] // n_space

    def cut(t):
        return [t[:, j * h:(j + 1) * h].contiguous() for j in range(n_space)]

    for j, xp in enumerate(pad_with_halo(cut(x), 2, "symmetric")):
        compare("K1", f"{case} band {j} of {n_space}, 2 halo rows",
                [median_label_filter_rows_padded_cuda(xp, 5, 8)],
                [median_label_filter_rows_padded(xp, 5, 8)])
    den = median_label_filter_cuda(x, 5, 8)
    seg, _ = compact_labels_cuda(ccl_cuda(den), max_regions)
    for j, (s, d) in enumerate(zip(cut(seg), cut(den))):
        got, got_sums = region_table_cuda(s, d, max_regions, row_offset=j * h, with_sums=True)
        want, want_sums = region_props(s, d, max_regions, row_offset=j * h, with_sums=True)
        compare("K5", f"{case} band {j} of {n_space}, row_offset {j * h}",
                list(got) + [got_sums], list(want) + [want_sums])
    far = (1 << 20) + 77  # rows whose base-128 digits carry within the band
    got, got_sums = region_table_cuda(cut(seg)[-1], cut(den)[-1], max_regions, far, True)
    want, want_sums = region_props(cut(seg)[-1], cut(den)[-1], max_regions, far, True)
    compare("K5", f"{case} last band, row_offset {far}", list(got) + [got_sums],
            list(want) + [want_sums])
    neutral = _neutral_value(2, (1,))
    for cap, dt2, dr2 in ((20, 4, 400), (max_fused_cap() + 1, 9, 4)):
        for j, xp in enumerate(pad_with_halo(cut(den), cap, "constant", neutral)):
            params = (2, 1, cap, dt2, dr2)
            compare("K8", f"{case} band {j} of {n_space}, {cap} halo rows {params}",
                    list(particle_fill_step_cuda(xp, *params, count_rows=(cap, cap + h))),
                    list(particle_fill_step(xp, *params, count_rows=(cap, cap + h))))


@contextlib.contextmanager
def stage_workers(workers: bool):
    """Run ``parallel.sharded``'s band stages through a worker thread a
    position (True) or one after another in the caller's thread (False),
    whatever devices the mesh names; the module picks by itself otherwise."""
    import torch

    from particle_col_image_segmentation_tpu_torch.parallel import mesh, sharded

    real = sharded._each

    def each(fn, devices, args):
        if workers:
            return mesh.run_per_device(fn, devices, args)
        out = []
        for d, a in zip(devices, args):
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                out.append(fn(*a))
        return out

    sharded._each = each
    try:
        yield
    finally:
        sharded._each = real


def space_axis_phase(card: str, dev, planes, stats, cfg, acfg, analyze_csv,
                     reset_counts, read_counts) -> tuple:
    """Phase 14: the space axis on emulated meshes (``cuda:0`` named 2 and
    4 times: the real band split, halo copies, worker threads, kernels and
    host seam joins on one card).  run_batch over phase 4's 40 planes on
    1x2, 1x4 and 2x2 meshes must give phase 4's stats at tolerance 0;
    analyze_plane_device_sharded of 2048² planes at n_space 2 and 4, and of
    one [8192,2048] plane at n_space 4, must equal analyze_plane_device on
    the card field for field; run_analysis with a 1x4 mesh over phase 6's
    single-file and RFP+DAPI folders must write phase 6's CSVs byte for
    byte.  Times: each run's wall, its launches, the card's peak above what
    it held before (all positions share it), one position's working set
    (the same step on one band alone), the seam joins' host time; the 1x4
    batch once more through a worker thread a position (the route of a
    mesh over several cards).  Returns (launch counts of the space runs,
    record)."""
    import numpy as np
    import torch

    from particle_col_image_segmentation_tpu_torch.labels.analysis import (
        analyze_plane_device,
        analyze_plane_device_sharded,
    )
    from particle_col_image_segmentation_tpu_torch.models.batch import run_batch
    from particle_col_image_segmentation_tpu_torch.models.experiment import run_analysis
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh, sharded

    import scipy.sparse.csgraph  # noqa: F401  (the seam join's; not inside the first wall)

    t_phase = time.perf_counter()
    paths = [str(i) for i in range(len(planes))]
    launches = {}
    record = {"card": card, "batch": {}, "analyze_plane": {}}
    join_s = [0.0]
    real_join = sharded._join_seams

    def timed_join(*a, **kw):
        t0 = time.perf_counter()
        out = real_join(*a, **kw)
        join_s[0] += time.perf_counter() - t0
        return out

    def run(fn, count=True):
        """(result, wall s, launches, peak GiB above the start, seam join s)"""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        join_s[0] = 0.0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        if count:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        return out, wall, counts, (torch.cuda.max_memory_allocated(dev) - base) / 2**30, join_s[0]

    def emulated(n_data, n_space):
        return make_mesh(n_data=n_data, n_space=n_space, devices=[dev] * (n_data * n_space))

    sharded._join_seams = timed_join
    try:
        kw = dict(batch_size=BATCH, particle_val=2, cell_vals=(1,))
        _, wall1, _, peak1, _ = run(lambda: list(run_batch(paths, lambda p: planes[int(p)], cfg,
                                                           device=dev, **kw)), count=False)
        record["batch"]["one device"] = {"wall_s": wall1, "peak_gib": peak1}
        log(f"phase 14 batch one device [{card}]: run_batch over {len(planes)} planes of "
            f"{H}x{W}: {wall1:.3f} s wall, peak {peak1:.3f} GiB")
        for (nd, ns), workers in (((1, 2), False), ((1, 4), False), ((2, 2), False),
                                  ((1, 4), True)):
            name = f"{nd}x{ns}" + (" workers" if workers else "")
            with stage_workers(workers):
                got, wall, counts, peak, seam = run(lambda: dict(run_batch(
                    paths, lambda p: planes[int(p)], cfg, mesh=emulated(nd, ns), **kw)))
            for key in ("K1", "K2", "K3", "K4", "K6"):
                if counts[key] <= 0:
                    raise AssertionError(f"phase 14 batch {name}: {key} was never launched")
            if list(got) != paths:
                raise AssertionError(f"phase 14 batch {name}: yielded {list(got)[:5]}...")
            for p in paths:
                g, w = got[p], stats[p]
                if ((g.num_regions, g.particle_px, g.cell_px, g.overflow, g.converged)
                        != (w.num_regions, w.particle_px, w.cell_px, w.overflow, w.converged)
                        or not np.array_equal(g.class_px, w.class_px)):
                    raise AssertionError(f"phase 14 batch {name} plane {p}: {g} != phase 4's {w}")
            # one position's working set: the same step on one band alone
            band = torch.from_numpy(np.stack(planes[:BATCH // nd])[:, :H // ns]).to(dev)
            _, _, _, band_peak, _ = run(lambda: sharded.shard_rows(
                [band], make_mesh(1, 1, devices=[dev]), cfg, 2, (1,), tables="counts",
                need_lab=False, need_fill=False), count=False)
            record["batch"][name] = {"wall_s": wall, "mps": len(planes) * H * W / 1e6 / wall,
                                     "launches": counts, "peak_gib": peak,
                                     "position_peak_gib": band_peak, "seam_join_s": seam}
            log(f"phase 14 batch {name} [{card}]: run_batch == phase 4's stats (tolerance 0); "
                f"{wall:.3f} s wall ({len(planes) * H * W / 1e6 / wall:.1f} MP/s; one device "
                f"{wall1:.3f}); launches {counts}; seam joins {seam * 1e3:.1f} ms on the host; "
                f"peak {peak:.3f} GiB on the card for all positions, {band_peak:.3f} GiB for one "
                f"position's [{BATCH // nd},{H // ns},{W}] band alone (one device {peak1:.3f})")

        def same_out(got, want, case):
            for name, g, w in zip(got._fields, got, want, strict=True):
                gs = list(g) if name == "table" else [g]
                ws = list(w) if name == "table" else [w]
                for gg, ww in zip(gs, ws, strict=True):
                    if gg.shape != ww.shape or gg.dtype != ww.dtype or not torch.equal(gg, ww):
                        raise AssertionError(f"phase 14 {case}: field {name} differs")

        tall_cfg = dataclasses.replace(acfg, max_regions=65535)
        tall = np.ascontiguousarray(np.concatenate(planes[:4], axis=0))
        for case, img, ns, c in (("plane 0", planes[0], 2, acfg), ("plane 0", planes[0], 4, acfg),
                                 (f"tall [{4 * H},{W}]", tall, 4, tall_cfg)):
            x = torch.from_numpy(img).to(dev)
            want, wall1, _, peak1, _ = run(lambda: analyze_plane_device(x, SINGLE, c), count=False)
            got, wall, counts, peak, seam = run(
                lambda: analyze_plane_device_sharded(x, SINGLE, c, emulated(1, ns)))
            same_out(got, want, f"{case} n_space={ns}")
            for key in ("K1", "K2", "K3", "K5", "K6", "K8", "K9"):
                if counts[key] <= 0:
                    raise AssertionError(f"phase 14 {case} n_space={ns}: {key} was never launched")
            h = img.shape[0] // ns
            _, _, _, band_peak, _ = run(lambda: sharded.shard_rows(
                [x[None, :h]], make_mesh(1, 1, devices=[dev]), c, 2, (1,), tables="full",
                with_merge=True, need_lab=False), count=False)
            record["analyze_plane"][f"{case} n_space={ns}"] = {
                "wall_ms": wall * 1e3, "one_device_wall_ms": wall1 * 1e3, "launches": counts,
                "peak_gib": peak, "position_peak_gib": band_peak, "one_device_peak_gib": peak1,
                "seam_join_ms": seam * 1e3, "regions": int(want.num)}
            log(f"phase 14 analyze_plane_device_sharded {case} n_space={ns} [{card}]: every "
                f"PlaneDeviceOut field == analyze_plane_device ({int(want.num)} regions); "
                f"{wall * 1e3:.1f} ms wall (one device {wall1 * 1e3:.1f}); launches {counts}; "
                f"seam joins {seam * 1e3:.1f} ms; peak {peak:.3f} GiB for all positions, "
                f"{band_peak:.3f} GiB for one [{h},{W}] band alone, one device {peak1:.3f} GiB")

        seed_of = {}
        with tempfile.TemporaryDirectory(prefix="pcis_space_") as tmp:
            root = os.path.join(tmp, "tree")
            seed_of.update(make_tree(root, [0]))
            _, wall, counts, peak, seam = run(lambda: run_analysis(
                root, acfg, make_figures=False, mesh=emulated(1, 4),
                load_fn=lambda p: planes[seed_of[p]]))
            for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K8", "K9"):
                if counts[key] <= 0:
                    raise AssertionError(f"phase 14 run_analysis: {key} was never launched")
            got_csv = csv_lines(root)
        for rel, got_lines in got_csv.items():
            want_lines = analyze_csv[rel]
            if rel.endswith("_cell_density_info.csv"):  # phase 6 wrote more folders' rows
                keys = {r.split(b",")[0] for r in got_lines[1:]}
                want_lines = want_lines[:1] + [r for r in want_lines[1:]
                                               if r.split(b",")[0] in keys]
            if got_lines != want_lines or len(got_lines) < 2:
                raise AssertionError(f"phase 14 run_analysis: {rel} differs from phase 6's")
        record["run_analysis"] = {"wall_s": wall, "launches": counts, "peak_gib": peak,
                                  "seam_join_s": seam, "csvs": len(got_csv)}
        log(f"phase 14 run_analysis 1x4 [{card}]: folder 0 and the RFP+DAPI folder (dedup, "
            f"fusion, merged re-analysis on bands): {len(got_csv)} CSVs == phase 6's byte for "
            f"byte; {wall:.2f} s wall; launches {counts}; seam joins {seam * 1e3:.1f} ms")
    finally:
        sharded._join_seams = real_join
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14 space axis: {record['phase_s']:.1f} s wall")
    return launches, record


# ---- the spatial refine: the band modes (phase 3) and the path (phase 15) ----

def tall_relief(h: int = 4 * H, w: int = W, pairs: int = 1600, seed: int = 3):
    """``refine_relief``'s touching-cell pairs on an [h, w] plane: the space
    axis's own case, a plane taller than one 2048² plane, with cells across
    every band seam."""
    import numpy as np
    from scipy import ndimage as ndi

    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), bool)
    for _ in range(pairs):
        cy, cx = int(rng.integers(40, h - 40)), int(rng.integers(40, w - 40))
        r2 = int(rng.integers(150, 400))
        dx2 = int(1.5 * np.sqrt(r2))
        r = int(np.ceil(np.sqrt(r2)))
        y0, y1, x0, x1 = max(cy - r, 0), min(cy + r + 1, h), max(cx - r, 0), min(cx + dx2 + r + 1, w)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        m[y0:y1, x0:x1] |= (((yy - cy) ** 2 + (xx - cx) ** 2 <= r2)
                            | ((yy - cy) ** 2 + (xx - cx - dx2) ** 2 <= r2))
    dist = ndi.distance_transform_edt(m)
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def deep_seam_relief(relief):
    """[2, H, W]: ``relief`` and its 17-column roll, each with a disc of
    radius 150 centred on row H/2 (the seam of two bands) whose depth is far
    past refine's probe cap, so K9's probe flags and the exact EDT runs."""
    import numpy as np

    out = np.stack([relief, np.roll(relief, 17, axis=1)])
    yy, xx = np.mgrid[:H, :W]
    d = np.sqrt((yy - H / 2) ** 2 + (xx - W / 3) ** 2)
    out[:, d <= 150] = np.minimum(out[:, d <= 150], (d[d <= 150] / 300.0).astype(np.float32))
    return out


def refine_band_checks(img, mk, m, labels, n_space: int, compare, case: str,
                       regions: int = REFINE_REGIONS, cap: int = 32) -> None:
    """The band modes of K7, K9, K10 and K11 against their plain versions on
    the card, at tolerance 0, on ``n_space`` row bands of [B,H,W] card
    tensors: K7 tables each band of ``labels`` in the plane's rows (and the
    last band at 2^20 + 77, whose digits carry); K9 transforms each band of
    the features ``img >= 0.5`` with ``cap`` halo rows, its flag raised by
    the band's own rows only; K10 and K11 resume each band of the relief
    ``img`` (markers ``mk``, mask ``m``) in every round of
    ``parallel.sharded``'s band-coupled watershed, each round's kernel
    output held to the plain band phase from the same state and halo rows.
    The loop's labels must equal the one-plane plain watershed's."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops import (
        centroid_sums,
        centroid_sums_cuda,
        edt_sq,
        edt_sq_cuda,
        watershed,
    )
    from particle_col_image_segmentation_tpu_torch.ops.watershed import (
        claim_labels_band,
        minimax_costs_band,
    )
    from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
        claim_labels_band_cuda,
        minimax_costs_band_cuda,
    )
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh, sharded
    from particle_col_image_segmentation_tpu_torch.parallel.halo import pad_with_halo

    h = img.shape[-2] // n_space

    def cut(t):
        return [t[:, j * h:(j + 1) * h].contiguous() for j in range(n_space)]

    for j, s in enumerate(cut(labels)):
        compare("K7", f"{case} band {j} of {n_space}, row_offset {j * h}",
                list(centroid_sums_cuda(s, regions, j * h)),
                list(centroid_sums(s, regions, j * h)))
    far = (1 << 20) + 77
    compare("K7", f"{case} last band, row_offset {far}",
            list(centroid_sums_cuda(cut(labels)[-1], regions, far)),
            list(centroid_sums(cut(labels)[-1], regions, far)))
    for j, fp in enumerate(pad_with_halo(cut(img >= 0.5), cap, "constant", False)):
        for c in (cap, 2):
            d, flag = edt_sq_cuda(fp, c, with_flag=True, flag_rows=(cap, cap + h))
            want = edt_sq(fp, c)
            compare("K9", f"{case} band {j} of {n_space}, {cap} halo rows, cap {c}, flag over "
                    f"its own rows", [d, (flag != 0).reshape(())],
                    [want, (want[:, cap:cap + h] > c * c).any()])
    rounds = {"K10": 0, "K11": 0}

    def checked(kernel, cuda_fn, plain_fn, n_state):
        def fn(*args):
            plain_args = [a.clone() if torch.is_tensor(a) else a for a in args]
            got = cuda_fn(*args)
            want = plain_fn(*plain_args)
            rounds[kernel] += 1
            compare(kernel, f"{case} band mode, band round {rounds[kernel]} ({got[-1].passes} "
                    f"passes)", list(got[:n_state + 2]), list(want[:n_state + 2]))
            return got
        return fn

    real = sharded.minimax_costs_band_auto, sharded.claim_labels_band_auto
    sharded.minimax_costs_band_auto = checked("K10", minimax_costs_band_cuda,
                                              minimax_costs_band, 1)
    sharded.claim_labels_band_auto = checked("K11", claim_labels_band_cuda,
                                             claim_labels_band, 3)
    try:
        mesh = make_mesh(1, n_space, devices=[img.device] * n_space)
        stats = {}
        # a budget the plain steps meet too: a corridor's flood takes a step a
        # pixel of its length there, a few passes in the kernels
        bands, conv = sharded._watershed_bands(
            sharded.split_bands(img, mesh), sharded.split_bands(mk, mesh),
            sharded.split_bands(m, mesh), mesh, 1, 1 << 14, stats)
    finally:
        sharded.minimax_costs_band_auto, sharded.claim_labels_band_auto = real
    want = watershed(img, mk, m, max_iters=1 << 14)
    if not bool(conv[0].all()) or not torch.equal(sharded.join_bands(bands, mesh), want):
        raise AssertionError(f"{case}: the band-coupled watershed differs from the plain one")
    log(f"phase 3 K10/K11 {case} band mode: {n_space} bands, phase 1 {stats['phase1']}, "
        f"phase 2 {stats['phase2']}; labels == the one-plane plain watershed")


def space_refine_phase(card: str, dev, stack8, results8, rcfg, reset_counts,
                       read_counts) -> tuple:
    """Phase 15: the spatial refine on emulated meshes (``cuda:0`` named 2 and
    4 times, the positions one after another in the caller's thread).
    refine_boundaries_sharded over phase 8's [8,2048²] relief on 1x2, 1x4
    and 2x2 must equal refine_boundaries_stack (phase 8's results) field
    for field, and its stack CSV phase 8's byte for byte; an [8192,2048]
    relief plane at n_space 4, and a [2,2048²] relief with a disc deeper
    than the probe cap across the seam (the exact-EDT fallback) at n_space
    2 and 4, must equal refine_plane_device on one device.  Times: each
    run's wall, each watershed phase's rounds, passes a round and host
    syncs, the launches of K2, K3, K6, K7, K9, K10 and K11, the card's peak
    above what it held before, and one position's working set (the sharded
    refine of one band alone), beside refine_boundaries_stack's (the stack)
    and refine_plane_device's (the planes) on one device.  Returns (launch
    counts of the space runs, record)."""
    import numpy as np
    import torch

    from particle_col_image_segmentation_tpu_torch.models.refine import (
        refine_boundaries_sharded,
        refine_boundaries_stack,
        refine_plane_device,
        write_refine_stack_csv,
    )
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh, sharded

    t_phase = time.perf_counter()
    launches, record = {}, {"card": card}
    ws_stats = []
    real_ws = sharded._watershed_bands

    def traced_ws(*a):
        out = real_ws(*a)
        ws_stats.append(a[-1])
        return out

    def run(fn, count=True):
        """(result, wall s, launches, peak GiB above the start, watershed stats)"""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        ws_stats.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        if count:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        stats = {k: v for k, v in (ws_stats[-1] if ws_stats else {}).items()}
        return out, wall, counts, (torch.cuda.max_memory_allocated(dev) - base) / 2**30, stats

    def emulated(n_data, n_space):
        return make_mesh(n_data=n_data, n_space=n_space, devices=[dev] * (n_data * n_space))

    def check_launches(counts, case):
        for key in ("K2", "K3", "K6", "K7", "K9", "K10", "K11"):
            if counts[key] <= 0:
                raise AssertionError(f"phase 15 {case}: {key} was never launched")

    def position_peak(x, n_data, n_space):
        """One position's working set: the sharded refine of its band alone."""
        band = x[:x.shape[0] // n_data, :x.shape[1] // n_space]
        fn = sharded.make_sharded_refine_fn(make_mesh(1, 1, devices=[dev]),
                                            max_regions=REFINE_REGIONS, with_tables=True)
        return run(lambda: fn(band), count=False)[3]

    sharded._watershed_bands = traced_ws
    try:
        with tempfile.TemporaryDirectory(prefix="pcis_space_refine_") as tmp:
            want_csv = os.path.join(tmp, "stack.csv")
            write_refine_stack_csv(results8, want_csv)
            with open(want_csv, "rb") as f:
                want_bytes = f.read()
            _, wall1, _, peak1, _ = run(lambda: refine_boundaries_stack(
                stack8, rcfg, REFINE_REGIONS, device=dev), count=False)
            record["stack"] = {"one_device_wall_s": wall1, "one_device_peak_gib": peak1}
            run(lambda: refine_boundaries_sharded(stack8, rcfg, REFINE_REGIONS,
                                                  mesh=emulated(1, 2), stack=True),
                count=False)  # warm-up: the band modes' and the seam join's first calls
            for nd, ns in ((1, 2), (1, 4), (2, 2)):
                name = f"{nd}x{ns}"
                got, wall, counts, peak, stats = run(lambda: refine_boundaries_sharded(
                    stack8, rcfg, REFINE_REGIONS, mesh=emulated(nd, ns), stack=True))
                same_refine(got, results8, f"refine {name}", phase=15)
                got_csv = os.path.join(tmp, f"{name}.csv")
                write_refine_stack_csv(got, got_csv)
                with open(got_csv, "rb") as f:
                    if f.read() != want_bytes:
                        raise AssertionError(f"phase 15 refine {name}: the stack CSV differs "
                                             "from phase 8's")
                check_launches(counts, f"refine {name}")
                band_peak = position_peak(torch.from_numpy(stack8).to(dev), nd, ns)
                record["stack"][name] = {"wall_s": wall, "launches": counts, "peak_gib": peak,
                                         "position_peak_gib": band_peak, "watershed": stats}
                log(f"phase 15 refine_boundaries_sharded {name} [{card}]: [{REFINE_PLANES},{H},"
                    f"{W}] == refine_boundaries_stack (phase 8) field for field, stack CSV "
                    f"byte for byte ({len(want_bytes.splitlines()) - 1} cells); {wall:.3f} s "
                    f"wall (one device refine_boundaries_stack {wall1:.3f}); watershed {stats}; "
                    f"launches {counts}; peak {peak:.3f} GiB for all positions, "
                    f"{band_peak:.3f} GiB for one position's band alone (one device "
                    f"{peak1:.3f})")
        for case, arr, spaces in (
                (f"tall [{4 * H},{W}]", tall_relief()[None], (4,)),
                (f"deep disc across the seam [2,{H},{W}]", deep_seam_relief(stack8[0]), (2, 4))):
            x = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
            want, wall1, _, peak1, _ = run(lambda: refine_plane_device(x, rcfg, REFINE_REGIONS),
                                           count=False)
            for ns in spaces:
                fn = sharded.make_sharded_refine_fn(
                    emulated(1, ns), max_regions=REFINE_REGIONS, max_iters=rcfg.watershed_max_iters,
                    with_tables=True, probe_cap=rcfg.edt_probe_cap)
                got, wall, counts, peak, stats = run(lambda: fn(x))
                labels, markers, num, conv, sums = got
                w_labels, w_markers, w_num, w_table, _, w_conv = want
                if not (bool(conv.all()) and bool(w_conv.all())):
                    raise AssertionError(f"phase 15 {case} n_space={ns}: not converged")
                for fld, g, w in (("labels", labels, w_labels), ("markers", markers, w_markers),
                                  ("num", num, w_num),
                                  *((f, sums[..., i], getattr(w_table, f)) for i, f in
                                    enumerate(("area", "sr_hi", "sr_lo", "sc_hi", "sc_lo")))):
                    if not torch.equal(g, w):
                        raise AssertionError(f"phase 15 {case} n_space={ns}: {fld} differs "
                                             "from refine_plane_device")
                check_launches(counts, f"{case} n_space={ns}")
                fallback = fn.last_stats["edt_fallback_rows"]
                if ("deep" in case) != (fallback > 0):
                    raise AssertionError(f"phase 15 {case} n_space={ns}: exact-EDT fallback "
                                         f"rows {fallback}")
                band_peak = position_peak(x, 1, ns)
                record[f"{case} n_space={ns}"] = {
                    "wall_ms": wall * 1e3, "one_device_wall_ms": wall1 * 1e3, "launches": counts,
                    "peak_gib": peak, "position_peak_gib": band_peak,
                    "one_device_peak_gib": peak1, "watershed": stats,
                    "edt_fallback_rows": fallback, "cells": num.tolist()}
                log(f"phase 15 {case} n_space={ns} [{card}]: labels, markers, counts and "
                    f"centroid sums == refine_plane_device ({num.tolist()} cells; exact-EDT "
                    f"fallback rows {fallback}); {wall * 1e3:.1f} ms wall (one device "
                    f"{wall1 * 1e3:.1f}); watershed {stats}; launches {counts}; peak "
                    f"{peak:.3f} GiB for all positions, {band_peak:.3f} GiB for one band alone, "
                    f"one device {peak1:.3f}")
            del x, want
            torch.cuda.empty_cache()
    finally:
        sharded._watershed_bands = real_ws
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15 spatial refine: {record['phase_s']:.1f} s wall")
    return launches, record


# ---- multi-host (phase 16) ---------------------------------------------------

MULTIHOST_FIELDS = ("den", "lab", "particle_ct", "n_comp", "filled", "overlap_px", "converged",
                    "seg", "area", "class_id")
MULTIHOST_TIMEOUT_S = 300
# one process of phase 16: join the gloo group, run the band-sharded segment
# with tables on this process's rows of the global batch (a warm-up run, then
# the counted and timed one), gather every process's rows and write them out
MULTIHOST_CHILD = r"""
import json, sys, time
import numpy as np
import torch
import chip_smoke
from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
from particle_col_image_segmentation_tpu_torch.parallel.mesh import (
    initialize_multihost, process_allgather)
from particle_col_image_segmentation_tpu_torch.parallel.sharded import make_sharded_segment_fn

coord, pid, npy, out, devices = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], \
    json.loads(sys.argv[5])
t0 = time.perf_counter()
mesh = initialize_multihost(coord, 2, pid, devices=devices, timeout=120)
init_s = time.perf_counter() - t0
batch = np.load(npy)
fn = make_sharded_segment_fn(mesh, AnalysisConfig(max_regions=chip_smoke.MAX_REGIONS),
                             with_tables=True)
fn(batch)
torch.cuda.synchronize()
reset_counts, read_counts = chip_smoke.launch_counters()
torch.cuda.reset_peak_memory_stats(0)
reset_counts()
t0 = time.perf_counter()
outs = fn(batch)
torch.cuda.synchronize()
wall_s = time.perf_counter() - t0
launches = read_counts()
t0 = time.perf_counter()
gathered = process_allgather(outs, tiled=True)
gather_s = time.perf_counter() - t0
np.savez(out, **dict(zip(chip_smoke.MULTIHOST_FIELDS, gathered)))
with open(out + ".json", "w") as f:
    json.dump({"mesh": mesh.shape, "local_rows": list(mesh.local_rows()), "init_s": init_s,
               "wall_s": wall_s, "gather_s": gather_s, "launches": launches,
               "peak_gib": torch.cuda.max_memory_allocated(0) / 2**30}, f)
torch.distributed.destroy_process_group()
loaded = [k for k in sys.modules if k.split(".")[0] in ("jax", "particle_col_image_segmentation_tpu")]
assert not loaded, f"JAX or the JAX package was imported: {loaded[:5]}"
print(f"MULTIHOST-PASS-{pid}", flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(tmp: str, tag: str, npy: str, devices) -> list:
    """Phase 16's two processes on a fresh loopback port, their output in
    files; a failed child has its peer killed, and so does the time limit.
    Returns each child's (output path, stdout)."""
    coord = f"127.0.0.1:{free_port()}"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    procs, logs = [], []
    for pid in (0, 1):
        out = os.path.join(tmp, f"{tag}_{pid}.npz")
        log_path = os.path.join(tmp, f"{tag}_{pid}.log")
        logs.append((out, log_path))
        with open(log_path, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MULTIHOST_CHILD, coord, str(pid), npy, out,
                 json.dumps(devices)], stdout=fh, stderr=subprocess.STDOUT, cwd=here, env=env))
    deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # one failed: its peer would wait for it until its own timeout
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    result = []
    for pid, (p, (out, log_path)) in enumerate(zip(procs, logs)):
        with open(log_path) as fh:
            text = fh.read()
        if p.returncode != 0 or f"MULTIHOST-PASS-{pid}" not in text:
            raise AssertionError(f"phase 16 {tag}: process {pid} exited {p.returncode} "
                                 f"(time limit {MULTIHOST_TIMEOUT_S} s):\n{text[-3000:]}")
        result.append((out, text))
    return result


def multihost_phase(card: str, dev, x4, cfg) -> tuple:
    """Two processes on one card, each with ``initialize_multihost(coordinator,
    2, pid, devices=...)``: ``["cuda:0", "cuda:0"]`` (a global 2x2 mesh) and
    the default devices (every card of the process: 2x1 here).  Each runs
    ``make_sharded_segment_fn(mesh, cfg, with_tables=True)`` on this
    process's rows of phase 4's first [4,2048,2048] planes and gathers with
    ``process_allgather(tiled=True)``; both gathered files must equal the
    one-device pass on the card at tolerance 0 (``fused_segment_batch`` for
    seg, n_comp, area, class_id, particle_ct, converged; its median, CCL
    and fill steps for den, lab, filled and overlap_px).  K1-K4, K6 and K8
    must launch in each child's counted run.  Returns (the children's
    launches summed, the record-line entry)."""
    import numpy as np
    import torch

    from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch
    from particle_col_image_segmentation_tpu_torch.ops.ccl import connected_components_auto
    from particle_col_image_segmentation_tpu_torch.ops.fill_tiles import particle_fill_step_auto
    from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import (
        median_label_filter_auto,
    )
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh
    from particle_col_image_segmentation_tpu_torch.parallel.sharded import (
        make_sharded_segment_fn,
    )

    t_phase = time.perf_counter()
    seg, num, areas, classes, particle_px, _, _, conv = fused_segment_batch(x4, cfg)
    den = median_label_filter_auto(x4, cfg.denoise_size, cfg.num_classes)
    lab = connected_components_auto(den, num_classes=cfg.num_classes,
                                    max_iters=cfg.ccl_max_iters)
    cap = max(cfg.dilation_radius, cfg.distance_threshold)
    filled, overlap = particle_fill_step_auto(den, 2, 1, cap, cfg.distance_threshold ** 2,
                                              cfg.dilation_radius ** 2)
    want = dict(zip(MULTIHOST_FIELDS, (den, lab, particle_px, num, filled, overlap, conv, seg,
                                       areas, classes)))
    want = {k: v.cpu().numpy() for k, v in want.items()}
    if not want["converged"].all():
        raise AssertionError("phase 16: the one-device pass did not converge")
    one = make_sharded_segment_fn(make_mesh(devices=[dev]), cfg, with_tables=True)
    one_wall_s, one_out = median_wall_s(lambda: one(x4))
    for name, got in zip(MULTIHOST_FIELDS, one_out):
        if not np.array_equal(got.cpu().numpy(), want[name]):
            raise AssertionError(f"phase 16: the 1x1 sharded segment's {name} differs from the "
                                 "one-device pass")
    fused_ms = time_ms(lambda: fused_segment_batch(x4, cfg), reps=3)
    del one_out
    torch.cuda.empty_cache()
    launches = {k: 0 for k, *_ in KERNELS}
    record = {"shape": list(x4.shape), "max_regions": cfg.max_regions,
              "one_device_sharded_wall_s": one_wall_s, "fused_segment_batch_ms": fused_ms,
              "runs": {}}
    with tempfile.TemporaryDirectory(prefix="pcis_multihost_") as tmp:
        npy = os.path.join(tmp, "planes.npy")
        np.save(npy, x4.cpu().numpy())
        for tag, devices in (("cuda:0 x2", ["cuda:0", "cuda:0"]), ("default devices", None)):
            t0 = time.perf_counter()
            children = run_pair(tmp, tag.replace(" ", "_").replace(":", ""), npy, devices)
            pair_s = time.perf_counter() - t0
            runs = []
            for pid, (out, _) in enumerate(children):
                got = dict(np.load(out))
                with open(out + ".json") as fh:
                    info = json.load(fh)
                for name in MULTIHOST_FIELDS:
                    g = got.get(name)
                    if g is None or g.shape != want[name].shape or not np.array_equal(
                            g, want[name]):
                        raise AssertionError(f"phase 16 {tag}: process {pid}'s gathered {name} "
                                             f"differs from the one-device pass")
                for k in ("K1", "K2", "K3", "K4", "K6", "K8"):
                    if info["launches"][k] <= 0:
                        raise AssertionError(f"phase 16 {tag}: process {pid} never launched {k}")
                for k, n in info["launches"].items():
                    launches[k] += n
                log(f"phase 16 multihost {tag} [{card}]: process {pid} of 2, mesh "
                    f"{info['mesh']}, rows {info['local_rows']}: segment with tables "
                    f"{info['wall_s']:.4f} s wall, process_allgather {info['gather_s']:.4f} s "
                    f"host, init {info['init_s']:.2f} s, peak {info['peak_gib']:.3f} GiB; "
                    f"launches {info['launches']}")
                runs.append(info)
            record["runs"][tag] = {"processes": runs, "pair_wall_s": pair_s}
            log(f"phase 16 multihost {tag}: both processes' gathered outputs "
                f"({', '.join(MULTIHOST_FIELDS)}) == the one-device pass on the card at "
                f"tolerance 0; the pair took {pair_s:.1f} s from start to exit")
    log(f"phase 16 multihost [{card}]: beside them, the same segment on a 1x1 mesh of {dev} "
        f"{one_wall_s:.4f} s wall (median of 3), fused_segment_batch {fused_ms:.3f} ms "
        f"(CUDA events) on {list(x4.shape)}")
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16 multihost: {record['phase_s']:.1f} s wall")
    return launches, record


# ---- the oracle at full width (phase 17) -----------------------------------------


def oracle_phase(card: str, dev, planes, acfg, reset_counts, read_counts) -> tuple:
    """The card's ``analyze_plane(img, cell_types, acfg, merged=True)`` at
    2048² held against the port's oracle field by field
    (``oracle.parity.assert_plane_parity``: denoise, positions and clusters
    with area, centroid at atol 1e-9 and bbox, ``cluster.cells``, the merged
    groups with their member regions, the particle fill, counts and
    densities), on bench plane 0 (one strain) and on phase 6's RFP+DAPI
    planes fused as the analyze path fuses them (two strains).  Returns
    (launches summed, the record-line entry)."""
    import numpy as np
    import torch

    from particle_col_image_segmentation_tpu_torch.config import BASE_TYPE_MAP
    from particle_col_image_segmentation_tpu_torch.models import analyze_plane
    from particle_col_image_segmentation_tpu_torch.models.multichannel import fuse_channels
    from particle_col_image_segmentation_tpu_torch.oracle.parity import assert_plane_parity

    fused = fuse_channels({"RFP": torch.from_numpy(planes[8]),
                           "DAPI": torch.from_numpy(planes[9])}, ["3D05", "6B07"]).numpy()
    cases = ((f"bench plane 0 [{H},{W}], one strain", planes[0], dict(SINGLE)),
             (f"phase 6's RFP+DAPI planes fused [{H},{W}], two strains", fused,
              dict(BASE_TYPE_MAP)))
    launches = {k: 0 for k, *_ in KERNELS}
    record = {}
    for name, img, ct in cases:
        reset_counts()
        t0 = time.perf_counter()
        ours = analyze_plane(img, ct, acfg, merged=True, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        got = read_counts()
        for k in ("K1", "K2", "K3", "K5", "K8", "K9"):
            if got[k] <= 0:
                raise AssertionError(f"phase 17 {name}: {k} was never launched")
        t0 = time.perf_counter()
        seen = assert_plane_parity(ours, np.asarray(img), ct, acfg)
        oracle_s = time.perf_counter() - t0
        for k, n in got.items():
            launches[k] += n
        record[name] = {"analyze_plane_s": card_s, "oracle_s": oracle_s, "launches": got, **seen}
        log(f"phase 17 oracle {name}: analyze_plane(merged=True) on the card [{card}] "
            f"{card_s:.2f} s == the port's oracle field for field ({seen['regions']} regions, "
            f"{seen['groups']} merged groups, counts {seen['counts']}); the oracle and the "
            f"comparison took {oracle_s:.1f} s on the host; launches {got}")
    return launches, record


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--profile", action="store_true",
                    help="also run phase 7: torch.profiler breakdowns of the analysis "
                         "graph and of refine_plane_device, run_analysis walls at "
                         "batch_planes 1 and 8, and the device's traced idle share")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1

    import numpy as np
    from scipy import ndimage as ndi

    import bench
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, RefineConfig, _kernels
    from particle_col_image_segmentation_tpu_torch.labels.analysis import (
        PlaneDeviceOut,
        analyze_planes_device,
        dapi_dedup_device,
    )
    from particle_col_image_segmentation_tpu_torch.models.batch import (
        _pixel_stats_from_tables,
        fused_segment_batch,
        run_batch,
    )
    from particle_col_image_segmentation_tpu_torch.models.experiment import run_analysis
    from particle_col_image_segmentation_tpu_torch.models.refine import (
        refine_boundaries_stack,
        refine_plane_device,
        write_refine_stack_csv,
    )
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        centroid_sums,
        centroid_sums_cuda,
        centroids_f64,
        centroids_int,
        compact_labels,
        compact_labels_cuda,
        connected_components,
        edt_sq,
        edt_sq_cuda,
        edt_sq_exact,
        edt_sq_exact_auto,
        local_maxima,
        local_maxima_auto,
        max_fused_cap,
        max_tile_cap,
        median_label_filter,
        median_label_filter_cuda,
        particle_fill_step,
        particle_fill_step_cuda,
        region_counts,
        region_counts_cuda,
        region_props,
        region_sums,
        region_sums_cuda,
        region_table_cuda,
        sqrt_f32,
        table_lookup,
        table_lookup_cuda,
        watershed,
        watershed_auto,
        watershed_cuda,
    )
    from particle_col_image_segmentation_tpu_torch.ops import gaussian_blur
    from particle_col_image_segmentation_tpu_torch.ops.filters import as_float32
    from particle_col_image_segmentation_tpu_torch.ops.threshold import (
        _bin_index,
        _bincount,
        _value_range,
    )
    from particle_col_image_segmentation_tpu_torch.ops.watershed import (
        claim_labels,
        minimax_costs,
    )
    from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
        claim_labels_cuda,
        minimax_costs_cuda,
    )

    # ---- phase 1: environment -------------------------------------------
    card = card_line()
    dev = torch.device("cuda:0")
    cap = torch.cuda.get_device_capability(dev)
    log(f"phase 1 env: card [{card}]")
    log(f"phase 1 env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {cap}, devices {torch.cuda.device_count()}, python "
        f"{sys.version.split()[0]}")
    log(f"phase 1 env: triton {imports('triton')}; h5py {imports('h5py')}; "
        f"matplotlib {imports('matplotlib')}; nvcc {_kernels._nvcc()}")
    log(f"phase 1 env: the TIFF codec's toolchain: g++ {host_compiler()}; PIL {imports('PIL')}")
    subpackages = ("io", "models", "utils", "labels", "report", "parallel", "oracle", "viz")
    before = set(sys.modules)
    for sub in subpackages:  # their re-exports need neither h5py nor matplotlib
        __import__(f"particle_col_image_segmentation_tpu_torch.{sub}")
    heavy = sorted({"h5py", "matplotlib"} & {k.split(".")[0] for k in set(sys.modules) - before})
    if heavy:
        raise AssertionError(f"importing the port's subpackages pulled in {heavy}")
    log(f"phase 1 env: the port's subpackages {', '.join(subpackages)} import without h5py "
        "or matplotlib")
    if cap[0] != 9:
        raise RuntimeError(f"compute capability {cap} is not Hopper (9.x)")

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    lib = _kernels.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
        f"({'built' if lib.build_log else 'loaded an existing build'})")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain, exact -----------------------------------
    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    err = {k: 0 for k, *_ in KERNELS}

    def compare(kernel: str, case: str, got, want) -> None:
        torch.cuda.synchronize()
        d = 0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{kernel} {case}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            if g.numel() and g.is_floating_point():  # watershed costs: exact too
                d = max(d, float((g.to(torch.float64) - w.to(torch.float64)).abs().max()))
            elif g.numel():
                d = max(d, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        err[kernel] = max(err[kernel], d)
        log(f"phase 3 {kernel} {case}: max |kernel - plain| = {d}")
        if d != 0:
            raise AssertionError(f"{kernel} {case}: kernel disagrees with plain")

    def table(case: str, seg, vals, max_regions: int = ANALYZE_REGIONS) -> None:
        compare("K5", f"{case} max_regions={max_regions}",
                list(region_table_cuda(seg, vals, max_regions)),
                list(region_props(seg, vals, max_regions)))

    def fill(case: str, x, *params) -> None:
        compare("K8", f"{case} {params}", list(particle_fill_step_cuda(x, *params)),
                list(particle_fill_step(x, *params)))

    def chain(x, case: str, max_regions: int = MAX_REGIONS):
        """K1..K5 and K8 on x, each against its plain version on the same
        input."""
        den = median_label_filter_cuda(x, 5, 8)
        compare("K1", case, [den], [median_label_filter(x, 5, 8)])
        raw = ccl_cuda(den)
        raw_p, conv = connected_components(den, max_iters=cfg.ccl_max_iters, with_flag=True)
        if not bool(conv.all()):
            raise AssertionError(f"plain CCL did not converge on {case}")
        compare("K2", case, [raw], [raw_p])
        seg, num = compact_labels_cuda(raw, max_regions)
        compare("K3", case, [seg, num], list(compact_labels(raw, max_regions)))
        tables = region_counts_cuda(seg, den, max_regions)
        compare("K4", case, list(tables), list(region_counts(seg, den, max_regions)))
        table(case, seg, den)
        fill(case, den, 2, 1, 20, 4, 400)
        return den, raw, seg

    planes = [bench.make_plane(s) for s in range(N_MAIN)]
    x4 = torch.from_numpy(np.stack(planes[:4])).to(dev)
    den4, _, seg4 = chain(x4, "[4,2048,2048] bench planes")
    rng = np.random.default_rng(7)
    odd = np.stack([p[:97, :130] for p in planes[4:7]])
    odd[rng.random(odd.shape) < 0.05] = 1
    den, raw, seg = chain(torch.from_numpy(odd).to(dev), "odd [3,97,130]")
    compare("K4", "odd [3,97,130] max_regions=8 (overflow)",
            list(region_counts_cuda(seg, den, 8)), list(region_counts(seg, den, 8)))
    table("odd [3,97,130] (overflow)", seg, den, 8)
    fill("odd [3,97,130]", den, 2, 1, 5, 9, 4)
    chain(torch.from_numpy(np.ascontiguousarray(planes[7][301:602, 517:1294])).to(dev),
          "2-D [301,777]")
    # the band modes (the space axis): 512-row bands of the bench planes, and
    # 48-row bands of the odd batch, where the halos reach over several bands
    band_checks(x4, 4, compare, "[4,2048,2048] bench planes")
    band_checks(torch.from_numpy(np.ascontiguousarray(odd[:, :96])).to(dev), 2, compare,
                "odd [3,96,130]", max_regions=8)
    mask = (x4 == 1).to(torch.uint8)
    for conn in (8, 4):
        raw = ccl_cuda(mask, background=0, connectivity=conn)
        compare("K2", f"background=0 connectivity={conn}", [raw],
                [connected_components(mask, background=0, connectivity=conn)])
        compare("K3", f"background=0 connectivity={conn}",
                list(compact_labels_cuda(raw, MAX_REGIONS)),
                list(compact_labels(raw, MAX_REGIONS)))
    vals = x4.to(torch.int32)
    compare("K2", "int32 values", [ccl_cuda(vals)], [connected_components(vals)])
    # K2's adversarial inputs: judged by scipy's labels, and by the plain
    # fixpoint too where that converges within 256 rounds
    t0 = time.perf_counter()
    for case, img, bg, conn in k2_inputs(H):
        case = f"{case} background={bg} connectivity={conn}"
        x = torch.from_numpy(img).to(dev)
        got = ccl_cuda(x, background=bg, connectivity=conn)
        compare("K2", f"{case} vs scipy", [got.cpu()],
                [torch.from_numpy(scipy_min_index(img, bg, conn))])
        if img.dtype == np.uint8:
            want, conv = connected_components(x, background=bg, connectivity=conn,
                                              max_iters=256, with_flag=True)
            if bool(conv.all()):
                compare("K2", f"{case} vs plain", [got], [want])
    log(f"phase 3 K2 adversarial inputs: {time.perf_counter() - t0:.1f} s")
    for size in (3, 5, 7, 9):
        for shape in ((3, 2, 5), (2, 63, 31), (2, 65, 33), (2, 129, 65), (1, 150, 112)):
            xs = torch.from_numpy(rng.integers(0, 10, shape).astype(np.uint8)).to(dev)
            for k in (8, 3):
                compare("K1", f"size {size} num_classes {k} {list(shape)}",
                        [median_label_filter_cuda(xs, size, k)], [median_label_filter(xs, size, k)])
        compare("K1", f"size {size} [2,{H},{W}] bench planes",
                [median_label_filter_cuda(x4[:2], size, 8)], [median_label_filter(x4[:2], size, 8)])
    shifted = torch.empty(2 * H * W + 1, dtype=torch.uint8, device=dev)[1:].view(2, H, W)
    shifted.copy_(x4[:2])  # off a 16-byte boundary: every tile reflects
    compare("K1", f"[2,{H},{W}] off a 16-byte boundary", [median_label_filter_cuda(shifted, 5, 8)],
            [median_label_filter(x4[:2], 5, 8)])
    table("[4,2048,2048] int32 values", seg4, den4.to(torch.int32) * 4099 - 16384)
    big = torch.zeros((2, 512, 512), dtype=torch.int32, device=dev)
    big_vals = torch.full((2, 512, 512), 16383, dtype=torch.int32, device=dev)
    big_vals[1] = -16384
    compare("K4", "int32 values, saturating sums",
            list(region_counts_cuda(big, big_vals, 4)),
            list(region_counts(big, big_vals, 4)))
    table("int32 values, saturating sums", big, big_vals, 4)
    # K4's second wrapper: the clamped value sums the DAPI dedup reads
    cell_vals4 = (den4 == 1).to(torch.int32)
    compare("K4", f"region_sums [4,2048,2048] cell mask max_regions={ANALYZE_REGIONS}",
            list(region_sums_cuda(seg4, cell_vals4, ANALYZE_REGIONS)),
            list(region_sums(seg4, cell_vals4, ANALYZE_REGIONS)))
    compare("K4", "region_sums int32 values, saturating sums",
            list(region_sums_cuda(big, big_vals, 4)), list(region_sums(big, big_vals, 4)))
    compare("K4", "region_sums odd [3,97,130] max_regions=8 (overflow)",
            list(region_sums_cuda(seg, den.to(torch.int32), 8)),
            list(region_sums(seg, den.to(torch.int32), 8)))
    fill("[4,2048,2048] no particle pixels", torch.where(den4 == 2, 3, den4), 2, 1, 20, 4, 400)
    # K3's and K4's edge inputs: raw that is not CCL output, odd shapes, views
    # off a 16-byte boundary; both K4 wrappers on each
    for case, raw_np, sliced in k3_inputs():
        xr = torch.from_numpy(raw_np).to(dev)
        xr = xr[1:] if sliced else xr
        compare("K3", case, list(compact_labels_cuda(xr, MAX_REGIONS)),
                list(compact_labels(xr, MAX_REGIONS)))
    for case, seg_np, val_np, mr, shifted in k4_inputs():
        st, vt = torch.from_numpy(seg_np).to(dev), torch.from_numpy(val_np).to(dev)
        if shifted:
            st, vt = off16(st), off16(vt)
        compare("K4", f"{case} max_regions={mr}", list(region_counts_cuda(st, vt, mr)),
                list(region_counts(st, vt, mr)))
        compare("K4", f"region_sums {case} max_regions={mr}", list(region_sums_cuda(st, vt, mr)),
                list(region_sums(st, vt, mr)))
    # K4 as the Otsu histogram: bin ids (R + 1 = 256) with uint8 zeros as
    # values, against the plain bincount; config #1's batch and config #2's
    # blurred [24,2048,2048] stack are the threshold path's own inputs
    def histogram_k4(case: str, x) -> None:
        lo, span = _value_range(x)
        idx = _bin_index(x, lo, span, 256)
        zeros = torch.zeros(idx.shape, dtype=torch.uint8, device=dev)
        compare("K4", f"Otsu histogram {case}", [region_counts_cuda(idx, zeros, 255)[0]],
                [_bincount(idx, 256)])

    for case, xs in hist_inputs():
        histogram_k4(case, torch.from_numpy(xs).to(dev))
    c1 = config1_plane()
    x1b = torch.from_numpy(np.stack([np.roll(c1, 7 * b, axis=1) for b in range(16)])).to(dev)
    histogram_k4("config #1 [16,512,512]", as_float32(x1b))
    # config #2's [24,2048,2048] stack stays on the host between the phases
    # that use it (here, phase 5's threshold times, phase 9), so the card
    # holds none of it while the other paths run and are timed
    t0 = time.perf_counter()
    x2k_np = config2_stack(24, H, 480)
    log(f"phase 3 config #2 stack [24,{H},{W}] uint16 (480 discs a plane) built in "
        f"{time.perf_counter() - t0:.1f} s")
    histogram_k4(f"config #2 blurred [24,{H},{W}]",
                 gaussian_blur(torch.from_numpy(x2k_np).to(dev), 1.0))
    torch.cuda.empty_cache()

    # K5's edge inputs (K4's, then runs meeting row and plane ends, B = 1 and
    # 64, tables that overflow) and K8's on both of its routes
    for case, seg_np, val_np, mr, shifted in k5_inputs():
        st, vt = torch.from_numpy(seg_np).to(dev), torch.from_numpy(val_np).to(dev)
        if shifted:
            st, vt = off16(st), off16(vt)
        table(case, st, vt, mr)
    fused_cap = max_fused_cap()
    routes = {}
    for case, x_np, params in k8_inputs(fused_cap):
        fill(case, torch.from_numpy(x_np).to(dev), *params)
        routes[params[2]] = particle_fill_step_cuda.last_route
    if any((route == "fused") != (c <= fused_cap) for c, route in routes.items()):
        raise AssertionError(f"K8 took a route other than its cap's: {routes}")
    log(f"phase 3 K8 routes by cap (one kernel up to cap {fused_cap}): {routes}")
    del xr, st, vt

    R1 = ANALYZE_REGIONS + 1
    ids = seg4.clone()
    ids[:, 0, :5] = torch.tensor([-1, 0, R1 - 1, R1, 2 * R1], dtype=torch.int32)
    for shape in ((R1,), (4, R1)):
        tab = torch.randint(0, 256, shape, dtype=torch.int32, device=dev)
        tab[..., 0], tab[..., -1] = 255, 0
        compare("K6", f"[4,2048,2048] ids -1/0/R-1/R/2R, table {list(shape)}",
                [table_lookup_cuda(ids, tab)], [table_lookup(ids, tab)])
        compare("K6", f"2-D ids, table [{R1}]", [table_lookup_cuda(ids[1], tab.reshape(-1, R1)[0])],
                [table_lookup(ids[1], tab.reshape(-1, R1)[0])])
    for case, ids_np, tab_np, shifted in k6_inputs():
        st, tt = torch.from_numpy(ids_np).to(dev), torch.from_numpy(tab_np).to(dev)
        if shifted:
            st, tt = off16(st), off16(tt)
        compare("K6", case, [table_lookup_cuda(st, tt)], [table_lookup(st, tt)])
    del st, tt

    def edt(case: str, m, c: int) -> str:
        """K9 against plain on m at cap c, its flag against the plain
        output's d² > c²; returns the route K9 took."""
        got, flag = edt_sq_cuda(m, c, with_flag=True)
        want = edt_sq(m, c)
        route = edt_sq_cuda.last_route
        compare("K9", f"{case} ({route})", [got], [want])
        if bool(flag) != bool((want > c * c).any()):
            raise AssertionError(f"K9 {case}: flag {int(flag)}, plain max {int(want.max())}")
        return route

    tile_cap = max_tile_cap()
    k9_routes = {c: edt(f"[4,2048,2048] cells cap {c}", x4 == 1, c) for c in (2, 20, 32)}
    for case, m_np, c, shifted in k9_inputs(tile_cap):
        m = torch.from_numpy(m_np).to(dev)
        k9_routes[c] = edt(case, off16(m) if shifted else m, c)
    if any((route == "tile") != (c <= tile_cap) for c, route in k9_routes.items()):
        raise AssertionError(f"K9 took a route other than its cap's: {k9_routes}")
    log(f"phase 3 K9 routes by cap (one kernel up to cap {tile_cap}): {k9_routes}")
    # the float32 distance's square root on the card: numpy's correctly
    # rounded one for every d² below 2^24 and a sample past it
    past = np.random.default_rng(5).integers(2**24, 2**31, 1 << 20).astype(np.int32)
    for case, d2 in (("every d² in [0, 2^24)", torch.arange(2**24, dtype=torch.int32, device=dev)),
                     ("2^20 seeded d² in [2^24, 2^31)", torch.from_numpy(past).to(dev))):
        got = sqrt_f32(d2).cpu().numpy()
        if not np.array_equal(got.view(np.int32),
                              np.sqrt(d2.cpu().numpy().astype(np.float32)).view(np.int32)):
            raise AssertionError(f"sqrt_f32 on the card: {case} differs from numpy's")
        log(f"phase 3 sqrt_f32 {case}: equal to numpy's float32 sqrt bit for bit")
    del past, d2, got
    morph_checks(dev, np.stack(planes[:4]), odd, tile_cap, compare)

    # ---- phase 3, the refine slice: exact EDT, local maxima, K10/K11, K7 ---
    rcfg = RefineConfig()
    t0 = time.perf_counter()
    relief = refine_relief()
    stack8 = np.stack([np.roll(relief, 17 * b, axis=1) for b in range(REFINE_PLANES)])
    q2 = quantize16(stack8[:2])
    log(f"phase 3 refine relief: [{REFINE_PLANES},{H},{W}] built in "
        f"{time.perf_counter() - t0:.1f} s")
    x8r = torch.from_numpy(stack8).to(dev)
    mask8 = x8r < rcfg.boundary_threshold
    pcap = rcfg.edt_probe_cap
    # refine's probe as phase 5 times it: K9 and its flag against plain
    edt(f"[{REFINE_PLANES},{H},{W}] relief, refine's probe cap {pcap}", ~mask8, pcap)
    dsq8 = edt_sq_exact_auto(~mask8, pcap)
    want8 = edt_sq(~mask8, pcap)
    if bool((want8 > pcap * pcap).any()):
        want8 = edt_sq_exact(~mask8)
    compare("K9", f"edt_sq_exact_auto [{REFINE_PLANES},{H},{W}] relief", [dsq8], [want8])
    dist8 = refine_plane_device(x8r, rcfg, REFINE_REGIONS)[4].cpu().numpy()
    if not np.array_equal(dist8.view(np.int32),
                          np.sqrt(want8.cpu().numpy().astype(np.float32)).view(np.int32)):
        raise AssertionError("refine_plane_device's distance differs from numpy's sqrt of "
                             "the plain d²")
    log(f"phase 3 refine_plane_device [{REFINE_PLANES},{H},{W}] relief: distance == numpy's "
        f"float32 sqrt of the plain transform's d² bit for bit")
    del dist8, want8
    compare("K9", "edt_sq_exact_auto [2,2048,2048] relief (capped probe certified)",
            [edt_sq_exact_auto(~mask8[:2], rcfg.edt_probe_cap)], [edt_sq_exact(~mask8[:2])])
    deep = torch.zeros((1, 1024, 1024), dtype=torch.bool, device=dev)
    deep[0, 100, 200] = deep[0, 900, 50] = True
    compare("K9", "edt_sq_exact_auto [1,1024,1024] two features (the exact fallback)",
            [edt_sq_exact_auto(deep, rcfg.edt_probe_cap)], [edt_sq_exact(deep)])
    for conn in (2, 1):
        compare("K2", f"local_maxima_auto [2,2048,2048] relief EDT² connectivity={conn}",
                [local_maxima_auto(dsq8[:2], conn)], [local_maxima(dsq8[:2], conn)])
    maxima8 = local_maxima_auto(dsq8)
    mk8, num8 = compact_labels_cuda(ccl_cuda(maxima8.to(torch.uint8), background=0),
                                    REFINE_REGIONS)
    seeded8 = (mk8 > 0) & mask8

    def ws_phases(case: str, img, mk, m, conn: int, plain_iters: int = 1024):
        """Each watershed phase, kernels against plain; returns the labels."""
        seeded = (mk > 0) & m
        cost_k, busy_k, log1 = minimax_costs_cuda(img, m, seeded, conn)
        cost_p, busy_p = minimax_costs(img, m, seeded, conn, plain_iters)
        if busy_k.any() or busy_p.any():
            raise AssertionError(f"phase 1 did not converge on {case}")
        compare("K10", f"{case} connectivity={conn} ({log1.passes} passes, {log1.syncs} "
                f"host syncs)", [cost_k], [cost_p])
        lab_k, busy_k, log2 = claim_labels_cuda(cost_k, img, mk, m, seeded, conn)
        lab_p, busy_p = claim_labels(cost_p, img, mk, m, seeded, conn, plain_iters)
        if busy_k.any() or busy_p.any():
            raise AssertionError(f"phase 2 did not converge on {case}")
        compare("K11", f"{case} connectivity={conn} ({log2.passes} passes, {log2.syncs} "
                f"host syncs)", [lab_k], [lab_p])
        return lab_k, log1, log2

    for name, imgs in (("smooth relief", x8r[:2]), ("16-level relief", torch.from_numpy(q2).to(dev))):
        for conn in (1, 2):
            ws_phases(f"[2,{H},{W}] {name}", imgs, mk8[:2], mask8[:2], conn)
    island_m, island_mk = mask8[:2].clone(), mk8[:2].clone()
    island_m[:, 100:300, 100:103] = island_m[:, 100:300, 297:300] = False
    island_m[:, 100:103, 100:300] = island_m[:, 297:300, 100:300] = False
    island_mk[:, 100:300, 100:300] = 0  # no seed inside the walled square
    lab = ws_phases("unreachable island", x8r[:2], island_mk, island_m, 1)[0]
    if int(lab[:, 103:297, 103:297].abs().sum()) != 0 or int(island_m[:, 103:297, 103:297].sum()) == 0:
        raise AssertionError("the unreachable island was flooded (or holds no mask)")
    rng3 = np.random.default_rng(9)
    img3 = torch.from_numpy(rng3.random((3, 97, 130)).astype(np.float32)).to(dev)
    mk3 = torch.zeros((3, 97, 130), dtype=torch.int32, device=dev)
    mk3[:, 5, 5], mk3[:, 90, 120], mk3[1, 50, 2] = 1, 2, 3
    m3 = torch.ones((3, 97, 130), dtype=torch.bool, device=dev)
    m3[:, :, 60:63] = False
    for conn in (1, 2):
        ws_phases("odd [3,97,130] random relief", img3, mk3, m3, conn)
    # the serpentine corridor (a tile goes quiet and wakes again) and a batch
    # whose planes need a few and many passes (the per-plane early exit),
    # then the budgets 1, 2, need - 1 and need on it and on the relief
    for name, arrays in (("serpentine corridor [1,128,192]", [a[None] for a in ws_corridor()]),
                         ("mixed pass counts [2,128,192]", ws_mixed())):
        wimg, wmk, wm = (torch.from_numpy(a).to(dev) for a in arrays)
        for conn in (1, 2):
            want, log1, log2 = ws_phases(name, wimg, wmk, wm, conn, plain_iters=1 << 14)
            if min(log1.passes, log2.passes) <= 12:
                raise AssertionError(f"{name}: a phase needed only {log1.passes}, "
                                     f"{log2.passes} passes")
            log(f"phase 3 K10/K11 {name} connectivity={conn}: tiles run a pass "
                f"{list(log1.tiles)} (phase 1), {list(log2.tiles)} (phase 2)")
            for budget, passes, conv in ws_budgets(wimg, wmk, wm, conn, want):
                log(f"phase 3 K10/K11 {name} connectivity={conn} budget {budget}: passes "
                    f"{passes}, converged {conv}, converged planes == plain")
    want = watershed(x8r[:2], mk8[:2], mask8[:2])
    for budget, passes, conv in ws_budgets(x8r[:2], mk8[:2], mask8[:2], 1, want):
        log(f"phase 3 K10/K11 [2,{H},{W}] relief budget {budget}: passes {passes}, "
            f"converged {conv}, converged planes == plain")
    labels8 = watershed_auto(x8r, mk8, mask8)
    compare("K7", f"[{REFINE_PLANES},{H},{W}] watershed labels R={REFINE_REGIONS + 1}",
            list(centroid_sums_cuda(labels8, REFINE_REGIONS)),
            list(centroid_sums(labels8, REFINE_REGIONS)))
    compare("K7", f"2-D [{H},{W}] labels", list(centroid_sums_cuda(labels8[0], REFINE_REGIONS)),
            list(centroid_sums(labels8[0], REFINE_REGIONS)))
    for case, seg_np, mr, shifted in k7_inputs():
        st = torch.from_numpy(seg_np).to(dev)
        st = off16(st) if shifted else st
        compare("K7", f"{case} max_regions={mr}", list(centroid_sums_cuda(st, mr)),
                list(centroid_sums(st, mr)))
    del st
    # the spatial refine's band modes: K7, K9, K10 and K11 on 512-row bands of
    # one relief plane, and on 48-row bands of three corridors at the odd
    # batch's size, whose flood crosses the seam
    refine_band_checks(x8r[:1], mk8[:1], mask8[:1], labels8[:1], 4, compare,
                       f"[1,{H},{W}] relief")
    corr = [ws_corridor(96, 130, pitch=3 + i, seed=12 + i) for i in range(3)]
    cimg, cmk, cm = (torch.from_numpy(np.stack([c[k] for c in corr])).to(dev) for k in range(3))
    refine_band_checks(cimg, cmk, cm, watershed_auto(cimg, cmk, cm), 2, compare,
                       "corridors [3,96,130]")
    del corr, cimg, cmk, cm

    # ---- launch counts: reset just before a path runs, read just after -----
    reset_counts, read_counts = launch_counters()

    # ---- phase 4: the batch path -------------------------------------------
    paths = [str(i) for i in range(N_MAIN)]
    reset_counts()
    t0 = time.perf_counter()
    stats = dict(run_batch(paths, lambda p: planes[int(p)], cfg, device=dev,
                           batch_size=BATCH, particle_val=2, cell_vals=(1,)))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    batch_launches = read_counts()
    log(f"phase 4 batch path: run_batch over {N_MAIN} planes of {H}x{W} in "
        f"batches of {BATCH}: {main_s:.2f} s wall; kernel launches {batch_launches}")
    if sorted(stats) != sorted(paths):
        raise AssertionError(f"run_batch yielded {len(stats)} of {N_MAIN} planes")
    for k in ("K1", "K2", "K3", "K4"):
        if batch_launches[k] <= 0:
            raise AssertionError(f"{k} was never launched on the batch path")
    for p, s in stats.items():
        want = int((ndi.median_filter(planes[int(p)], size=5) == 2).sum())
        if not s.converged or s.overflow or s.particle_px != want:
            raise AssertionError(f"plane {p}: {s} (scipy particle_px {want})")
    log(f"phase 4 batch path: all {N_MAIN} planes converged, no overflow, "
        f"particle_px == scipy median count; regions per plane "
        f"{min(s.num_regions for s in stats.values())}.."
        f"{max(s.num_regions for s in stats.values())}")
    seg0, num0 = (t[0].cpu().numpy() for t in fused_segment_batch(x4[:1], cfg)[:2])
    ref0, ref_num0 = scipy_labels(ndi.median_filter(planes[0], size=5))
    if int(num0) != ref_num0 or not np.array_equal(seg0, ref0):
        raise AssertionError("plane 0: labels differ from scipy's")
    log(f"phase 4 batch path: plane 0 labels == scipy median + per-class "
        f"scipy label in raster order ({ref_num0} regions)")

    def plain_fused(imgs):
        den = median_label_filter(imgs, cfg.denoise_size, cfg.num_classes)
        raw, conv = connected_components(
            den, num_classes=cfg.num_classes, max_iters=cfg.ccl_max_iters,
            with_flag=True,
        )
        seg, num = compact_labels(raw, cfg.max_regions)
        areas, classes = region_counts(seg, den, cfg.max_regions)
        class_px, particle_px, cell_px = _pixel_stats_from_tables(
            areas, classes, cfg, 2, (1,)
        )
        return seg, num, areas, classes, particle_px, cell_px, class_px, conv

    ref = plain_fused(x4)
    for b in range(4):
        s = stats[str(b)]
        got = (s.num_regions, s.particle_px, s.cell_px, s.class_px.tolist(), s.converged)
        want = (int(ref[1][b]), int(ref[4][b]), int(ref[5][b]),
                ref[6][b].cpu().tolist(), bool(ref[7][b]))
        if got != want:
            raise AssertionError(f"plane {b}: batch path {got} != plain {want}")
    log("phase 4 batch path: planes 0-3 stats == plain path on the card")
    del ref

    # ---- phase 5: times ----------------------------------------------------
    xb = torch.from_numpy(np.stack(planes[:BATCH])).to(dev)
    mp = BATCH * H * W / 1e6
    torch.cuda.synchronize()
    smoke_peak = torch.cuda.max_memory_allocated(dev)  # before the fused pass's own window
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fused_ms = time_ms(lambda: fused_segment_batch(xb, cfg), reps=5, warmup=2)
    fused_peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase 5 fused pass peak device memory [{card}]: {fused_peak / 2**30:.3f} GiB, "
        f"{(fused_peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held before "
        f"it ([{BATCH},{H},{W}] input on the card)")
    plain_fused_ms = time_ms(lambda: plain_fused(xb), reps=1, warmup=1)
    den = median_label_filter_cuda(xb, 5, 8)
    raw = ccl_cuda(den)
    seg, _ = compact_labels_cuda(raw, MAX_REGIONS)
    acfg = AnalysisConfig()
    fill_args = (2, 1, max(acfg.dilation_radius, acfg.distance_threshold),
                 acfg.distance_threshold ** 2, acfg.dilation_radius ** 2)
    x8, den8, seg8 = xb[:8].contiguous(), den[:8].contiguous(), seg[:8].contiguous()
    ctx16 = torch.cat([den8 == 1, den8 == 1])  # one strain: its mask, then the union
    edt(f"phase 5's merge contexts [16,{H},{W}] cap {acfg.merge_disk_radius}", ctx16,
        acfg.merge_disk_radius)
    tab = torch.randint(0, 2, (R1,), dtype=torch.int32, device=dev)
    ms = {
        "K1": time_ms(lambda: median_label_filter_cuda(xb, 5, 8), reps=10),
        "K2": time_ms(lambda: ccl_cuda(den), reps=10),
        "K3": time_ms(lambda: compact_labels_cuda(raw, MAX_REGIONS), reps=10),
        "K4": time_ms(lambda: region_counts_cuda(seg, den, MAX_REGIONS), reps=10),
        "K5": time_ms(lambda: region_table_cuda(seg8, den8, ANALYZE_REGIONS), reps=10),
        "K6": time_ms(lambda: table_lookup_cuda(seg8[0], tab), reps=10),
        "K8": time_ms(lambda: particle_fill_step_cuda(den8, *fill_args), reps=10),
        "K9": time_ms(lambda: edt_sq_cuda(ctx16, acfg.merge_disk_radius), reps=10),
    }
    plain_ms = {
        "K1": time_ms(lambda: median_label_filter(xb, 5, 8), reps=2),
        "K2": time_ms(lambda: connected_components(den, max_iters=cfg.ccl_max_iters), reps=1),
        "K3": time_ms(lambda: compact_labels(raw, MAX_REGIONS), reps=2),
        "K4": time_ms(lambda: region_counts(seg, den, MAX_REGIONS), reps=2),
        "K5": time_ms(lambda: region_props(seg8, den8, ANALYZE_REGIONS), reps=2),
        "K6": time_ms(lambda: table_lookup(seg8[0], tab), reps=2),
        "K8": time_ms(lambda: particle_fill_step(den8, *fill_args), reps=2),
        "K9": time_ms(lambda: edt_sq(ctx16, acfg.merge_disk_radius), reps=2),
    }
    # library yardsticks (timed here, used nowhere in the port): one sorted
    # torch.unique with inverse for K3, two torch.bincount calls (area, then
    # the float64-weighted value sums, exact) for K4; the keys are built
    # outside the events
    keyed = raw.to(torch.int64) + H * W * torch.arange(BATCH, device=dev).view(-1, 1, 1)
    library_ms = {"K3": time_ms(lambda: torch.unique(keyed, sorted=True, return_inverse=True),
                                reps=3)}
    _, inv = torch.unique(keyed, sorted=True, return_inverse=True)
    seg_k, num_k = compact_labels_cuda(raw, MAX_REGIONS)
    before_plane = (torch.cumsum(num_k, 0) - num_k).view(-1, 1, 1)  # uniques of earlier planes
    if not torch.equal((inv - before_plane + 1).to(torch.int32), seg_k):
        raise AssertionError("phase 5: torch.unique's inverse differs from K3's ids")
    del keyed, inv, seg_k
    R1m = MAX_REGIONS + 1
    bins4 = (seg.to(torch.int64) + R1m * torch.arange(BATCH, device=dev).view(-1, 1, 1)).reshape(-1)
    wts4 = den.reshape(-1).to(torch.float64)
    library_ms["K4"] = time_ms(lambda: (torch.bincount(bins4, minlength=BATCH * R1m),
                                        torch.bincount(bins4, weights=wts4, minlength=BATCH * R1m)),
                               reps=3)
    lib_area = torch.bincount(bins4, minlength=BATCH * R1m).view(BATCH, R1m)
    if not torch.equal(lib_area.to(torch.int32), region_counts_cuda(seg, den, MAX_REGIONS)[0]):
        raise AssertionError("phase 5: torch.bincount's areas differ from K4's")
    del bins4, wts4, lib_area
    library_note = {"K3": "one torch.unique", "K4": "two torch.bincount"}
    shapes = {k: f"[{BATCH},{H},{W}]" for k in ("K1", "K2", "K3", "K4")}
    shapes.update(K5=f"[8,{H},{W}] R+1={R1}", K6=f"[{H},{W}] R={R1}",
                  K8=f"[8,{H},{W}] cap {fill_args[2]}",
                  K9=f"[16,{H},{W}] cap {acfg.merge_disk_radius}")
    log(f"phase 5 times [{card}]: fused pass [{BATCH},{H},{W}] kernels "
        f"{fused_ms:.3f} ms = {mp / fused_ms * 1e3:.1f} MP/s; plain "
        f"{plain_fused_ms:.3f} ms = {mp / plain_fused_ms * 1e3:.1f} MP/s")
    for k in ms:
        lib = f", {library_note[k]} {library_ms[k]:.3f} ms" if k in library_ms else ""
        log(f"phase 5 times [{card}]: {k} kernel {ms[k]:.3f} ms, plain "
            f"{plain_ms[k]:.3f} ms{lib} at {shapes[k]}")
    # K5 and K8 also run at B = 1 on the analyze path (a multi-channel
    # folder's planes, one strain at a time): their time at that shape, and
    # at both shapes their device time a call by torch.profiler (a fast call's
    # CUDA events also hold the host's launch gaps)
    seg1, den1 = seg8[:1].contiguous(), den8[:1].contiguous()
    for b, (sg, dn) in ((8, (seg8, den8)), (1, (seg1, den1))):
        k5 = (lambda: region_table_cuda(sg, dn, ANALYZE_REGIONS))
        k8 = (lambda: particle_fill_step_cuda(dn, *fill_args))
        log(f"phase 5 times [{card}]: at [{b},{H},{W}]: K5 kernel {time_ms(k5, reps=10):.4f} ms "
            f"(device {device_ms(k5):.4f}), K8 kernel {time_ms(k8, reps=10):.4f} ms (device "
            f"{device_ms(k8):.4f}, route {particle_fill_step_cuda.last_route})")
    del seg1, den1
    # K6 by device time too: a call this short reads its wrapper's host path
    # by events
    k6_device_ms = device_ms(lambda: table_lookup_cuda(seg8[0], tab), reps=20)
    log(f"phase 5 times [{card}]: K6 [{H},{W}] R={R1}: {ms['K6']:.4f} ms by CUDA events, "
        f"device {k6_device_ms:.4f} ms (torch.profiler, 20 calls)")
    split = kernel_split(lambda: compact_labels_cuda(raw, MAX_REGIONS), K3_PHASES)
    log(f"phase 5 times [{card}]: K3 on raw [{BATCH},{H},{W}]: torch.profiler: "
        + ", ".join(f"{p} {v:.3f}" for p, v in split.items()) + " ms")
    # K2 on each of its callers' inputs, with the split by phase
    r = acfg.merge_disk_radius
    ctx_u8 = (edt_sq_cuda(ctx16, r) <= r * r).to(torch.uint8)
    for name, x in ((f"den [{BATCH},{H},{W}] uint8", den),
                    (f"merge contexts [16,{H},{W}] uint8", ctx_u8),
                    (f"EDT² [{REFINE_PLANES},{H},{W}] int32", dsq8)):
        t = time_ms(lambda x=x: ccl_cuda(x), reps=10)
        split = kernel_split(lambda x=x: ccl_cuda(x), K2_PHASES)
        log(f"phase 5 times [{card}]: K2 on {name}: {t:.3f} ms (CUDA events); "
            f"torch.profiler: " + ", ".join(f"{p} {v:.3f}" for p, v in split.items()) + " ms")
    del den, raw, seg, ctx_u8

    def plain_analyze(imgs):
        """analyze_planes_device (one-strain 3D05 map, merge on) through
        the plain versions on the tensor's device."""
        den = median_label_filter(imgs, acfg.denoise_size, acfg.num_classes)
        raw, conv = connected_components(
            den, num_classes=acfg.num_classes, max_iters=acfg.ccl_max_iters,
            with_flag=True,
        )
        seg, num = compact_labels(raw, acfg.max_regions)
        tab = region_props(seg, den, acfg.max_regions)
        particle_area = (den == 2).sum(dim=(-2, -1), dtype=torch.int32)
        filled, ov = particle_fill_step(den, *fill_args)
        B = imgs.shape[0]
        icy, icx = centroids_int(tab)
        idx = (icy.clamp(0, H - 1) * W + icx.clamp(0, W - 1)).to(torch.int64).repeat(2, 1)
        r = acfg.merge_disk_radius
        dil = edt_sq(torch.cat([den == 1, den == 1]), r) <= r * r
        ctx_raw, conv_ctx = connected_components(
            dil.to(torch.uint8), num_classes=2, max_iters=acfg.ccl_max_iters,
            with_flag=True,
        )
        g = torch.gather(ctx_raw.reshape(2 * B, -1), 1, idx)
        on = torch.gather(dil.reshape(2 * B, -1), 1, idx)
        g_ctx = torch.where(on, g, -1).reshape(2, B, -1)
        conv = conv & conv_ctx.reshape(2, B).all(dim=0)
        return PlaneDeviceOut(den, seg, num, tab, particle_area, filled, ov[None], g_ctx, conv)

    def compare_outs(case: str, got, want) -> None:
        for name, g, w in zip(PlaneDeviceOut._fields, got, want, strict=True):
            gs = list(g) if name == "table" else [g]
            ws = list(w) if name == "table" else [w]
            for gg, ww in zip(gs, ws, strict=True):
                gg, ww = gg.cpu(), ww.cpu()
                if gg.shape != ww.shape or gg.dtype != ww.dtype or not torch.equal(gg, ww):
                    raise AssertionError(f"{case}: field {name} differs")
        log(f"{case}: every PlaneDeviceOut field equal")

    amp = 8 * H * W / 1e6
    analyze_ms = time_ms(lambda: analyze_planes_device(x8, SINGLE, acfg), reps=3)
    plain_analyze_ms = time_ms(lambda: plain_analyze(x8), reps=1)
    log(f"phase 5 times [{card}]: analyze_planes_device [8,{H},{W}] kernels "
        f"{analyze_ms:.3f} ms = {amp / analyze_ms * 1e3:.1f} MP/s; plain "
        f"{plain_analyze_ms:.3f} ms = {amp / plain_analyze_ms * 1e3:.1f} MP/s")
    compare_outs(f"phase 5 analyze_planes_device [8,{H},{W}] kernels vs plain on the card",
                 analyze_planes_device(x8, SINGLE, acfg), plain_analyze(x8))
    del xb, x8, den8, seg8, ctx16

    # the refine slice: K7, each watershed phase, refine_plane_device
    R1r = REFINE_REGIONS + 1
    ms["K7"] = time_ms(lambda: centroid_sums_cuda(labels8, REFINE_REGIONS), reps=10)
    plain_ms["K7"] = time_ms(lambda: centroid_sums(labels8, REFINE_REGIONS), reps=2)
    pix = torch.arange(H * W, device=dev)
    rows, cols = pix // W, pix % W
    digits = torch.stack([torch.ones_like(pix), rows // 128, rows % 128, cols // 128,
                          cols % 128], dim=1).to(torch.int32).repeat(REFINE_PLANES, 1)
    bins = (labels8.reshape(REFINE_PLANES, -1).to(torch.int64)
            + R1r * torch.arange(REFINE_PLANES, device=dev)[:, None]).reshape(-1)
    lib_table = torch.zeros((REFINE_PLANES * R1r, 5), dtype=torch.int32, device=dev)
    library_ms["K7"] = time_ms(lambda: lib_table.index_add_(0, bins, digits), reps=5)
    library_note["K7"] = "one index_add_"
    del pix, rows, cols, digits, bins, lib_table
    # K9 also runs as refine's certified probe: cap 32 on [8,2048,2048]
    probe = (~mask8).contiguous()
    k9p = (lambda: edt_sq_cuda(probe, rcfg.edt_probe_cap, with_flag=True))
    log(f"phase 5 times [{card}]: K9 refine's probe [{REFINE_PLANES},{H},{W}] cap "
        f"{rcfg.edt_probe_cap}: {time_ms(k9p, reps=10):.4f} ms (device {device_ms(k9p):.4f}, "
        f"route {edt_sq_cuda.last_route}), bound "
        f"{5 * REFINE_PLANES * H * W / HBM_BYTES_PER_S * 1e3:.4f} ms (1 B in, 4 B out a pixel)")
    del probe
    # each watershed phase: its whole pass loop inside the events (chunks of
    # passes, one host sync a chunk), and the device time of its passes
    ws_fn = {"K10": lambda: minimax_costs_cuda(x8r, mask8, seeded8)}
    ms["K10"] = time_ms(ws_fn["K10"], reps=5)
    cost8, _, ws_log = minimax_costs_cuda(x8r, mask8, seeded8)
    ws_log = {"K10": ws_log}
    plain_ms["K10"] = time_ms(lambda: minimax_costs(x8r, mask8, seeded8), reps=1, warmup=0)
    ws_fn["K11"] = lambda: claim_labels_cuda(cost8, x8r, mk8, mask8, seeded8)
    ms["K11"] = time_ms(ws_fn["K11"], reps=5)
    ws_log["K11"] = ws_fn["K11"]()[2]
    plain_ms["K11"] = time_ms(lambda: claim_labels(cost8, x8r, mk8, mask8, seeded8),
                              reps=1, warmup=0)
    shapes.update(K7=f"[{REFINE_PLANES},{H},{W}] R={R1r}",
                  K10=f"[{REFINE_PLANES},{H},{W}] relief, {ws_log['K10'].passes} passes",
                  K11=f"[{REFINE_PLANES},{H},{W}] relief, {ws_log['K11'].passes} passes")
    for k in ("K7", "K10", "K11"):
        lib = f", {library_note[k]} {library_ms[k]:.3f} ms" if k in library_ms else ""
        log(f"phase 5 times [{card}]: {k} kernel {ms[k]:.3f} ms, plain "
            f"{plain_ms[k]:.3f} ms{lib} at {shapes[k]}")
    for k, kernel in (("K10", "cost_pass"), ("K11", "label_pass")):
        traced = kernel_split(ws_fn[k], (("passes", (kernel,)),))["passes"]
        wl = ws_log[k]
        log(f"phase 5 times [{card}]: {k} loop: {wl.passes} passes ({wl.launches} launched), "
            f"{wl.syncs} host syncs, {traced:.3f} ms of device time in its passes "
            f"(torch.profiler); tiles run a pass {list(wl.tiles)} (of "
            f"{REFINE_PLANES * (H // 32) * (W // 32)})")

    rmp = REFINE_PLANES * H * W / 1e6
    refine_ms = time_ms(lambda: refine_plane_device(x8r, rcfg, REFINE_REGIONS), reps=3)
    plain8 = {}
    plain_refine_ms = time_ms(lambda: plain8.update(out=plain_refine(x8r, rcfg)), reps=1, warmup=0)
    log(f"phase 5 times [{card}]: refine_plane_device [{REFINE_PLANES},{H},{W}] kernels "
        f"{refine_ms:.3f} ms = {rmp / refine_ms * 1e3:.1f} MP/s; plain "
        f"{plain_refine_ms:.3f} ms = {rmp / plain_refine_ms * 1e3:.1f} MP/s")

    # the threshold path (configs #1 and #2): times, and K4's and K2's own
    # shapes on it
    x1 = torch.from_numpy(c1).to(dev)
    x2 = torch.from_numpy(config2_stack()).to(dev)
    more_shapes = threshold_times(card, x1, x1b, x2, torch.from_numpy(x2k_np).to(dev))
    torch.cuda.empty_cache()
    more_shapes["K6"] = {"shape": f"[{H},{W}] R={R1}, device time", "ms": k6_device_ms,
                         "device_ms": k6_device_ms, "plain_ms": plain_ms["K6"],
                         "bound_ms": (8 * H * W + 4 * R1) / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes", "library_ms": None}
    log(f"phase 5 peak device memory: "
        f"{max(smoke_peak, torch.cuda.max_memory_allocated(dev)) / 2**30:.2f} GiB")

    # ---- phase 6: the analyze path -----------------------------------------
    seed_of = {}  # placeholder .h5 path -> index into planes

    def load_fn(path):
        return planes[seed_of[path]]

    with tempfile.TemporaryDirectory(prefix="pcis_smoke_") as tmp:
        root = os.path.join(tmp, "tree")
        seed_of.update(make_tree(root, range(8)))
        reset_counts()
        t0 = time.perf_counter()
        run_analysis(root, acfg, make_figures=False, device=dev, batch_planes=8,
                     load_fn=load_fn)
        torch.cuda.synchronize()
        analyze_s = time.perf_counter() - t0
        analyze_launches = read_counts()
        log(f"phase 6 analyze path: run_analysis over 10 planes of "
            f"{H}x{W} (8 single-file folders batched by 8, one RFP+DAPI "
            f"folder): {analyze_s:.2f} s wall [{card}]; kernel launches "
            f"{analyze_launches}")
        for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K8", "K9"):
            if analyze_launches[k] <= 0:
                raise AssertionError(f"{k} was never launched on the analyze path")

        # the same flow through the plain versions on the CPU, over folder 0
        # and the RFP+DAPI folder (dedup, fusion, merged re-analysis)
        ref_root = os.path.join(tmp, "ref")
        seed_of.update(make_tree(ref_root, [0]))
        t0 = time.perf_counter()
        run_analysis(ref_root, acfg, make_figures=False, device="cpu", load_fn=load_fn)
        ref_s = time.perf_counter() - t0
        got_csv, want_csv = csv_lines(root), csv_lines(ref_root)
        analyze_csv = got_csv  # phase 14's reference
        for rel, want_lines in want_csv.items():
            if rel not in got_csv:
                raise AssertionError(f"phase 6: the card's run wrote no {rel}")
            got_lines = got_csv[rel]
            if rel.endswith("_cell_density_info.csv"):  # rows of the ref's folders only
                keys = {r.split(b",")[0] for r in want_lines[1:]}
                got_lines = got_lines[:1] + [r for r in got_lines[1:] if r.split(b",")[0] in keys]
            if got_lines != want_lines or len(want_lines) < 2:
                raise AssertionError(f"phase 6: {rel} differs from the plain CPU run's")
        log(f"phase 6 analyze path: {len(want_csv)} CSVs of folder 0 and the RFP+DAPI "
            f"folder == the plain CPU run's ({ref_s:.1f} s), byte for byte: "
            + ", ".join(f"{os.path.basename(r)} {len(v) - 1} rows" for r, v in sorted(want_csv.items())))

    dden = median_label_filter_cuda(torch.from_numpy(np.stack(planes[8:10])).to(dev),
                                    acfg.denoise_size, acfg.num_classes)
    rfp, dapi = dden[0], dden[1]
    got, got_conv = dapi_dedup_device(dapi, rfp, acfg)
    want, want_conv = dapi_dedup_device(dapi.cpu(), rfp.cpu(), acfg)
    removed = int(((want == 2) & (dapi.cpu() == 1)).sum())
    if not (bool(got_conv) and bool(want_conv) and torch.equal(got.cpu(), want)) or removed == 0:
        raise AssertionError(f"phase 6: dapi_dedup_device on the card differs from the "
                             f"CPU's (or removed nothing: {removed} px)")
    log(f"phase 6 dapi_dedup_device [{H},{W}] (planes 8 and 9): kernels on the card == "
        f"plain on the CPU; {removed} of {int((dapi == 1).sum())} DAPI cell px removed")

    crop = np.stack([p[512:1536, 512:1536] for p in planes[10:12]])
    t0 = time.perf_counter()
    want = analyze_planes_device(torch.from_numpy(crop), SINGLE, acfg)
    cpu_s = time.perf_counter() - t0
    compare_outs(f"phase 6 [2,1024,1024] crop: kernels on the card vs plain on the CPU "
                 f"({cpu_s:.1f} s)", analyze_planes_device(torch.from_numpy(crop).to(dev),
                                                          SINGLE, acfg), want)

    if args.profile:
        profile_phase(planes, acfg, dev, card)
        profile_refine(x8r, rcfg, card)

    # ---- phase 8: the refine path ------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    results = refine_boundaries_stack(stack8, rcfg, REFINE_REGIONS, device=dev)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    refine_launches = read_counts()
    logs = watershed_cuda.last_logs
    log(f"phase 8 refine path: refine_boundaries_stack over [{REFINE_PLANES},{H},{W}]: "
        f"{refine_s:.2f} s wall [{card}]; watershed passes (launched, host syncs): phase 1 "
        f"{logs[0].passes} ({logs[0].launches}, {logs[0].syncs}), phase 2 {logs[1].passes} "
        f"({logs[1].launches}, {logs[1].syncs}); kernel launches {refine_launches}")
    for k in ("K2", "K3", "K7", "K9", "K10", "K11"):
        if refine_launches[k] <= 0:
            raise AssertionError(f"{k} was never launched on the refine path")
    p_labels, p_num, p_table, p_conv = plain8.pop("out")
    if not bool(p_conv.all()):
        raise AssertionError("the plain refine did not converge")
    host = type(p_table)(*(t.cpu().numpy() for t in p_table))
    cy, cx = centroids_f64(host)
    for z, r in enumerate(results):
        n = int(p_num[z])
        if (r.num_cells != n or not np.array_equal(r.labels, p_labels[z].cpu().numpy())
                or not np.array_equal(r.areas, host.area[z][1:n + 1])
                or not np.array_equal(r.centroids, np.stack([cy[z], cx[z]], 1)[1:n + 1])):
            raise AssertionError(f"phase 8 plane {z}: the refine path differs from plain")
    log(f"phase 8 refine path: labels, cell counts, areas and centroids == plain on the "
        f"card; cells per plane {[r.num_cells for r in results]}")
    crop = np.ascontiguousarray(stack8[:2, 512:1536, 512:1536])
    with tempfile.TemporaryDirectory(prefix="pcis_refine_") as tmp:
        card_csv, cpu_csv = os.path.join(tmp, "card.csv"), os.path.join(tmp, "cpu.csv")
        write_refine_stack_csv(refine_boundaries_stack(crop, rcfg, REFINE_REGIONS, device=dev),
                               card_csv)
        t0 = time.perf_counter()
        write_refine_stack_csv(refine_boundaries_stack(crop, rcfg, REFINE_REGIONS, device="cpu"),
                               cpu_csv)
        cpu_s = time.perf_counter() - t0
        with open(card_csv, "rb") as a, open(cpu_csv, "rb") as b:
            card_bytes, cpu_bytes = a.read(), b.read()
    n_rows = card_bytes.count(b"\n") - 1
    if card_bytes != cpu_bytes or n_rows < 2:
        raise AssertionError("phase 8: the crop's stack CSV differs from the plain CPU run's")
    log(f"phase 8 refine path: [2,1024,1024] crop stack CSV ({n_rows} cells) == the plain "
        f"CPU run's ({cpu_s:.1f} s), byte for byte")

    # ---- phase 9: the threshold path (configs #1 and #2) ---------------------
    threshold_launches = threshold_phase(card, c1, x1, x1b, x2, torch.from_numpy(x2k_np).to(dev),
                                         reset_counts, read_counts)
    del x1, x1b, x2, x2k_np
    torch.cuda.empty_cache()

    # ---- phase 10: config #2 from TIFFs on disk, and the host verbs ---------
    zstack_launches, zstack = zstack_phase(card, dev, reset_counts, read_counts)

    # ---- phase 11: the morphology/EDT API's times, config #4 (NanoSIMS) -----
    morph_launches, morph_times = morph_phase(card, dev, np.stack(planes[:4]), reset_counts,
                                              read_counts)
    nanosims_launches, nanosims = nanosims_phase(card, dev, reset_counts, read_counts)

    # ---- phase 12: the tunnelled refine -------------------------------------
    tunnel_launches, tunnel = tunnel_phase(card, dev, stack8, reset_counts, read_counts)

    # ---- phase 13: the data axis -----------------------------------------------
    data_launches, data_axis = data_axis_phase(card, dev, planes, stats, stack8, results, cfg,
                                               rcfg, reset_counts, read_counts)

    # ---- phase 14: the space axis ----------------------------------------------
    space_launches, space_axis = space_axis_phase(card, dev, planes, stats, cfg, acfg,
                                                  analyze_csv, reset_counts, read_counts)

    # ---- phase 15: the spatial refine --------------------------------------------
    space_refine_launches, space_refine = space_refine_phase(card, dev, stack8, results, rcfg,
                                                             reset_counts, read_counts)

    # ---- phase 16: multi-host, two processes on the card ---------------------------
    multihost_launches, multihost = multihost_phase(card, dev, x4, cfg)

    # ---- phase 17: the card's analyze_plane against the oracle at 2048² ----------
    oracle_launches, oracle = oracle_phase(card, dev, planes, acfg, reset_counts, read_counts)

    loaded = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "particle_col_image_segmentation_tpu"))
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded[:5]}")
    # bytes a pixel: inputs read, outputs written.  K10 is a whole phase 1:
    # img 4 + flags 1 in, cost 4 out; K11 a whole phase 2: cost 4 + img 4 +
    # flags 1 + markers 4 in, labels 4 out (each phase builds its starting
    # state on the card, so no starting plane is read)
    n_px = {"K1": 2, "K2": 5, "K3": 8, "K4": 5, "K5": 5, "K6": 8, "K7": 4, "K8": 2,
            "K9": 5, "K10": 9, "K11": 17}
    planes_of = {"K1": BATCH, "K2": BATCH, "K3": BATCH, "K4": BATCH, "K5": 8, "K6": 1,
                 "K7": REFINE_PLANES, "K8": 8, "K9": 16, "K10": REFINE_PLANES,
                 "K11": REFINE_PLANES}
    table_bytes = {"K3": 4 * BATCH, "K4": 8 * BATCH * (MAX_REGIONS + 1), "K5": 40 * 8 * R1,
                   "K6": 4 * R1, "K7": 20 * REFINE_PLANES * R1r, "K8": 4 * 8}
    bound_ms = {k: (n_px[k] * planes_of[k] * H * W + table_bytes.get(k, 0))
                / HBM_BYTES_PER_S * 1e3 for k in n_px}
    more_shapes = {k: [v] for k, v in more_shapes.items()}
    basins = tunnel["reliefs"]["smooth"]
    more_shapes["K2"].append({
        "shape": f"[{REFINE_PLANES},{H},{W}] relief's basin mask int32, background=0, 4-connected",
        "ms": basins["basin_k2_ms"], "plain_ms": basins["basin_plain_ms"],
        "bound_ms": basins["basin_k2_bound_ms"], "bound_by": "bytes", "library_ms": None})
    paths = {"batch": batch_launches, "analyze": analyze_launches, "refine": refine_launches,
             "threshold": threshold_launches, "zstack": zstack_launches,
             "morphology": morph_launches, "nanosims": nanosims_launches,
             "tunnel": tunnel_launches, "data_axis": data_launches,
             "space_axis": space_launches, "space_refine": space_refine_launches,
             "multihost": multihost_launches, "oracle": oracle_launches}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SRC + src, "replaces": TPU + tpu,
         "launches": sum(v[k] for v in paths.values()),
         "launches_by_path": {p: v[k] for p, v in paths.items()},
         "max_abs_err": err[k], "ms": ms[k], "plain_ms": plain_ms[k],
         "bound_ms": bound_ms[k], "bound_by": "bytes", "library_ms": library_ms.get(k),
         **({"more_shapes": more_shapes[k]} if k in more_shapes else {})}
        for k, name, src, tpu in KERNELS
    ], "zstack": zstack, "nanosims": nanosims, "morphology": morph_times, "tunnel": tunnel,
        "data_axis": data_axis, "space_axis": space_axis, "space_refine": space_refine,
        "multihost": multihost, "oracle": oracle}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
