"""Throughput benchmark of the port: the root ``bench.py``'s record, measured
on the card.

Configs #1-#5 in ``bench.py``'s order, each function named after its
counterpart there:

  #5 ``bench_device``        fused segmentation of [32,2048²] label planes
     ``bench_reference_cpu`` scipy median + the oracle's CCL/regionprops
     ``check_mask_parity``   the card's labels against the oracle's
  #3 ``watershed_boundary_iou`` refine's boundary IoU against the oracle's
                             priority flood, and refine MP/s on [32,512²]
  #1 ``bench_config1``       Otsu + CCL count of a 512² uint16 plane
  #2 ``bench_config2``       z-stack TIFFs → decode → copy → blur + count
  #4 ``bench_config4``       NanoSIMS per-ROI isotope sums
     ``measure_copy_gbps``   the device's memory rate through ``x + 1.0``

``main`` prints one JSON line on stdout, last, with ``bench.py``'s keys
and meanings plus ``device`` (the card's name), ``power_limit`` (the
``nvidia-smi --query-gpu=name,power.limit`` line) and ``launches`` (K1-K12,
the blur kernel and the maxima pair over the whole run); progress goes to
stderr.  ``vs_baseline`` divides by the pinned CPU figure of
``BASELINE.json`` at the checkout root, or by this run's CPU figure where
that file is absent.

``--device`` defaults to ``cuda`` and never falls back: without a Hopper
card it raises.  ``--device cpu`` runs the plain PyTorch versions at
``bench.py``'s fallback sizes and returns its fallback record (headline
fields null, the configs under ``fallback_smoke``).

Run as ``python -m particle_col_image_segmentation_tpu_torch bench
[--device cuda|cpu]`` or ``python -m
particle_col_image_segmentation_tpu_torch.bench``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

H = W = 2048
BATCH = 32
ITERS = 6
# capacity ≥ the planes' ~12.6k regions
MAX_REGIONS = 16383
BASELINE = Path(__file__).resolve().parent.parent / "BASELINE.json"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The sizes of one run: the card's, or ``bench.py``'s CPU fallback."""

    batch: int = BATCH  # config #5 planes
    iters: int = ITERS  # config #5 passes a window
    relief: int = 512  # config #3 relief side
    refine_planes: int = 32  # config #3 throughput stack
    c1: int = 512  # config #1 plane side
    c1_planes: int = 16  # config #1 batch
    zstack: tuple = (512, 24, 4)  # config #2 (side, planes, stacks)
    # warm-up calls, and the best of several windows of several calls; the
    # CPU fallback times one call once (its numbers are coverage, not speed)
    warm: bool = True


FULL = Sizes()
FALLBACK = Sizes(batch=2, iters=1, relief=128, refine_planes=2, c1=128, c1_planes=2,
                 zstack=(128, 4, 1), warm=False)


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_s(fn, dev, sizes: Sizes, reps: int, windows: int = 2, warmups: int = 1):
    """(seconds a call of fn, the last call's result): ``warmups`` calls,
    then the best of ``windows`` windows of ``reps`` calls, each window
    ended by one sync and timed by the host's clock.  Without
    ``sizes.warm``, one window of one call and no warm-up."""
    if not sizes.warm:
        reps, windows, warmups = 1, 1, 0
    for _ in range(warmups):
        fn()
    best = float("inf")
    for _ in range(windows):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best, out


# ---- inputs (each bench.py's recipe, the same draws) --------------------------

def make_plane(seed: int) -> np.ndarray:
    """Synthetic 2048² label plane with reference-like structure."""
    rng = np.random.default_rng(seed)
    arr = np.full((H, W), 3, np.uint8)  # background
    yy, xx = np.mgrid[:256, :256]
    for _ in range(6):  # particles
        cy, cx = rng.integers(200, H - 200, 2)
        r = int(rng.integers(60, 120))
        y0, x0 = cy - 128, cx - 128
        m = (yy - 128) ** 2 + (xx - 128) ** 2 <= r * r
        arr[y0 : y0 + 256, x0 : x0 + 256][m] = 2
    for _ in range(3000):  # cells
        cy, cx = rng.integers(8, H - 8, 2)
        r = int(rng.integers(2, 5))
        sl = arr[cy - r : cy + r + 1, cx - r : cx + r + 1]
        dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
        sl[dy * dy + dx * dx <= r * r] = 1
    # speckle noise for the median filter to clean
    noise = rng.random((H, W)) < 0.01
    arr[noise] = rng.integers(1, 4, noise.sum()).astype(np.uint8)
    return arr


def _add_discs(plane: np.ndarray, rng, discs: int) -> None:
    """Configs #1 and #2's bright particles, in place: ``discs`` discs of
    +20000 with centres in [20, n − 20) and r² in [30, 200).  Each is drawn
    in a 31×31 window around its centre (r < 15), which equals bench.py's
    full-plane masks."""
    n = plane.shape[-1]
    for _ in range(discs):
        cy, cx = rng.integers(20, n - 20, 2)
        r2 = int(rng.integers(30, 200))
        window = np.s_[cy - 15 : cy + 16, cx - 15 : cx + 16]
        yy, xx = np.mgrid[window]
        plane[window][(yy - cy) ** 2 + (xx - cx) ** 2 <= r2] += 20000


def config1_plane(n: int) -> np.ndarray:
    """Config #1's uint16 plane: noise below 400 and 40 bright particles."""
    rng = np.random.default_rng(1)
    img = (rng.random((n, n)) * 400).astype(np.uint16)
    _add_discs(img, rng, 40)
    return img


def config2_stacks(n: int, planes: int, stacks: int) -> list:
    """Config #2's uint16 z-stacks, drawn in sequence from one generator:
    noise below 400 on every plane, then 30 bright particles a plane."""
    rng = np.random.default_rng(2)
    out = []
    for _ in range(stacks):
        stack = (rng.random((planes, n, n)) * 400).astype(np.uint16)
        for p in range(planes):
            _add_discs(stack[p], rng, 30)
        out.append(stack)
    return out


def relief(n: int) -> np.ndarray:
    """Config #3's relief: 30 touching disc pairs, prob = 1 − edt/max."""
    from scipy import ndimage as ndi

    rng = np.random.default_rng(0)
    m = np.zeros((n, n), bool)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(30):  # touching cell pairs
        cy, cx = rng.integers(40, n - 40, 2)
        r2 = int(rng.integers(150, 400))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        m |= (yy - cy) ** 2 + (xx - cx - int(1.5 * np.sqrt(r2))) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def config4_inputs():
    """Config #4's painted acquisition: (labels int32 [768,768] with 121
    square ROIs on a 66-px grid, ROI count, isotopes float32 [7,512,512])."""
    rng = np.random.default_rng(3)
    Hp = Wp = 768
    acq = 512
    labels = np.zeros((Hp, Wp), np.int32)
    k = 1
    for gy in range(0, Hp - 48, 66):
        for gx in range(0, Wp - 48, 66):
            if k > 128:
                break
            labels[gy + 4 : gy + 40, gx + 4 : gx + 40] = k
            k += 1
    iso = rng.random((7, acq, acq)).astype(np.float32)
    return labels, k - 1, iso


def _cpu_otsu(img: np.ndarray) -> float:
    """numpy Otsu threshold (shared by the config #1/#2 CPU baselines so
    their binning semantics cannot silently diverge)."""
    counts, edges = np.histogram(img, bins=256)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(counts)
    w1 = w0[-1] - w0
    m = np.cumsum(counts * centers)
    mu0 = m / np.maximum(w0, 1e-12)
    mu1 = (m[-1] - m) / np.maximum(w1, 1e-12)
    var_b = np.where((w0 > 0) & (w1 > 0), w0 * w1 * (mu0 - mu1) ** 2, -1)
    return float(centers[np.argmax(var_b)])


# ---- the configs ----------------------------------------------------------------

def bench_device(batch: np.ndarray, dev, sizes: Sizes = FULL) -> float:
    """Config #5: MP/s of ``fused_segment_batch`` on ``batch``: 4 warm-up
    passes, then the best of 2 windows of ``sizes.iters`` passes.  On the
    card, the same window's CUDA-event time goes to the log."""
    import torch

    from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
    from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch

    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    x = torch.from_numpy(batch).to(dev)

    def segment_pass():
        return fused_segment_batch(x, cfg, particle_val=2, cell_vals=(1,))

    best, out = _best_s(segment_pass, dev, sizes, sizes.iters, warmups=4)
    if not bool(out[-1].all()):
        raise RuntimeError("config #5: the fused pass did not converge")
    del out
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(sizes.iters):
            segment_pass()
        end.record()
        end.synchronize()
        log(f"config #5 fused_segment_batch {list(batch.shape)}: "
            f"{start.elapsed_time(end) / sizes.iters} ms a pass by CUDA events, "
            f"{best * 1e3} ms by the host's clock")
    return len(batch) * H * W / 1e6 / best


def bench_reference_cpu(plane: np.ndarray):
    """Reference path: scipy median + the oracle's CCL + regionprops.
    Returns (MP/s, oracle denoised plane, oracle label ids)."""
    from scipy import ndimage as ndi

    from particle_col_image_segmentation_tpu_torch.oracle import ndimage as ond

    best = float("inf")
    den = lab = None
    for _ in range(2):  # best-of-2 damps host scheduling noise
        t0 = time.perf_counter()
        den = ndi.median_filter(plane, size=5)
        lab = ond.label(den, background=-1)
        regions = ond.regionprops(lab)
        _ = sum(r.area for r in regions if den[r.coords[0][0], r.coords[0][1]] == 2)
        best = min(best, time.perf_counter() - t0)
    return (H * W / 1e6) / best, den, lab


def check_mask_parity(plane: np.ndarray, oracle_lab: np.ndarray, dev) -> bool:
    """Exact integer-mask parity of the device pass against the oracle."""
    import torch

    from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
    from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch
    from particle_col_image_segmentation_tpu_torch.utils.metrics import masks_equal

    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    seg, *_ = fused_segment_batch(torch.from_numpy(plane[None]).to(dev), cfg)
    return masks_equal(seg[0].cpu().numpy(), oracle_lab)


def _oracle_iou(p: np.ndarray, labels: np.ndarray) -> float:
    """Boundary IoU of ``labels`` against the oracle's priority flood of p."""
    from scipy import ndimage as ndi

    from particle_col_image_segmentation_tpu_torch.oracle import ndimage as ond
    from particle_col_image_segmentation_tpu_torch.utils.metrics import boundary_iou

    binary = p < 0.5
    odist = ndi.distance_transform_edt(binary)
    omark = ond.label(ond.local_maxima(odist).astype(np.uint8))
    oref = ond.watershed(p, omark, mask=binary)
    return boundary_iou(labels, oref)


def quantize16(prob: np.ndarray) -> np.ndarray:
    """The 16-level quantization of a relief (an Ilastik uint8 export's
    plateaus at their harshest realistic depth)."""
    return (np.round(prob * 15.0) / 15.0).astype(np.float32)


def watershed_boundary_iou(dev, sizes: Sizes = FULL):
    """Config #3: (boundary IoU of ``refine_boundaries`` against the
    oracle's priority flood on the relief, the same on its 16-level
    quantization, refine MP/s on a stack of the relief rolled 17 px a
    plane: the best of 3 windows of 3 calls)."""
    import torch

    from particle_col_image_segmentation_tpu_torch.config import RefineConfig
    from particle_col_image_segmentation_tpu_torch.models.refine import (
        refine_boundaries,
        refine_plane_device,
    )

    n = sizes.relief
    prob = relief(n)
    res = refine_boundaries(prob, device=dev)

    B = sizes.refine_planes
    stack = torch.from_numpy(np.stack([np.roll(prob, 17 * b, axis=1) for b in range(B)])).to(dev)
    rcfg = RefineConfig()
    best, out = _best_s(lambda: refine_plane_device(stack, rcfg, 4095), dev, sizes, 3, 3)
    if not bool(out[-1].all()):
        raise RuntimeError("config #3: refine_plane_device did not converge")
    refine_mps = (B * n * n / 1e6) / best

    iou = _oracle_iou(prob, res.labels)
    q16 = quantize16(prob)
    iou_q16 = _oracle_iou(q16, refine_boundaries(q16, device=dev).labels)
    return iou, iou_q16, refine_mps


def bench_config1(dev, sizes: Sizes = FULL):
    """Config #1: Otsu threshold + CCL particle count on one 16-bit plane.
    Returns (MP/s a call, against the CPU, MP/s of the batched call on
    ``sizes.c1_planes`` planes resident on the device)."""
    import torch

    from particle_col_image_segmentation_tpu_torch.oracle import ndimage as ond
    from particle_col_image_segmentation_tpu_torch.ops.threshold import (
        threshold_and_count,
        threshold_and_count_batch,
    )

    n = sizes.c1
    img = config1_plane(n)
    x = torch.from_numpy(img).to(dev)
    best, out = _best_s(lambda: threshold_and_count(x, max_regions=4095), dev, sizes, 20)
    if int(out[2]) <= 0:
        raise RuntimeError("config #1: no particle counted")
    dev_mps = (n * n / 1e6) / best

    Bc = sizes.c1_planes
    xb = torch.from_numpy(np.stack([np.roll(img, 7 * b, axis=1) for b in range(Bc)])).to(dev)
    best_c, _ = _best_s(lambda: threshold_and_count_batch(xb, max_regions=4095), dev, sizes, 10)
    compute_mps = (Bc * n * n / 1e6) / best_c

    # CPU path: numpy Otsu + the oracle's CCL
    t0 = time.perf_counter()
    lab = ond.label((img > _cpu_otsu(img)).astype(np.uint8), background=0)
    _ = lab.max()
    cpu_mps = (n * n / 1e6) / (time.perf_counter() - t0)
    return dev_mps, dev_mps / cpu_mps, compute_mps


def stack_stats(x):
    """Config #2's per-stack compute (``models.zstack.zstack_stats_device``:
    the contracted Gaussian blur at σ 1, as bench.py's jitted graph gives
    it, then per-plane Otsu, CCL and counts); count + num a plane."""
    from particle_col_image_segmentation_tpu_torch.models.zstack import zstack_stats_device

    r = zstack_stats_device(x)
    return r.count + r.num_fg


def bench_config2(tmpdir: str, dev, sizes: Sizes = FULL):
    """Config #2: z-stack TIFFs through the port's native codec, a pageable
    host-to-device copy and ``stack_stats``.  Returns (end-to-end MP/s,
    against the CPU, MP/s of ``stack_stats`` on device-resident stacks)."""
    import torch
    from PIL import Image
    from scipy import ndimage as sndi

    from particle_col_image_segmentation_tpu_torch.io import native
    from particle_col_image_segmentation_tpu_torch.io.tiff import read_tiff_stack
    from particle_col_image_segmentation_tpu_torch.oracle import ndimage as ond

    n, planes, stacks = sizes.zstack
    paths = []
    for s, stack in enumerate(config2_stacks(n, planes, stacks)):
        path = os.path.join(tmpdir, f"stack{s}_zstack.tif")
        ims = [Image.fromarray(p) for p in stack]  # multi-page write via PIL
        ims[0].save(path, save_all=True, append_images=ims[1:])
        paths.append(path)
    # the codec builds on first use: build it before the timer, and never
    # time PIL's fallback reads
    if not native.available():
        raise RuntimeError("config #2: the native TIFF codec did not build or load")
    if sizes.warm:
        stack_stats(torch.zeros((planes, n, n), dtype=torch.uint16, device=dev))

    _sync(dev)
    t0 = time.perf_counter()
    npx = 0
    for path in paths:
        stack = read_tiff_stack(path)
        stack_stats(torch.from_numpy(stack).to(dev))
        npx += stack.size
    _sync(dev)
    dt = time.perf_counter() - t0
    dev_mps = (npx / 1e6) / dt

    staged = [torch.from_numpy(read_tiff_stack(p)).to(dev) for p in paths]
    best_c, _ = _best_s(lambda: [stack_stats(s) for s in staged], dev, sizes, 3)
    compute_mps = (npx / 1e6) / best_c

    # CPU: the same per-stack pipeline on one stack, the decode inside the timer
    t0 = time.perf_counter()
    stack_np = np.asarray(read_tiff_stack(paths[0]))
    for plane in stack_np:
        den = sndi.gaussian_filter(plane.astype(np.float32), sigma=1.0)
        lab = ond.label((den > _cpu_otsu(den)).astype(np.uint8), background=0)
        _ = np.bincount(lab.ravel())
    cpu_mps = (stack_np.size / 1e6) / (time.perf_counter() - t0)
    return dev_mps, dev_mps / cpu_mps, compute_mps


def bench_config4(dev, sizes: Sizes = FULL):
    """Config #4: NanoSIMS per-ROI isotope sums and centroids of one
    painted acquisition.  Returns (ms an acquisition, ROIs/s, against the
    CPU)."""
    import torch
    from scipy.ndimage import zoom

    from particle_col_image_segmentation_tpu_torch.models.nanosims import roi_sums_and_centroids

    labels, n_rois, iso_np = config4_inputs()
    acq = iso_np.shape[-1]
    iso = torch.from_numpy(iso_np).to(dev)
    lab = torch.from_numpy(labels).to(dev)

    best, _ = _best_s(lambda: roi_sums_and_centroids(lab, iso, 128, acq), dev, sizes, 5)

    # CPU: the per-ROI loop (cubic mask resize + masked isotope sums) on 8
    # sample ROIs with scipy
    sample = 8
    t0 = time.perf_counter()
    for rid in range(1, sample + 1):
        m = (labels == rid).astype(np.float32)
        resized = zoom(m, acq / labels.shape[0], order=3, grid_mode=True, mode="grid-constant")
        _ = (resized[None] * iso_np).sum(axis=(1, 2))
        solid = np.floor(resized) >= 1
        _ = np.nonzero(solid)
    cpu_rois_per_s = sample / (time.perf_counter() - t0)
    return best * 1e3, n_rois / best, (n_rois / best) / cpu_rois_per_s


def measure_copy_gbps(dev) -> float:
    """The device's memory rate through one elementwise pass: ``x + 1.0``
    and a sum on a [2048,2048] float32 tensor, 8 times; 2 × x.nbytes over
    the time of one."""
    import torch

    x = torch.ones((2048, 2048), dtype=torch.float32, device=dev)
    _ = float((x + 1.0).sum())
    t0 = time.perf_counter()
    accs = [(x + 1.0).sum() for _ in range(8)]
    _ = float(sum(accs))
    dt = (time.perf_counter() - t0) / 8
    return (2 * x.nbytes / 1e9) / dt


# ---- the record -----------------------------------------------------------------

def card_line(dev) -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the card (None where nvidia-smi cannot say)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        return res.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _baseline_mps(live_cpu_mps: float) -> float:
    try:
        with open(BASELINE) as f:
            return json.load(f)["pinned_cpu"]["fused_segmentation_mps"]
    except (OSError, KeyError, json.JSONDecodeError):
        return live_cpu_mps


def run(dev) -> dict:
    """Every config on ``dev`` (full sizes on the card, ``bench.py``'s
    fallback sizes on the CPU); the record."""
    import torch

    from particle_col_image_segmentation_tpu_torch import _dispatch, _kernels

    on_card = dev.type == "cuda"
    if on_card:
        _dispatch.use_kernel(torch.empty(0, device=dev))  # raises off Hopper
        t0 = time.perf_counter()
        _kernels.library()  # the first call's build, apart from every timer
        log(f"kernels built or loaded in {time.perf_counter() - t0:.1f} s")
    sizes = FULL if on_card else FALLBACK
    reset_counts, read_counts = _kernels.launch_counters()
    reset_counts()

    t0 = time.perf_counter()
    batch = np.stack([make_plane(s) for s in range(sizes.batch)])
    log(f"{sizes.batch} planes of {H}x{W} made ({time.perf_counter() - t0:.1f} s)")
    device_mps = bench_device(batch, dev, sizes)
    log(f"config #5: {device_mps} MP/s")
    live_cpu_mps, _, oracle_lab = bench_reference_cpu(batch[0])
    baseline_mps = _baseline_mps(live_cpu_mps)
    parity = check_mask_parity(batch[0], oracle_lab, dev)
    log(f"reference CPU {live_cpu_mps} MP/s (pinned {baseline_mps}); mask parity {parity}")
    del batch, oracle_lab
    iou, iou_q16, refine_mps = watershed_boundary_iou(dev, sizes)
    log(f"config #3: IoU {iou}, 16-level {iou_q16}, refine {refine_mps} MP/s")
    c1_mps, c1_vs, c1_compute = bench_config1(dev, sizes)
    log(f"config #1: {c1_mps} MP/s, {c1_vs}x the CPU, batched {c1_compute} MP/s")
    with tempfile.TemporaryDirectory(prefix="pcis_bench_") as td:
        c2_mps, c2_vs, c2_compute = bench_config2(td, dev, sizes)
    log(f"config #2: {c2_mps} MP/s end to end, {c2_vs}x the CPU, compute {c2_compute} MP/s")
    c4_ms, c4_rois, c4_vs = bench_config4(dev, sizes)
    log(f"config #4: {c4_ms} ms an acquisition, {c4_rois} ROIs/s, {c4_vs}x the CPU")
    copy_gbps = measure_copy_gbps(dev)
    launches = read_counts()
    log(f"x + 1.0 at [2048,2048] float32: {copy_gbps} GB/s; launches {launches}")

    configs = {
        "1_otsu_count_512_mps": round(c1_mps, 1),
        "1_vs_cpu": round(c1_vs, 1),
        "1_compute_mps": round(c1_compute, 1),
        "2_zstack_e2e_mps": round(c2_mps, 1),
        "2_vs_cpu": round(c2_vs, 1),
        "2_compute_mps": round(c2_compute, 1),
        "3_refine_mps": round(refine_mps, 1),
        "3_boundary_iou": round(iou, 4),
        "3_boundary_iou_q16": round(iou_q16, 4),
        "4_nanosims_ms_per_acq": round(c4_ms, 2),
        "4_nanosims_rois_per_s": round(c4_rois, 0),
        "4_vs_cpu": round(c4_vs, 1),
        "5_fused_segmentation_mps": round(device_mps, 2),
    }
    record = {
        "metric": "fused_segmentation_throughput",
        "value": round(device_mps, 2),
        "unit": "MP/s/chip",
        "vs_baseline": round(device_mps / baseline_mps, 2),
        "vs_baseline_live": round(device_mps / live_cpu_mps, 2),
        "cpu_live_mps": round(live_cpu_mps, 2),
        "mask_exact_parity": bool(parity),
        "watershed_boundary_iou": round(iou, 4),
        "platform": "gpu" if on_card else "cpu",
        "platform_copy_gbps": round(copy_gbps, 2),
        "configs": configs,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "power_limit": card_line(dev) if on_card else None,
        "launches": launches,
    }
    if not on_card:
        # a CPU run must not be mistaken for the card's numbers: headline
        # fields go null with a reason, the configs stay under fallback_smoke
        record.update(
            value=None,
            vs_baseline=None,
            configs=None,
            fallback_smoke=configs,
            reason=(
                "--device cpu: smoke-size coverage run of the plain PyTorch "
                "versions, NOT card throughput; compare only platform=gpu records"
            ),
        )
    return record


def main(argv=None) -> int:
    from particle_col_image_segmentation_tpu_torch.cli import _add_device_flag, _device

    ap = argparse.ArgumentParser(
        prog="python -m particle_col_image_segmentation_tpu_torch.bench",
        description="Throughput benchmark of the port: bench.py's record, one JSON line.",
    )
    _add_device_flag(ap)
    args = ap.parse_args(argv)
    print(json.dumps(run(_device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
