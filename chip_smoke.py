#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one Hopper card.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

Phases (each prints as it goes; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. environment — card name and power limit, torch/CUDA versions, compute
     capability (must be 9.x), whether triton, h5py and matplotlib import
     (nothing below needs them), the nvcc in use;
  2. build — the eight kernels K1-K6, K8, K9 from csrc/ (one nvcc per
     source, in parallel), timed;
  3. kernel vs plain — each kernel against its plain PyTorch version on the
     same card tensors, exact equality (all outputs are integers, so the
     tolerance is 0): 2048² bench planes, odd [3,97,130] batches, 2-D
     planes, background=0 and 4-connected CCL, int32 values, saturating
     sums (both K4 wrappers: class tables and the dedup's clamped sums),
     table overflow (max_regions=8), out-of-range lookup ids, EDT caps
     0..32 on sparse, full and empty masks (cap > H included), fill steps
     with and without particles;
  4. batch path — run_batch over 40 bench planes in batches of 32 (the last
     one short and padded), max_regions=16383: every plane converged, no
     overflow, particle_px equal to scipy's median count; plane 0's labels
     equal to scipy's; planes 0-3 equal to the plain path on the card; K1-K4
     launched (launch counts reset just before the run);
  5. times — the fused pass on a device-resident [32,2048,2048] batch and
     K1-K4 at that shape; K5 and K8 at [8,2048,2048] (R+1 = 16385, cap 20),
     K9 at [16,2048,2048] (cap 2, the merge contexts), K6 at [2048,2048];
     analyze_planes_device on a device-resident [8,2048,2048] batch — each
     through the kernels and through the plain versions, by CUDA events (no
     thresholds);
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
  7. profile, only with --profile — see ``profile_phase``.
The line before the last is the per-kernel JSON record (``launches`` sums
the batch and analyze paths' runs); the last line is {"ok": true, ...}.

The script imports the port, bench.py's plane generator, numpy and scipy:
nothing of JAX and nothing of the JAX package directly.  CSV parity of the
port with the JAX package is held in tests/test_torch_analysis.py.
"""

import argparse
import contextlib
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
SRC = "particle_col_image_segmentation_tpu_torch/csrc/"
TPU = "particle_col_image_segmentation_tpu/ops/"
KERNELS = [  # key, name, source, TPU kernel it replaces
    ("K1", "K1 median", "median.cu", "filters_tiles.py:36"),
    ("K2", "K2 ccl", "ccl.cu", "ccl_tiles.py:177"),
    ("K3", "K3 compact", "compact.cu", "ccl_tiles.py:375"),
    ("K4", "K4 region counts", "counts.cu", "regionprops_tiles.py:80"),
    ("K5", "K5 region table", "table.cu", "regionprops_tiles.py:226"),
    ("K6", "K6 table lookup", "lookup.cu", "regionprops_tiles.py:558"),
    ("K8", "K8 particle fill", "fill.cu", "fill_tiles.py:37"),
    ("K9", "K9 capped edt", "edt.cu", "edt_tiles.py:41"),
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


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--profile", action="store_true",
                    help="also run phase 7: a torch.profiler breakdown of the analysis "
                         "graph, run_analysis walls at batch_planes 1 and 8, and the "
                         "device's traced idle share on the analyze path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1

    import numpy as np
    from scipy import ndimage as ndi

    import bench
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, _kernels
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
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        centroids_int,
        compact_labels,
        compact_labels_cuda,
        connected_components,
        edt_sq,
        edt_sq_cuda,
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
        table_lookup,
        table_lookup_cuda,
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
            if g.numel():
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

    cells4 = x4 == 1
    empty_full = torch.zeros((2, 512, 512), dtype=torch.bool, device=dev)
    empty_full[1] = True
    odd_mask = torch.from_numpy(np.random.default_rng(8).random((3, 97, 130)) < 0.02).to(dev)
    for c in (0, 2, 5, 8, 9, 20, 32):
        compare("K9", f"[4,2048,2048] cells cap={c}", [edt_sq_cuda(cells4, c)], [edt_sq(cells4, c)])
        compare("K9", f"empty and full planes cap={c}",
                [edt_sq_cuda(empty_full, c)], [edt_sq(empty_full, c)])
        compare("K9", f"odd [3,97,130] cap={c}", [edt_sq_cuda(odd_mask, c)], [edt_sq(odd_mask, c)])
    short = odd_mask[:, :20].contiguous()
    compare("K9", "[3,20,130] cap=32 > H", [edt_sq_cuda(short, 32)], [edt_sq(short, 32)])

    # ---- launch counts: reset just before a path runs, read just after -----
    counters = {
        "K1": [median_label_filter_cuda], "K2": [ccl_cuda], "K3": [compact_labels_cuda],
        "K4": [region_counts_cuda, region_sums_cuda], "K5": [region_table_cuda],
        "K6": [table_lookup_cuda], "K8": [particle_fill_step_cuda], "K9": [edt_sq_cuda],
    }

    def reset_counts() -> None:
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0

    def read_counts() -> dict:
        return {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}

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
    fused_ms = time_ms(lambda: fused_segment_batch(xb, cfg), reps=5, warmup=2)
    plain_fused_ms = time_ms(lambda: plain_fused(xb), reps=1, warmup=1)
    den = median_label_filter_cuda(xb, 5, 8)
    raw = ccl_cuda(den)
    seg, _ = compact_labels_cuda(raw, MAX_REGIONS)
    acfg = AnalysisConfig()
    fill_args = (2, 1, max(acfg.dilation_radius, acfg.distance_threshold),
                 acfg.distance_threshold ** 2, acfg.dilation_radius ** 2)
    x8, den8, seg8 = xb[:8].contiguous(), den[:8].contiguous(), seg[:8].contiguous()
    ctx16 = torch.cat([den8 == 1, den8 == 1])  # one strain: its mask, then the union
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
    shapes = {k: f"[{BATCH},{H},{W}]" for k in ("K1", "K2", "K3", "K4")}
    shapes.update(K5=f"[8,{H},{W}] R+1={R1}", K6=f"[{H},{W}] R={R1}",
                  K8=f"[8,{H},{W}] cap {fill_args[2]}",
                  K9=f"[16,{H},{W}] cap {acfg.merge_disk_radius}")
    log(f"phase 5 times [{card}]: fused pass [{BATCH},{H},{W}] kernels "
        f"{fused_ms:.3f} ms = {mp / fused_ms * 1e3:.1f} MP/s; plain "
        f"{plain_fused_ms:.3f} ms = {mp / plain_fused_ms * 1e3:.1f} MP/s")
    for k in ms:
        log(f"phase 5 times [{card}]: {k} kernel {ms[k]:.3f} ms, plain "
            f"{plain_ms[k]:.3f} ms at {shapes[k]}")
    del den, raw, seg

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
    log(f"phase 5 peak device memory: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

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
        for k, n in analyze_launches.items():
            if n <= 0:
                raise AssertionError(f"{k} was never launched on the analyze path")

        # the same flow through the plain versions on the CPU, over folder 0
        # and the RFP+DAPI folder (dedup, fusion, merged re-analysis)
        ref_root = os.path.join(tmp, "ref")
        seed_of.update(make_tree(ref_root, [0]))
        t0 = time.perf_counter()
        run_analysis(ref_root, acfg, make_figures=False, device="cpu", load_fn=load_fn)
        ref_s = time.perf_counter() - t0
        got_csv, want_csv = csv_lines(root), csv_lines(ref_root)
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
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SRC + src, "replaces": TPU + tpu,
         "launches": batch_launches[k] + analyze_launches[k],
         "launches_by_path": {"batch": batch_launches[k], "analyze": analyze_launches[k]},
         "max_abs_err": err[k], "ms": ms[k], "plain_ms": plain_ms[k]}
        for k, name, src, tpu in KERNELS
    ]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
