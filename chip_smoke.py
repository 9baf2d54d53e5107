#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one Hopper card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints as it goes; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. environment — card name and power limit, torch/CUDA versions, compute
     capability (must be 9.x), whether triton imports, the nvcc in use;
  2. build — the four kernels K1-K4 from csrc/, timed;
  3. kernel vs plain — each kernel against its plain PyTorch version on the
     same card tensors, exact equality (all outputs are integers, so the
     tolerance is 0): four 2048² bench planes, an odd [3,97,130] batch, a 2-D
     plane, background=0 and 4-connected CCL, int32 values, a saturating
     table sum and a table overflow (max_regions=8);
  4. main path — run_batch over 40 bench planes in batches of 32 (the last
     one short and padded), max_regions=16383: every plane converged, no
     overflow, particle_px equal to scipy's median count; plane 0's labels
     equal to scipy's (median filter, then per-class labelling); planes 0-3
     equal to the plain path on the card; every kernel launched (launch
     counts reset just before the run);
  5. times — the fused pass on a device-resident [32,2048,2048] batch and
     each kernel, through the kernels and through the plain versions, with
     CUDA events (no thresholds).
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.

The script imports the port, bench.py's plane generator, numpy and scipy:
nothing of JAX and nothing of the JAX package directly.
"""

import json
import subprocess
import sys
import time

H = W = 2048
BATCH = 32
MAX_REGIONS = 16383
N_MAIN = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1

    import numpy as np
    from scipy import ndimage as ndi

    import bench
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, _kernels
    from particle_col_image_segmentation_tpu_torch.models.batch import (
        _pixel_stats_from_tables,
        fused_segment_batch,
        run_batch,
    )
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        compact_labels,
        compact_labels_cuda,
        connected_components,
        median_label_filter,
        median_label_filter_cuda,
        region_counts,
        region_counts_cuda,
    )

    # ---- phase 1: environment -------------------------------------------
    card = card_line()
    dev = torch.device("cuda:0")
    cap = torch.cuda.get_device_capability(dev)
    try:
        import triton

        triton_state = f"imports ({triton.__version__})"
    except ImportError as e:
        triton_state = f"does not import ({e})"
    log(f"phase 1 env: card [{card}]")
    log(f"phase 1 env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {cap}, devices {torch.cuda.device_count()}, python "
        f"{sys.version.split()[0]}")
    log(f"phase 1 env: triton {triton_state}; nvcc {_kernels._nvcc()}")
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
    err = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def compare(kernel: str, case: str, got, want) -> None:
        torch.cuda.synchronize()
        d = 0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{kernel} {case}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            if g.numel():
                d = max(d, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        err[kernel] = max(err[kernel], d)
        log(f"phase 3 {kernel} {case}: max |kernel - plain| = {d}")
        if d != 0:
            raise AssertionError(f"{kernel} {case}: kernel disagrees with plain")

    def chain(x, case: str, max_regions: int = MAX_REGIONS):
        """K1..K4 on x, each against its plain version on the same input."""
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
        return den, raw, seg

    planes = [bench.make_plane(s) for s in range(N_MAIN)]
    x4 = torch.from_numpy(np.stack(planes[:4])).to(dev)
    chain(x4, "[4,2048,2048] bench planes")
    rng = np.random.default_rng(7)
    odd = np.stack([p[:97, :130] for p in planes[4:7]])
    odd[rng.random(odd.shape) < 0.05] = 1
    den, raw, seg = chain(torch.from_numpy(odd).to(dev), "odd [3,97,130]")
    compare("K4", "odd [3,97,130] max_regions=8 (overflow)",
            list(region_counts_cuda(seg, den, 8)), list(region_counts(seg, den, 8)))
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
    big = torch.zeros((2, 512, 512), dtype=torch.int32, device=dev)
    big_vals = torch.full((2, 512, 512), 16383, dtype=torch.int32, device=dev)
    big_vals[1] = -16384
    compare("K4", "int32 values, saturating sums",
            list(region_counts_cuda(big, big_vals, 4)),
            list(region_counts(big, big_vals, 4)))

    # ---- phase 4: the main path --------------------------------------------
    counters = {
        "K1": median_label_filter_cuda,
        "K2": ccl_cuda,
        "K3": compact_labels_cuda,
        "K4": region_counts_cuda,
    }
    paths = [str(i) for i in range(N_MAIN)]
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = dict(run_batch(paths, lambda p: planes[int(p)], cfg, device=dev,
                           batch_size=BATCH, particle_val=2, cell_vals=(1,)))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 4 main path: run_batch over {N_MAIN} planes of {H}x{W} in "
        f"batches of {BATCH}: {main_s:.2f} s wall; kernel launches {launches}")
    if sorted(stats) != sorted(paths):
        raise AssertionError(f"run_batch yielded {len(stats)} of {N_MAIN} planes")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was never launched on the main path")
    for p, s in stats.items():
        want = int((ndi.median_filter(planes[int(p)], size=5) == 2).sum())
        if not s.converged or s.overflow or s.particle_px != want:
            raise AssertionError(f"plane {p}: {s} (scipy particle_px {want})")
    log(f"phase 4 main path: all {N_MAIN} planes converged, no overflow, "
        f"particle_px == scipy median count; regions per plane "
        f"{min(s.num_regions for s in stats.values())}.."
        f"{max(s.num_regions for s in stats.values())}")
    seg0, num0 = (t[0].cpu().numpy() for t in fused_segment_batch(x4[:1], cfg)[:2])
    ref0, ref_num0 = scipy_labels(ndi.median_filter(planes[0], size=5))
    if int(num0) != ref_num0 or not np.array_equal(seg0, ref0):
        raise AssertionError("plane 0: labels differ from scipy's")
    log(f"phase 4 main path: plane 0 labels == scipy median + per-class "
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
            raise AssertionError(f"plane {b}: main path {got} != plain {want}")
    log("phase 4 main path: planes 0-3 stats == plain path on the card")
    del ref

    # ---- phase 5: times ----------------------------------------------------
    xb = torch.from_numpy(np.stack(planes[:BATCH])).to(dev)
    mp = BATCH * H * W / 1e6
    fused_ms = time_ms(lambda: fused_segment_batch(xb, cfg), reps=5, warmup=2)
    plain_fused_ms = time_ms(lambda: plain_fused(xb), reps=1, warmup=1)
    den = median_label_filter_cuda(xb, 5, 8)
    raw = ccl_cuda(den)
    seg, _ = compact_labels_cuda(raw, MAX_REGIONS)
    ms = {
        "K1": time_ms(lambda: median_label_filter_cuda(xb, 5, 8), reps=10),
        "K2": time_ms(lambda: ccl_cuda(den), reps=10),
        "K3": time_ms(lambda: compact_labels_cuda(raw, MAX_REGIONS), reps=10),
        "K4": time_ms(lambda: region_counts_cuda(seg, den, MAX_REGIONS), reps=10),
    }
    plain_ms = {
        "K1": time_ms(lambda: median_label_filter(xb, 5, 8), reps=2),
        "K2": time_ms(lambda: connected_components(den, max_iters=cfg.ccl_max_iters), reps=1),
        "K3": time_ms(lambda: compact_labels(raw, MAX_REGIONS), reps=2),
        "K4": time_ms(lambda: region_counts(seg, den, MAX_REGIONS), reps=2),
    }
    log(f"phase 5 times [{card}]: fused pass [{BATCH},{H},{W}] kernels "
        f"{fused_ms:.3f} ms = {mp / fused_ms * 1e3:.1f} MP/s; plain "
        f"{plain_fused_ms:.3f} ms = {mp / plain_fused_ms * 1e3:.1f} MP/s")
    for k in ms:
        log(f"phase 5 times [{card}]: {k} kernel {ms[k]:.3f} ms, plain "
            f"{plain_ms[k]:.3f} ms at [{BATCH},{H},{W}]")
    log(f"phase 5 peak device memory: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    source = "particle_col_image_segmentation_tpu_torch/csrc/"
    kernels = [
        ("K1 median", "median.cu", "particle_col_image_segmentation_tpu/ops/filters_tiles.py:36", "K1"),
        ("K2 ccl", "ccl.cu", "particle_col_image_segmentation_tpu/ops/ccl_tiles.py:177", "K2"),
        ("K3 compact", "compact.cu", "particle_col_image_segmentation_tpu/ops/ccl_tiles.py:375", "K3"),
        ("K4 region counts", "counts.cu", "particle_col_image_segmentation_tpu/ops/regionprops_tiles.py:80", "K4"),
    ]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source + src, "replaces": tpu,
         "launches": launches[k], "max_abs_err": err[k], "ms": ms[k],
         "plain_ms": plain_ms[k]}
        for name, src, tpu, k in kernels
    ]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
