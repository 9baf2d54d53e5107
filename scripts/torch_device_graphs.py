#!/usr/bin/env python3
"""Device times of the PyTorch/CUDA port's three device graphs and of its
kernels K3, K4, K5, K7, K8 and K9, for comparing two checkouts on one card.

Run from the root of a checkout of the port; the script imports the port,
``bench.py`` and ``chip_smoke.py`` from the working directory, so the same
script times any checkout:

    cd <checkout> && python3 <path>/scripts/torch_device_graphs.py [--tag NAME]

To compare two trees, run it in turns in one call (parent, change, change,
parent).  Prints one JSON line: the card's name and power limit;
``fused_segment_batch`` on a device-resident [32,2048,2048] batch of bench
planes (ms by CUDA events, and its peak device memory above what was held
before it); ``compact_labels_cuda`` (K3) and ``region_counts_cuda`` (K4) at
that shape; ``analyze_planes_device`` on [8,2048,2048] (ms by CUDA
events, and under torch.profiler over 3 calls its device ms a call and the
device ms of each kernel name); ``region_table_cuda`` (K5) and
``particle_fill_step_cuda`` (K8) at the analyze path's shapes [8,2048,2048]
and [1,2048,2048] (R+1 = 16385, cap 20) and ``edt_sq_cuda`` (K9) on its
[16,2048,2048] merge contexts at cap 2, each by CUDA events and by its
device time a call under torch.profiler (a fast call's events also hold
the host's launch gaps), K8 at [8,2048,2048] with no cell pixel and with
every cell pixel filling, and the tiles of K8's one-kernel route that the
[8,2048,2048] planes leave live;
``refine_plane_device`` on the [8,2048,2048] touching-cell relief; on that
relief K9 as refine's probe (``edt_sq_cuda`` at cap 32 on the complement of
its boundary mask, and ``edt_sq_exact_auto`` as refine calls it, with its
certificate's host sync) and K7 (``centroid_sums_cuda`` of its watershed
labels, R+1 = 4096), each by CUDA events and by device time a call; and each
watershed phase on that relief (``minimax_costs_cuda`` for K10,
``claim_labels_cuda`` for K11: ms with the whole pass loop; the loop's
passes, or its PhaseLog where the checkout has one; and, under
torch.profiler over 3 calls, the device ms of every pass it launched by
launch index, their sum, and the phase's other device work: flag rows,
copies, the final ``where``).
"""

import argparse
import json
import os
import sys


def live_fill_tiles(den, pval: int, sval: int, cap: int) -> list:
    """[tiles, of all] of K8's one-kernel route that cannot be skipped on
    these planes: a 64 x 128 tile holding a ``sval`` pixel whose window (cap
    rows and 32 * ceil(cap / 32) columns around it) holds a ``pval`` pixel."""
    import torch.nn.functional as F

    B, H, W = den.shape
    e = 32 * ((cap + 31) // 32)
    ph, pw = -H % 64, -W % 128
    p = F.pad((den == pval).float()[:, None], (e, pw + e, cap, ph + cap))
    s = F.pad((den == sval).float()[:, None], (0, pw, 0, ph))
    window = F.max_pool2d(p, (64 + 2 * cap, 128 + 2 * e), stride=(64, 128))
    has_s = F.max_pool2d(s, (64, 128), stride=(64, 128))
    return [int((window * has_s).sum()), has_s.numel()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default=os.getcwd(), help="label of this checkout in the output")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_device_graphs: CUDA is not available", file=sys.stderr)
        return 1

    import bench
    from chip_smoke import SINGLE, busy_us, card_line, device_intervals, refine_relief, time_ms
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, RefineConfig
    from particle_col_image_segmentation_tpu_torch.labels.analysis import analyze_planes_device
    from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch
    from particle_col_image_segmentation_tpu_torch.models.refine import refine_plane_device
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        centroid_sums_cuda,
        compact_labels_cuda,
        edt_sq_cuda,
        edt_sq_exact_auto,
        local_maxima_auto,
        median_label_filter_cuda,
        particle_fill_step_cuda,
        region_counts_cuda,
        region_table_cuda,
    )
    from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
        claim_labels_cuda,
        minimax_costs_cuda,
    )

    dev = torch.device("cuda:0")
    cfg = AnalysisConfig(max_regions=16383)
    xb = torch.from_numpy(np.stack([bench.make_plane(s) for s in range(32)])).to(dev)
    fused_segment_batch(xb, cfg)  # builds the kernels
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fused_ms = time_ms(lambda: fused_segment_batch(xb, cfg), reps=10, warmup=2)
    fused_peak = torch.cuda.max_memory_allocated(dev) - held
    den = median_label_filter_cuda(xb, 5, 8)
    raw = ccl_cuda(den)
    seg, _ = compact_labels_cuda(raw, 16383)
    k3_ms = time_ms(lambda: compact_labels_cuda(raw, 16383), reps=20)
    k4_ms = time_ms(lambda: region_counts_cuda(seg, den, 16383), reps=20)
    x8 = xb[:8].contiguous()
    del xb, den, raw, seg
    acfg = AnalysisConfig()
    analyze_ms = time_ms(lambda: analyze_planes_device(x8, SINGLE, acfg), reps=5)

    def traced(fn, reps):
        """Device intervals of reps fn() calls under torch.profiler, in time
        order, after one untraced call; a trace with no device activity (the
        profiler drops one now and then) is taken again, three times at most.
        (chip_smoke's own helper is newer than some trees this script times.)"""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            intervals = sorted(device_intervals(prof))
            if intervals:
                break
        return intervals

    intervals = traced(lambda: analyze_planes_device(x8, SINGLE, acfg), 3)
    analyze_device_ms = busy_us(intervals) / 3e3
    by_name = {}
    for s, e, name in intervals:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 3e3
    analyze_trace = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:16])
    # K5, K8 and K9 at the analyze path's shapes
    den8 = median_label_filter_cuda(x8, acfg.denoise_size, acfg.num_classes)
    seg8, _ = compact_labels_cuda(ccl_cuda(den8), acfg.max_regions)
    den1, seg1 = den8[:1].contiguous(), seg8[:1].contiguous()
    fill_args = (2, 1, max(acfg.dilation_radius, acfg.distance_threshold),
                 acfg.distance_threshold ** 2, acfg.dilation_radius ** 2)
    ctx16 = torch.cat([den8 == 1, den8 == 1])
    kernels = {
        "k5_b8": lambda: region_table_cuda(seg8, den8, acfg.max_regions),
        "k5_b1": lambda: region_table_cuda(seg1, den1, acfg.max_regions),
        "k8_b8": lambda: particle_fill_step_cuda(den8, *fill_args),
        "k8_b1": lambda: particle_fill_step_cuda(den1, *fill_args),
        # K8's two uniform extremes: no cell pixel (every tile skipped), and
        # dt2 past (cap + 1)² (every cell pixel fills, no distance needed)
        "k8_b8_no_cell": lambda: particle_fill_step_cuda(den8, 2, 7, *fill_args[2:]),
        "k8_b8_fill_all": lambda: particle_fill_step_cuda(
            den8, *fill_args[:3], (fill_args[2] + 1) ** 2 + 1, 0),
        "k9_b16_cap2": lambda: edt_sq_cuda(ctx16, acfg.merge_disk_radius),
    }
    kernel_ms = {"k8_live_tiles": live_fill_tiles(den8, *fill_args[:3])}
    for key, fn in kernels.items():
        kernel_ms[f"{key}_ms"] = time_ms(fn, reps=20)
        kernel_ms[f"{key}_device_ms"] = busy_us(traced(fn, 5)) / 5e3
    del den8, seg8, den1, seg1, ctx16
    relief = refine_relief()
    xr = torch.from_numpy(np.stack([np.roll(relief, 17 * b, axis=1) for b in range(8)])).to(dev)
    rcfg = RefineConfig()
    refine_ms = time_ms(lambda: refine_plane_device(xr, rcfg, 4095), reps=5)
    # each watershed phase on refine's markers, its whole pass loop inside
    # the events; a tree whose phases return a pass count reports it as is
    mask = xr < rcfg.boundary_threshold
    maxima = local_maxima_auto(edt_sq_exact_auto(~mask, rcfg.edt_probe_cap))
    mk, _ = compact_labels_cuda(ccl_cuda(maxima.to(torch.uint8), background=0), 4095)
    seeded = (mk > 0) & mask
    cost = minimax_costs_cuda(xr, mask, seeded)[0]
    labels = claim_labels_cuda(cost, xr, mk, mask, seeded)[0]
    probe = (~mask).contiguous()
    refine_kernels = {
        "k9_b8_cap32": lambda: edt_sq_cuda(probe, rcfg.edt_probe_cap),
        "k9_b8_certified": lambda: edt_sq_exact_auto(probe, rcfg.edt_probe_cap),
        "k7_b8": lambda: centroid_sums_cuda(labels, 4095),
    }
    for key, fn in refine_kernels.items():
        kernel_ms[f"{key}_ms"] = time_ms(fn, reps=20)
        kernel_ms[f"{key}_device_ms"] = busy_us(traced(fn, 5)) / 5e3
    phases = {
        "k10": (lambda: minimax_costs_cuda(xr, mask, seeded), "cost_pass"),
        "k11": (lambda: claim_labels_cuda(cost, xr, mk, mask, seeded), "label_pass"),
    }
    out = {
        "tag": args.tag, "card": card_line(), "fused_ms": fused_ms,
        "fused_peak_gib_above_held": fused_peak / 2**30, "held_gib": held / 2**30,
        "k3_ms": k3_ms, "k4_ms": k4_ms, "analyze_ms": analyze_ms,
        "analyze_device_ms": analyze_device_ms, "analyze_trace_ms": analyze_trace,
        **kernel_ms, "refine_ms": refine_ms,
    }
    for key, (fn, kernel) in phases.items():
        out[f"{key}_ms"] = time_ms(fn, reps=5)
        phase_log = fn()[2]
        out[f"{key}_loop"] = getattr(phase_log, "_asdict", lambda: phase_log)()
        passes, other = [], 0.0
        for s, e, name in traced(fn, 3):
            if kernel in name:
                passes.append((e - s) / 1e3)
            else:
                other += (e - s) / 3e3
        n = len(passes) // 3
        out[f"{key}_pass_ms"] = [sum(passes[i::n]) / 3 for i in range(n)] if n else []
        out[f"{key}_traced_pass_ms"] = sum(passes) / 3
        out[f"{key}_traced_other_ms"] = other
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
