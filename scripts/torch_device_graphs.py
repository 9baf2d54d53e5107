#!/usr/bin/env python3
"""Device times of the PyTorch/CUDA port's three device graphs and of its
fused-pass kernels K3 and K4, for comparing two checkouts on one card.

Run from the root of a checkout of the port; the script imports the port,
``bench.py`` and ``chip_smoke.py`` from the working directory, so the same
script times any checkout:

    cd <checkout> && python3 <path>/scripts/torch_device_graphs.py [--tag NAME]

To compare two trees, run it in turns in one call (parent, change, change,
parent).  Prints one JSON line: the card's name and power limit;
``fused_segment_batch`` on a device-resident [32,2048,2048] batch of bench
planes (ms by CUDA events, and its peak device memory above what was held
before it); ``compact_labels_cuda`` (K3) and ``region_counts_cuda`` (K4) at
that shape; ``analyze_planes_device`` on [8,2048,2048];
``refine_plane_device`` on the [8,2048,2048] touching-cell relief; and each
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
    from chip_smoke import SINGLE, card_line, device_intervals, refine_relief, time_ms
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, RefineConfig
    from particle_col_image_segmentation_tpu_torch.labels.analysis import analyze_planes_device
    from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch
    from particle_col_image_segmentation_tpu_torch.models.refine import refine_plane_device
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        compact_labels_cuda,
        edt_sq_exact_auto,
        local_maxima_auto,
        median_label_filter_cuda,
        region_counts_cuda,
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
    phases = {
        "k10": (lambda: minimax_costs_cuda(xr, mask, seeded), "cost_pass"),
        "k11": (lambda: claim_labels_cuda(cost, xr, mk, mask, seeded), "label_pass"),
    }
    out = {
        "tag": args.tag, "card": card_line(), "fused_ms": fused_ms,
        "fused_peak_gib_above_held": fused_peak / 2**30, "held_gib": held / 2**30,
        "k3_ms": k3_ms, "k4_ms": k4_ms, "analyze_ms": analyze_ms, "refine_ms": refine_ms,
    }
    for key, (fn, kernel) in phases.items():
        out[f"{key}_ms"] = time_ms(fn, reps=5)
        phase_log = fn()[2]
        out[f"{key}_loop"] = getattr(phase_log, "_asdict", lambda: phase_log)()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        passes, other = [], 0.0
        for s, e, name in sorted(device_intervals(prof)):
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
