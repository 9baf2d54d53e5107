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
that shape; ``analyze_planes_device`` on [8,2048,2048]; and
``refine_plane_device`` on the [8,2048,2048] touching-cell relief.
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

    if not torch.cuda.is_available():
        print("torch_device_graphs: CUDA is not available", file=sys.stderr)
        return 1

    import bench
    from chip_smoke import SINGLE, card_line, refine_relief, time_ms
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, RefineConfig
    from particle_col_image_segmentation_tpu_torch.labels.analysis import analyze_planes_device
    from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch
    from particle_col_image_segmentation_tpu_torch.models.refine import refine_plane_device
    from particle_col_image_segmentation_tpu_torch.ops import (
        ccl_cuda,
        compact_labels_cuda,
        median_label_filter_cuda,
        region_counts_cuda,
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
    print(json.dumps({
        "tag": args.tag, "card": card_line(), "fused_ms": fused_ms,
        "fused_peak_gib_above_held": fused_peak / 2**30, "held_gib": held / 2**30,
        "k3_ms": k3_ms, "k4_ms": k4_ms, "analyze_ms": analyze_ms, "refine_ms": refine_ms,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
