#!/usr/bin/env python3
"""The space axis of the PyTorch/CUDA port on every card of the machine:
``chip_smoke.py``'s phase 14 alone, then the same paths over the cards
themselves.

Run from the root of a checkout (the script imports the port, ``bench.py``
and ``chip_smoke.py`` from the working directory):

    python3 scripts/torch_space_axis.py

It builds the kernels, runs ``run_batch`` over the smoke's 40 bench planes
of 2048² (batches of 32, ``max_regions=16383``) and ``run_analysis`` over
the smoke's folder 0 and RFP+DAPI folder on ``cuda:0`` (the references),
then ``chip_smoke.space_axis_phase`` (meshes that name ``cuda:0`` 2 and 4
times).  Where the machine has more than one card it runs, over the cards
themselves: ``run_batch`` on 1×n, on 1×2 and, with four cards, on 2×2
(rows split over n cards; stats equal to the one-card run at tolerance 0),
the 1×n run once more with the positions one after another in the main
thread (``chip_smoke.stage_workers``; a mesh over several cards takes a
worker thread a position by itself), and ``analyze_plane_device_sharded``
of one [8192,2048] plane (four bench planes stacked) at n_space = n, equal
to ``analyze_plane_device`` on one card field for field.  For each: the wall (median of 3), the seam
joins' host time, and each card's peak device memory above what it held
before.  Prints the card's name and power limit, then one JSON line.  Exits
nonzero without CUDA.
"""

import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())


def on_cards(card, planes, stats, cfg, acfg) -> dict:
    """The space axis over the machine's cards (module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from particle_col_image_segmentation_tpu_torch.labels.analysis import (
        analyze_plane_device,
        analyze_plane_device_sharded,
    )
    from particle_col_image_segmentation_tpu_torch.models.batch import run_batch
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh, sharded

    cards = torch.cuda.device_count()
    paths = [str(i) for i in range(len(planes))]
    H, W = planes[0].shape
    out = {"cards": cards}
    join_s = [0.0]
    real_join = sharded._join_seams

    def timed_join(*a, **kw):
        t0 = time.perf_counter()
        res = real_join(*a, **kw)
        join_s[0] += time.perf_counter() - t0
        return res

    def measured(fn):
        """(last result, median wall s of 3, seam join s of the last run,
        each card's peak GiB above what it held before)"""
        base = []
        for c in range(cards):
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
            base.append(torch.cuda.memory_allocated(c))
        walls = []
        for _ in range(3):
            join_s[0] = 0.0
            t0 = time.perf_counter()
            res = fn()
            for c in range(cards):
                torch.cuda.synchronize(c)
            walls.append(time.perf_counter() - t0)
        peaks = [(torch.cuda.max_memory_allocated(c) - base[c]) / 2**30 for c in range(cards)]
        return res, statistics.median(walls), join_s[0], peaks

    sharded._join_seams = timed_join
    try:
        kw = dict(batch_size=cs.BATCH, particle_val=2, cell_vals=(1,))
        _, wall1, _, peak1 = measured(lambda: list(run_batch(
            paths, lambda p: planes[int(p)], cfg, device="cuda:0", **kw)))
        out["batch one card"] = {"wall_s": wall1, "peaks_gib": peak1}
        shapes = [(1, cards, True), (1, 2, True), (1, cards, False)]
        if cards >= 4:
            shapes.insert(2, (2, 2, True))
        for nd, ns, workers in shapes:
            name = f"{nd}x{ns} cards" + ("" if workers else " main thread")
            with cs.stage_workers(workers):
                got, wall, seam, peaks = measured(lambda: dict(run_batch(
                    paths, lambda p: planes[int(p)], cfg, mesh=make_mesh(nd, ns), **kw)))
            for p in paths:
                g, w = got[p], stats[p]
                if ((g.num_regions, g.particle_px, g.cell_px, g.overflow, g.converged)
                        != (w.num_regions, w.particle_px, w.cell_px, w.overflow, w.converged)
                        or not np.array_equal(g.class_px, w.class_px)):
                    raise AssertionError(f"batch {name} plane {p}: {g} != one card's {w}")
            out[f"batch {name}"] = {"wall_s": wall, "mps": len(planes) * H * W / 1e6 / wall,
                                    "seam_join_s": seam, "peaks_gib": peaks}
            cs.log(f"space axis batch {name} [{card}]: run_batch == one card's stats (tolerance "
                   f"0); {wall:.3f} s wall, median of 3 (one card {wall1:.3f}); seam joins "
                   f"{seam * 1e3:.1f} ms; peaks {[round(p, 3) for p in peaks]} GiB a card "
                   f"(one card {peak1[0]:.3f})")

        tall_cfg = dataclasses.replace(acfg, max_regions=65535)
        tall = np.ascontiguousarray(np.concatenate(planes[:4], axis=0))
        x = torch.from_numpy(tall).to("cuda:0")
        want, wall1, _, peak1 = measured(lambda: analyze_plane_device(x, cs.SINGLE, tall_cfg))
        got, wall, seam, peaks = measured(lambda: analyze_plane_device_sharded(
            tall, cs.SINGLE, tall_cfg, make_mesh(1, cards)))
        for name, g, w in zip(want._fields, got, want):
            for gg, ww in zip(*((list(g), list(w)) if name == "table" else ([g], [w]))):
                if gg.shape != ww.shape or gg.dtype != ww.dtype or not torch.equal(gg, ww):
                    raise AssertionError(f"tall plane on {cards} cards: field {name} differs")
        out["tall plane"] = {"wall_ms": wall * 1e3, "one_card_wall_ms": wall1 * 1e3,
                             "seam_join_ms": seam * 1e3, "peaks_gib": peaks,
                             "one_card_peak_gib": peak1[0]}
        cs.log(f"space axis analyze_plane_device_sharded [{4 * H},{W}] on 1x{cards} cards "
               f"[{card}]: every field == analyze_plane_device on one card; {wall * 1e3:.1f} ms "
               f"wall (one card {wall1 * 1e3:.1f}); seam joins {seam * 1e3:.1f} ms; peaks "
               f"{[round(p, 3) for p in peaks]} GiB a card (one card {peak1[0]:.3f})")
    finally:
        sharded._join_seams = real_join
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_space_axis: CUDA is not available; nothing was run", file=sys.stderr)
        return 1

    import bench
    import chip_smoke as cs
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, _kernels
    from particle_col_image_segmentation_tpu_torch.models.batch import run_batch
    from particle_col_image_segmentation_tpu_torch.models.experiment import run_analysis

    card = cs.card_line()
    dev = torch.device("cuda:0")
    cs.log(f"torch_space_axis: [{card}], {torch.cuda.device_count()} card(s)")
    _kernels.library()
    cfg = AnalysisConfig(max_regions=cs.MAX_REGIONS)
    acfg = AnalysisConfig()
    planes = [bench.make_plane(s) for s in range(cs.N_MAIN)]
    stats = dict(run_batch([str(i) for i in range(cs.N_MAIN)], lambda p: planes[int(p)], cfg,
                           device=dev, batch_size=cs.BATCH, particle_val=2, cell_vals=(1,)))
    with tempfile.TemporaryDirectory(prefix="pcis_space_ref_") as tmp:
        root = os.path.join(tmp, "tree")
        seed_of = cs.make_tree(root, [0])
        run_analysis(root, acfg, make_figures=False, device=dev,
                     load_fn=lambda p: planes[seed_of[p]])
        analyze_csv = cs.csv_lines(root)
    reset_counts, read_counts = _kernels.launch_counters()
    _, record = cs.space_axis_phase(card, dev, planes, stats, cfg, acfg, analyze_csv,
                                    reset_counts, read_counts)
    if torch.cuda.device_count() > 1:
        record["cards"] = on_cards(card, planes, stats, cfg, acfg)
    cs.log(card)
    cs.log(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
