#!/usr/bin/env python3
"""The data axis of the PyTorch/CUDA port on every card of the machine:
``chip_smoke.py``'s phase 13 alone, with the one-device runs it is held to.

Run from the root of a checkout (the script imports the port, ``bench.py``
and ``chip_smoke.py`` from the working directory):

    python3 scripts/torch_data_axis.py

It builds the kernels, runs ``run_batch`` over the smoke's 40 bench planes
of 2048² (batches of 32, ``max_regions=16383``) and
``refine_boundaries_stack`` over its [8,2048,2048] relief on ``cuda:0``,
then ``chip_smoke.data_axis_phase``: meshes that name ``cuda:0`` 2 and 4
times and, where the machine has more than one card, meshes over the
cards themselves, each equal to the one-device runs at tolerance 0, with
run_batch MP/s, refine walls and each card's peak device memory.  Prints
the card's name and power limit, then one JSON line (the phase's record).
Exits nonzero without CUDA.

    python3 scripts/torch_data_axis.py --steady-planes 320

adds a steady-state window: ``run_batch`` over that many planes (the 40
bench planes repeated; batches of 32) on one card, on ``cuda:0`` named 4
times and on 2 and on all cards where the machine has them, each run's
stats equal to the one-card run's at tolerance 0.  For each it reports the
wall (median of 3), the median interval between batches past the first
(the pipeline's fill left out), the ``pcis.batch`` span a batch (host
time from the batch's dispatch to its readback, ``utils.profiling.stage``),
and the loader alone
(``batched_device_iterator`` to the same devices, each chunk synchronised
as it is handed over); for each mesh, one batch's fused pass called
chunk after chunk in the main thread, through the mesh's workers, and
workers that run nothing or one tiny op (where the span goes); and, once,
the host steps of one batch on their own: stacking 32 planes, pinning the
stack, and its copy to one card.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())


def steady_state(card, planes, stats, cfg, n_planes: int, batch: int) -> dict:
    """The steady-state window of ``--steady-planes`` (module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from particle_col_image_segmentation_tpu_torch.io.loader import batched_device_iterator
    from particle_col_image_segmentation_tpu_torch.models.batch import run_batch
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh
    from particle_col_image_segmentation_tpu_torch.utils import profiling

    paths = [str(i) for i in range(n_planes)]

    def load(p):
        return planes[int(p) % len(planes)]

    H, W = planes[0].shape
    n_batches = -(-n_planes // batch)
    mp = n_planes * H * W / 1e6
    dev = torch.device("cuda:0")
    cards = torch.cuda.device_count()
    meshes = [("one card", make_mesh(devices=[dev])),
              ("cuda:0 x4", make_mesh(n_data=4, devices=[dev] * 4))]
    for n in sorted({2, cards}):
        if 1 < n <= cards and batch % n == 0:
            meshes.append((f"{n} cards", make_mesh(n_data=n)))
    out = {"planes": n_planes, "batch": batch, "batches": n_batches}

    def batch_marks(it, per_batch):
        """Host times at the end of each batch (per_batch(item) consumes one)."""
        t0 = time.perf_counter()
        marks = []
        for item in it:
            per_batch(item)
            marks.append(time.perf_counter() - t0)
        return marks

    def steady(marks):
        gaps = np.diff(marks)
        return float(np.median(gaps)) if len(gaps) else float("nan")

    for name, mesh in meshes:
        devices = list(mesh.flat)

        def one_run():
            got, marks = {}, []
            t0 = time.perf_counter()
            for i, (p, st) in enumerate(run_batch(paths, load, cfg, mesh=mesh, batch_size=batch,
                                                  particle_val=2, cell_vals=(1,))):
                got[p] = st
                if i % batch == batch - 1 or i == n_planes - 1:
                    marks.append(time.perf_counter() - t0)
            return got, marks

        walls, gaps, spans = [], [], []
        for _ in range(3):
            profiling.enable()
            profiling.reset()
            t0 = time.perf_counter()
            got, marks = one_run()
            walls.append(time.perf_counter() - t0)
            gaps.append(steady(marks))
            spans.append(profiling.STAGE_TOTALS["pcis.batch"] / n_batches)
            for p in paths:
                g, w = got[p], stats[str(int(p) % len(planes))]
                if ((g.num_regions, g.particle_px, g.cell_px, g.overflow, g.converged)
                        != (w.num_regions, w.particle_px, w.cell_px, w.overflow, w.converged)
                        or not np.array_equal(g.class_px, w.class_px)):
                    raise AssertionError(f"steady {name} plane {p}: {g} != {w}")

        def consume(item):
            for chunk in item[0]:
                torch.cuda.current_stream(chunk.device).synchronize()

        loader_gaps, loader_walls = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            marks = batch_marks(batched_device_iterator(load, paths, batch, devices=devices,
                                                        with_paths=True), consume)
            loader_walls.append(time.perf_counter() - t0)
            loader_gaps.append(steady(marks))
        wall, gap, span = (statistics.median(x) for x in (walls, gaps, spans))
        lwall, lgap = statistics.median(loader_walls), statistics.median(loader_gaps)
        bmp = batch * H * W / 1e6
        out[name] = {"wall_s": walls, "mps": mp / wall, "batch_gap_ms": gap * 1e3,
                     "steady_mps": bmp / gap, "batch_span_ms": span * 1e3,
                     "loader_wall_s": loader_walls, "loader_gap_ms": lgap * 1e3,
                     "loader_steady_mps": bmp / lgap}
        cs.log(f"steady {name} [{card}]: run_batch over {n_planes} planes of {H}x{W} in "
               f"{n_batches} batches of {batch}, stats == one card's (tolerance 0): "
               f"{mp / wall:.1f} MP/s (median of 3 walls, {wall:.3f} s); a batch every "
               f"{gap * 1e3:.2f} ms past the first ({bmp / gap:.1f} MP/s), its pcis.batch "
               f"span {span * 1e3:.2f} ms; the loader alone {lwall:.3f} s, a batch every "
               f"{lgap * 1e3:.2f} ms ({bmp / lgap:.1f} MP/s)")

    # where a mesh's pcis.batch span goes: the same four [8,H,W] chunks
    # of one batch, (a) one call after another in the main thread, (b)
    # through the mesh's workers, (c) workers that run nothing on the card
    # and (d) workers that launch one tiny op each
    from particle_col_image_segmentation_tpu_torch.models.batch import (
        fused_segment_batch,
        make_fused_segment_fn,
    )
    from particle_col_image_segmentation_tpu_torch.parallel.mesh import run_per_device

    def sync_all(devs):
        for d in set(devs):
            torch.cuda.synchronize(d)

    def timed_on(devs, fn, reps=7):
        fn()
        sync_all(devs)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync_all(devs)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3

    host = torch.from_numpy(np.stack([load(p) for p in paths[:batch]]))
    out["worker_overhead_ms"] = {}
    for name, mesh in meshes[1:]:
        devs = list(mesh.flat)
        per = batch // len(devs)
        chunks = [host[i * per:(i + 1) * per].to(d) for i, d in enumerate(devs)]
        seg = make_fused_segment_fn(mesh, cfg, 2, (1,))
        row = {
            "sequential": timed_on(devs, lambda: [fused_segment_batch(c, cfg, 2, (1,))
                                                  for c in chunks]),
            "workers": timed_on(devs, lambda: seg(chunks)),
            "workers_no_op": timed_on(devs, lambda: run_per_device(
                lambda c: None, devs, [(c,) for c in chunks])),
            "workers_one_op": timed_on(devs, lambda: run_per_device(
                lambda c: c[0, 0, :1].sum(), devs, [(c,) for c in chunks])),
        }
        out["worker_overhead_ms"][name] = row
        cs.log(f"steady worker overhead {name} [{card}]: one batch's {len(devs)} chunks of "
               f"[{per},{H},{W}] (median of 7, host clock, synced): "
               + ", ".join(f"{k} {v:.2f} ms" for k, v in row.items()))

    # one batch's host steps on their own, median of 5
    def timed(fn, reps=5):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3, r

    stack_ms, host = timed(lambda: torch.from_numpy(np.stack([load(p) for p in paths[:batch]])))
    pin_ms, pinned = timed(lambda: host.pin_memory())
    copy_ms, _ = timed(lambda: pinned.to(dev, non_blocking=True))
    out["host_steps_ms"] = {"stack": stack_ms, "pin": pin_ms, "copy": copy_ms}
    cs.log(f"steady host steps [{card}]: one batch of {batch} planes: np.stack {stack_ms:.2f} ms, "
           f"pin_memory {pin_ms:.2f} ms, copy to cuda:0 {copy_ms:.2f} ms (median of 5)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steady-planes", type=int, default=0,
                    help="also time run_batch over this many planes (0: not)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_data_axis: CUDA is not available; nothing was run", file=sys.stderr)
        return 1

    import numpy as np

    import bench
    import chip_smoke as cs
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig, RefineConfig, _kernels
    from particle_col_image_segmentation_tpu_torch.models.batch import run_batch
    from particle_col_image_segmentation_tpu_torch.models.refine import refine_boundaries_stack

    card = cs.card_line()
    dev = torch.device("cuda:0")
    cs.log(f"torch_data_axis: [{card}], {torch.cuda.device_count()} card(s)")
    _kernels.library()
    cfg = AnalysisConfig(max_regions=cs.MAX_REGIONS)
    rcfg = RefineConfig()
    planes = [bench.make_plane(s) for s in range(cs.N_MAIN)]
    stats = dict(run_batch([str(i) for i in range(cs.N_MAIN)], lambda p: planes[int(p)], cfg,
                           device=dev, batch_size=cs.BATCH, particle_val=2, cell_vals=(1,)))
    relief = cs.refine_relief()
    stack8 = np.stack([np.roll(relief, 17 * b, axis=1) for b in range(cs.REFINE_PLANES)])
    results8 = refine_boundaries_stack(stack8, rcfg, cs.REFINE_REGIONS, device=dev)
    reset_counts, read_counts = _kernels.launch_counters()
    _, record = cs.data_axis_phase(card, dev, planes, stats, stack8, results8, cfg, rcfg,
                                   reset_counts, read_counts)
    if args.steady_planes:
        record["steady"] = steady_state(card, planes, stats, cfg, args.steady_planes, cs.BATCH)
    cs.log(card)
    cs.log(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
