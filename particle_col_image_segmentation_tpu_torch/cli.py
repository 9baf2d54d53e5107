"""Command-line interface of the PyTorch port.

  analyze — recursive .h5 analysis: position, merged-position and density
            CSVs (tiff_analysis.main parity)
  batch   — streaming fused segmentation stats over every .h5 plane of a tree
  refine  — watershed boundary refinement of an Ilastik probability export
            (refine_boundaries parity): refined labels and per-cell CSV
  split   — split z-stack TIFFs into per-plane, per-channel TIFFs
            (split_zstack.py parity)
  normalize — move raw captures into one clean folder an acquisition
            (create_file_structure.py parity)
  nanosims — NanoSIMS 5-isotope ROI activity/distance analysis (.m parity)
  bench   — the throughput benchmark: bench.py's one-line JSON record of
            configs #1-#5, measured on the card (this package's ``bench.py``)

Files and output lines match the JAX package's verbs byte for byte.
``--device`` defaults to ``cuda`` (the hand-written kernels; Hopper cards
only); ``--device cpu`` runs the plain PyTorch versions (``bench`` then
runs bench.py's smaller CPU-fallback sizes).  ``split`` and ``normalize``
run on the host only and take no ``--device``.

``batch`` and ``refine`` take ``--data-parallel N`` and ``--space-parallel
M``, and ``analyze`` ``--space-parallel M``: a mesh of N×M devices that
follows ``--device`` — the first N×M cards from ``cuda`` (or from
``cuda:K``), or the CPU named N×M times from ``cpu``.  The space axis splits
each plane's rows into M bands, one a device (``refine --tunnel-basins``
runs its planes data-parallel over all N×M devices, as the JAX package
does).  ``batch --pack-transfer``, a relay workaround of the JAX package,
is refused.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig, RefineConfig


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on: cuda (the default), cuda:N (the "
        "kernels; Hopper cards only) or cpu (the plain PyTorch versions)",
    )


def _add_profile_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--profile", action="store_true",
        help="print each span's host time (ms in all, spans, self ms) and the "
        "host syncs' waits at exit; host time, not device time",
    )


def _profiled(run, profile: bool) -> int:
    """``run()``; with ``profile``, the tracer keeps its spans while it runs
    and prints its report after it."""
    if not profile:
        return run()
    from particle_col_image_segmentation_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    try:
        rc = run()
    finally:
        profiling.disable()
    print("\n".join(profiling.report()))
    profiling.reset()
    return rc


def _add_analysis_flags(p: argparse.ArgumentParser) -> None:
    d = AnalysisConfig()
    p.add_argument("--denoise-size", type=int, default=d.denoise_size)
    p.add_argument("--dilation-radius", type=int, default=d.dilation_radius)
    p.add_argument("--distance-threshold", type=int, default=d.distance_threshold)
    p.add_argument(
        "--cell-cluster-distance-threshold", type=int,
        default=d.cell_cluster_distance_threshold,
    )
    p.add_argument("--dapi-overlap-threshold", type=float, default=d.dapi_overlap_threshold)
    p.add_argument("--px-to-um", type=float, default=d.px_to_um)
    p.add_argument("--max-regions", type=int, default=d.max_regions)
    p.add_argument("--no-figures", action="store_true")
    _add_profile_flag(p)
    p.add_argument("--strict-reference-errors", action="store_true")


def _cfg_from_args(args) -> AnalysisConfig:
    return AnalysisConfig(
        denoise_size=args.denoise_size,
        dilation_radius=args.dilation_radius,
        distance_threshold=args.distance_threshold,
        cell_cluster_distance_threshold=args.cell_cluster_distance_threshold,
        dapi_overlap_threshold=args.dapi_overlap_threshold,
        px_to_um=args.px_to_um,
        max_regions=args.max_regions,
        strict_reference_errors=args.strict_reference_errors,
    )


def _add_mesh_flags(p: argparse.ArgumentParser, data_help: str, space_help: str) -> None:
    p.add_argument("--data-parallel", type=int, default=0, help=data_help)
    p.add_argument("--space-parallel", type=int, default=0, help=space_help)


def _mesh(device, n_data: int, n_space: int):
    """The mesh of ``n_data × n_space`` devices that ``--device`` names: the
    cards from its index on (``make_mesh`` raises when there are too few),
    or the CPU named ``n_data × n_space`` times."""
    import torch

    from particle_col_image_segmentation_tpu_torch.parallel.mesh import make_mesh

    if device.type == "cuda":
        first = device.index or 0
        devices = [torch.device("cuda", i) for i in range(first, torch.cuda.device_count())]
    else:
        devices = [device] * (n_data * n_space)
    return make_mesh(n_data=n_data, n_space=n_space, devices=devices)


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available here")
    return device


def main(argv=None) -> int:
    prog = os.path.basename(sys.argv[0] or "")
    if prog in ("", "cli.py", "__main__.py"):
        prog = "python -m particle_col_image_segmentation_tpu_torch"
    parser = argparse.ArgumentParser(
        prog=prog,
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("analyze", help="recursive .h5 label-map analysis")
    p.add_argument("folder", help="top-level folder (strain tokens in path)")
    _add_device_flag(p)
    _add_analysis_flags(p)
    p.add_argument(
        "--space-parallel", type=int, default=0,
        help="devices on the space mesh axis: every plane's ROWS split into "
        "bands across devices (halo rows and a host seam join; the same "
        "CSVs) — plane height must be a multiple of this",
    )
    p.add_argument(
        "--batch-planes", type=int, default=1,
        help="batch same-shape planes from the whole tree into single "
        "device launches of up to this many planes (byte-identical CSVs; "
        "mutually exclusive with --space-parallel)",
    )

    p = sub.add_parser(
        "batch",
        help="stream fused segmentation stats over every .h5 plane "
        "(the scale-out replacement for the reference's folder loop)",
    )
    p.add_argument("folder")
    _add_device_flag(p)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-regions", type=int, default=AnalysisConfig().max_regions)
    _add_mesh_flags(
        p, "devices on the data mesh axis (0 = single device)",
        "devices on the space mesh axis: plane ROWS split into bands across "
        "devices (halo rows and a host seam join) — plane height must be a "
        "multiple of this (0/1 = planes stay whole per device)",
    )
    p.add_argument(
        "--particle-val", type=int, default=None,
        help="particle class value (default: derive per file from its "
        "strain/channel tokens, like analyze)",
    )
    p.add_argument(
        "--cell-vals", type=int, nargs="+", default=None,
        help="cell class values (default: derive per file)",
    )
    p.add_argument(
        "--manifest", default=None,
        help="restartable-progress manifest path (skips completed planes)",
    )
    p.add_argument(
        "--pack-transfer", action="store_true",
        help="refused: the JAX package's 4-bit packed transfer is a relay "
        "workaround that the port drops",
    )
    p.add_argument("--csv", default=None, help="write per-plane stats CSV here")
    _add_profile_flag(p)
    p.add_argument(
        "--fail-fast", action="store_true",
        help="abort on the first decode failure instead of logging and "
        "skipping the plane (skipped planes are never marked done, so a "
        "manifest resume retries them)",
    )

    p = sub.add_parser("split", help="split z-stack TIFFs per plane/channel")
    p.add_argument("folder")
    p.add_argument(
        "--channels", type=int, nargs="+", default=[1, 2],
        help="channel indices (default 1 2 = RFP GFP, reference :93)",
    )

    p = sub.add_parser("normalize", help="normalize raw-capture folder tree")
    p.add_argument("folder")

    p = sub.add_parser("nanosims", help="NanoSIMS 5-isotope ROI analysis")
    p.add_argument("mat_folder")
    p.add_argument("rois_png")
    _add_device_flag(p)
    p.add_argument("--bound-png", default=None)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--compat-green-o-bug", action="store_true")
    p.add_argument("--no-figures", action="store_true", dest="ns_no_figures")

    p = sub.add_parser("refine", help="watershed boundary refinement of a probability .h5")
    p.add_argument("h5_file")
    _add_device_flag(p)
    p.add_argument("--channel", type=int, default=RefineConfig().boundary_channel)
    p.add_argument("--threshold", type=float, default=RefineConfig().boundary_threshold)
    p.add_argument("--out", default=None, help="write refined labels to this .h5")
    p.add_argument("--csv", default=None, help="write per-cell stats to this CSV")
    p.add_argument(
        "--stack", action="store_true",
        help="treat the export as a z-stack ([Z,H,W] / [Z,C,H,W] / "
        "[Z,H,W,C]) and refine all planes in one batched pass "
        "(4-D inputs take this path automatically)",
    )
    _add_mesh_flags(
        p, "devices on the data mesh axis when refining a stack (planes split "
        "across this many devices; combines with --space-parallel)",
        "devices on the space mesh axis: plane ROWS split into bands across "
        "this many devices (with --tunnel-basins, planes distribute "
        "data-parallel over every device of the mesh instead)",
    )
    p.add_argument(
        "--tunnel-basins", action="store_true",
        help="model priority-flood basin tunneling (basin-component "
        "contraction) in the watershed — for plateaued/quantized "
        "probability maps with sparse markers; with --space-parallel "
        "planes distribute data-parallel (each plane floods on one chip)",
    )

    p = sub.add_parser(
        "bench", help="run the throughput benchmark (one JSON line, configs #1-#5)"
    )
    _add_device_flag(p)

    args = parser.parse_args(argv)
    if args.command == "batch":
        if args.pack_transfer:
            parser.error("--pack-transfer is not supported: the PyTorch port drops the JAX "
                         "package's relay workarounds (packed transfers) by its north-star "
                         "rule; leave the flag out")
        if args.data_parallel and args.batch_size % args.data_parallel != 0:
            parser.error(
                "--batch-size must be a multiple of --data-parallel "
                f"(got {args.batch_size} and {args.data_parallel})"
            )
    if (args.command == "analyze" and args.space_parallel > 1
            and args.batch_planes > 1):
        parser.error("--batch-planes batches whole planes per device and cannot "
                     "combine with --space-parallel — pass one or the other")
    if args.command == "analyze":
        return _profiled(lambda: _analyze(args), args.profile)
    if args.command == "refine":
        return _refine(args)
    if args.command == "nanosims":
        return _nanosims(args)
    if args.command == "bench":
        from particle_col_image_segmentation_tpu_torch.bench import main as bench_main

        return bench_main(["--device", args.device])
    if args.command == "split":
        from particle_col_image_segmentation_tpu_torch.models.zsplit import process_folder

        process_folder(args.folder, args.channels)
        return 0
    if args.command == "normalize":
        from particle_col_image_segmentation_tpu_torch.io.discovery import normalize_capture_tree

        for folder in normalize_capture_tree(args.folder):
            print("normalized:", folder)
        return 0
    return _profiled(lambda: _batch(args), args.profile)


def _analyze(args) -> int:
    from particle_col_image_segmentation_tpu_torch.models.experiment import run_analysis

    device = _device(args.device)
    mesh = _mesh(device, 1, args.space_parallel) if args.space_parallel > 1 else None
    run_analysis(args.folder, _cfg_from_args(args),
                 make_figures=not args.no_figures, device=device,
                 batch_planes=args.batch_planes, mesh=mesh)
    return 0


def _nanosims(args) -> int:
    from particle_col_image_segmentation_tpu_torch.config import NanoSIMSConfig
    from particle_col_image_segmentation_tpu_torch.models.nanosims import run_nanosims

    device = _device(args.device)
    cfg = NanoSIMSConfig(compat_green_o_bug=args.compat_green_o_bug)
    result = run_nanosims(args.mat_folder, args.rois_png, args.bound_png, args.out_dir, cfg,
                          make_figures=not args.ns_no_figures, device=device)
    print(
        f"red ROIs: {result.red.num_rois}, green ROIs: {result.green.num_rois}; "
        f"CSVs written to {args.out_dir}"
    )
    return 0


def _refine(args) -> int:
    import numpy as np

    from particle_col_image_segmentation_tpu_torch.io.hdf5 import load_h5_plane, save_h5_plane
    from particle_col_image_segmentation_tpu_torch.models.refine import (
        refine_boundaries,
        refine_boundaries_sharded,
        refine_boundaries_stack,
        write_refine_csv,
        write_refine_stack_csv,
    )

    device = _device(args.device)
    cfg = RefineConfig(boundary_threshold=args.threshold, boundary_channel=args.channel,
                       tunnel_basins=args.tunnel_basins)
    probs = load_h5_plane(args.h5_file, key="exported_data")
    as_stack = args.stack or probs.ndim == 4
    if args.space_parallel > 1 or args.data_parallel > 1:
        mesh = _mesh(device, args.data_parallel or 1, max(args.space_parallel, 1))
        results = refine_boundaries_sharded(probs, cfg, mesh=mesh, stack=as_stack)
    elif as_stack:
        results = refine_boundaries_stack(probs, cfg, device=device)
    else:
        results = [refine_boundaries(probs, cfg, device=device)]
    if as_stack:
        print(f"planes: {len(results)}, cells: {sum(r.num_cells for r in results)}")
        if args.out:
            save_h5_plane(args.out, np.stack([r.labels for r in results]))
            print("labels written to", args.out)
        if args.csv:
            write_refine_stack_csv(results, args.csv)
            print("cell stats written to", args.csv)
    else:
        result = results[0]
        print(f"cells: {result.num_cells}")
        if args.out:
            save_h5_plane(args.out, result.labels)
            print("labels written to", args.out)
        if args.csv:
            write_refine_csv(result, args.csv)
            print("cell stats written to", args.csv)
    return 0


def _batch(args) -> int:
    from particle_col_image_segmentation_tpu_torch.io.discovery import get_h5_files_recursively
    from particle_col_image_segmentation_tpu_torch.io.hdf5 import load_h5_plane
    from particle_col_image_segmentation_tpu_torch.oracle.reference_pipeline import (
        normalize_ds_arr,
    )
    from particle_col_image_segmentation_tpu_torch.models.batch import (
        derive_class_values,
        run_batch,
    )

    device = _device(args.device)
    mesh = None
    if args.data_parallel or args.space_parallel > 1:
        mesh = _mesh(device, args.data_parallel or 1, max(args.space_parallel, 1))
    cfg = AnalysisConfig(max_regions=args.max_regions)
    folder_to_files = get_h5_files_recursively(args.folder)
    paths = [
        os.path.join(folder, f)
        for folder, files in folder_to_files.items()
        for f in files
    ]
    if not paths:
        print("no .h5 planes found under", args.folder)
        return 1
    # class values per file: explicit flags win (either flag alone overrides
    # its half); otherwise derive from the path tokens (analyze's rules)
    if args.particle_val is not None and args.cell_vals is not None:
        groups = {(args.particle_val, tuple(args.cell_vals)): paths}
    else:
        sig_of = derive_class_values(folder_to_files)
        groups = {}
        for path in paths:
            pv, cv = sig_of[path]
            if args.particle_val is not None:
                pv = args.particle_val
            if args.cell_vals is not None:
                cv = tuple(args.cell_vals)
            groups.setdefault((pv, cv), []).append(path)
    manifest = None
    if args.manifest:
        from particle_col_image_segmentation_tpu_torch.utils.manifest import RunManifest

        manifest = RunManifest(args.manifest)

    def load_fn(path: str):
        return normalize_ds_arr(load_h5_plane(path), cfg)

    sink = None
    writer = None
    if args.csv:
        # append on an ACTUAL manifest resume (completed planes whose rows
        # live only in the old CSV); a fresh manifest + leftover CSV truncates
        resume = (
            manifest is not None and manifest.done_count > 0
            and os.path.exists(args.csv)
        )
        sink = open(args.csv, "a" if resume else "w", newline="")
        writer = csv.writer(sink)
        if not resume:
            writer.writerow(["plane", "regions", "particle_px", "cell_px", "status"])
    try:
        for (particle_val, cell_vals), group_paths in groups.items():
            for path, stats in run_batch(
                group_paths, load_fn, cfg, device=device,
                batch_size=args.batch_size, particle_val=particle_val,
                cell_vals=cell_vals, manifest=manifest, mesh=mesh,
                on_error="raise" if args.fail_fast else "skip",
            ):
                flag = " OVERFLOW(raise --max-regions)" if stats.overflow else ""
                if not stats.converged:
                    flag += " UNCONVERGED(stats invalid)"
                print(
                    f"{path}: regions={stats.num_regions} "
                    f"particle_px={stats.particle_px} cell_px={stats.cell_px}"
                    f"{flag}"
                )
                if writer is not None:
                    # unconverged wins over overflow: unconverged stats are
                    # invalid wholesale, overflow rows are valid undercounts;
                    # consumers keep rows with status == "ok"
                    status = (
                        "unconverged" if not stats.converged
                        else ("overflow" if stats.overflow else "ok")
                    )
                    writer.writerow(
                        [path, stats.num_regions, stats.particle_px,
                         stats.cell_px, status]
                    )
                    # flush BEFORE run_batch marks the plane done in the
                    # manifest, or a crash could lose a row for good
                    sink.flush()
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
