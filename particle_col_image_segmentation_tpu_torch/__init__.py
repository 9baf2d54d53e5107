"""particle_col_image_segmentation_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``particle_col_image_segmentation_tpu``,
which stays the reference).  It ports the fused segmentation pass — 5×5
label median, 8-connected CCL, raster-rank compaction, per-region tables,
per-plane pixel stats — with the ``batch`` pipeline and CLI verb around it,
and the analysis plane of ``analyze`` — full region table, particle fill,
proximity-merge grouping, DAPI dedup, channel fusion and the folder flows
that write the reference's CSVs.  Each TPU kernel on those paths has a
hand-written CUDA kernel for Hopper (``csrc/``, built with nvcc on first
use, see ``_kernels``) beside a plain PyTorch version; CUDA tensors take the
kernels, CPU tensors the plain versions (``_dispatch``).

The package imports torch and never jax.  It reuses the JAX package's
JAX-free host code (config, HDF5/discovery, class maps, manifest, logging,
the prefetching decode) by import.  There are no learned weights: the state
that crosses between the two packages is the frozen ``AnalysisConfig``,
imported as is, and the label planes, handed to both as numpy arrays
(``torch.from_numpy`` is the only conversion).

Layout mirrors the JAX package:
  ops/       plain ops, kernel wrappers (``*_cuda``), dispatch (``*_auto``)
  io/        pinned-memory batch loader
  labels/    the per-plane analysis graph (analyze_plane{s}_device, dedup)
  models/    fused_segment_batch and run_batch; analyze_plane, channel
             fusion and run_analysis
  utils/     stage tracing
  cli.py     the ``analyze`` and ``batch`` verbs
"""

__version__ = "0.1.0"

from particle_col_image_segmentation_tpu.config import AnalysisConfig  # noqa: E402,F401
