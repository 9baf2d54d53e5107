"""particle_col_image_segmentation_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``particle_col_image_segmentation_tpu``,
which stays the reference).  It ports the fused segmentation pass — 5×5
label median, 8-connected CCL, raster-rank compaction, per-region tables,
per-plane pixel stats — with the ``batch`` pipeline and CLI verb around it;
the analysis plane of ``analyze`` — full region table, particle fill,
proximity-merge grouping, DAPI dedup, channel fusion and the folder flows
that write the reference's CSVs; and watershed refinement, ``refine`` —
exact EDT, plateau-aware local maxima, marker CCL, two-phase watershed,
centroid table, nearest-neighbour distances; and NanoSIMS ROI analysis,
``nanosims`` (config #4); and the multi-device path (``parallel``: ``batch``
and ``refine`` over a mesh's data axis, each device running the
single-device pipeline on its chunk of planes; ``batch``, ``analyze``
and ``refine`` over its space axis, each plane's rows in bands over the
devices; multi-host, ``initialize_multihost`` joining processes over
``torch.distributed`` into one mesh whose band-sharded functions each
process runs on its own rows, ``process_allgather`` gathering their
outputs); and the whole reference-semantics oracle
(``oracle.reference_pipeline``, NumPy/SciPy) that the analysis plane is
held against (``oracle.parity``).  Each TPU kernel on those paths
has a hand-written CUDA kernel for Hopper (``csrc/``, built with nvcc on
first use, see ``_kernels``) beside a plain PyTorch version; CUDA tensors
take the kernels, CPU tensors the plain versions (``_dispatch``).

The package imports torch and never jax, and nothing of the JAX package: it
keeps its own copy of the host code it needs (config, HDF5/discovery, class
maps, manifest, logging, the prefetching decode, the CSV writers, figures).
There are no learned weights: the state that crosses between the two
packages is configuration — the port's own ``AnalysisConfig`` and
``RefineConfig``, built from any object with the same fields by
``config.config_from_fields`` — and the planes, handed to both as numpy
arrays (``torch.from_numpy`` is the only conversion).

Layout mirrors the JAX package:
  ops/       plain ops, kernel wrappers (``*_cuda``), dispatch (``*_auto``)
  io/        HDF5, discovery, the pinned-memory batch loader
  labels/    the per-plane analysis graph (analyze_plane{s}_device, dedup),
             class maps
  models/    fused_segment_batch and run_batch; analyze_plane, channel
             fusion and run_analysis; refine_plane_device and refine_boundaries
  oracle/    the reference pipeline and skimage primitives in NumPy/SciPy,
             the plane-parity check
  report/, viz/   CSV writers, figures
  parallel/  the device mesh, its data axis's worker threads, its space
             axis's bands and seam joins, multi-host
  utils/     stage tracing, logging, the run manifest
  cli.py     the ``analyze``, ``batch``, ``refine``, ``split``, ``normalize``
             and ``nanosims`` verbs
"""

__version__ = "0.1.0"

from particle_col_image_segmentation_tpu_torch.config import (  # noqa: E402,F401
    AnalysisConfig,
    NanoSIMSConfig,
    RefineConfig,
)
