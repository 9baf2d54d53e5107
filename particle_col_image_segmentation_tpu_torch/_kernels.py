"""Build and load the hand-written CUDA kernels in ``csrc/``.

The sources have a plain C interface, so they compile with ``nvcc`` alone
(seconds, no PyTorch headers; one ``nvcc`` per ``.cu``, all started
together, then one link) into one shared library, loaded with ``ctypes``.
The library is built on first use under ``build/`` at the checkout root
and named by a hash of the sources and flags, so an edited ``.cu`` (or
``.cuh``) rebuilds and an unchanged one loads at once.  A missing ``nvcc`` or a
failed build raises: there is no other path for CUDA tensors.

The data axis (``parallel``) calls the wrappers from one thread per device,
so the first build and load run under a lock, and each wrapper counts its
launches through ``count_launch``; ``launch_counters`` resets and reads
every wrapper's count, K1-K12, the blur and the plateau maxima pair.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pcis_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "pcis_median_u8": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "pcis_ccl_scratch_len": (_L, [_I, _I, _I]),
    "pcis_ccl_u8": (_I, [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P]),
    "pcis_ccl_i32": (_I, [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P]),
    "pcis_compact_scratch_len": (_L, [_I, _I, _I]),
    "pcis_compact": (_I, [_P, _P, _P, _P, _L, _I, _I, _I, _P]),
    "pcis_region_counts": (_I, [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]),
    "pcis_region_table": (_I, [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P]),
    "pcis_bin_histogram": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "pcis_table_lookup": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "pcis_edt_sq": (_I, [_P, _P, _P, _P] + [_I] * 6 + [_P]),
    "pcis_edt_max_tile_cap": (_I, []),
    "pcis_particle_fill": (_I, [_P, _P, _P, _P] + [_I] * 10 + [_P]),
    "pcis_particle_fill_fused": (_I, [_P, _P, _P] + [_I] * 10 + [_P]),
    "pcis_fill_max_fused_cap": (_I, []),
    "pcis_centroid_sums": (_I, [_P, _P] + [_I] * 5 + [_P]),
    "pcis_watershed_cost": (_I, [_P] * 6 + [_I] * 6 + [_P]),
    "pcis_watershed_label": (_I, [_P] * 10 + [_I] * 6 + [_P]),
    "pcis_tunnel_init": (_I, [_P] * 11 + [_I] * 4 + [_P]),
    "pcis_tunnel_step": (_I, [_P] * 13 + [_I] * 5 + [_P, _P]),
    "pcis_gaussian_blur": (_I, [_P, _I, _P, _I, _I, _I, _P, _I, _I, _P]),
    "pcis_maxima_scratch_len": (_L, [_I, _I, _I]),
    "pcis_plateau_maxima_u8": (_I, [_P, _P, _P, _L, _P, _I, _I, _I, _I, _P]),
    "pcis_plateau_maxima_i32": (_I, [_P, _P, _P, _L, _P, _I, _I, _I, _I, _P]),
    "pcis_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    for home in (cuda_home, "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of particle_col_image_segmentation_tpu_torch cannot "
        "be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


_lock = threading.Lock()
_lib = None
_count_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The kernel library, built first if this source tree has none yet.

    ``library().build_log`` holds what nvcc printed (the ptxas register and
    shared-memory report), empty when an earlier build was loaded.  Threads
    share one build: the first caller builds and loads under a lock, the
    others wait for it."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _build_and_load()
    return _lib


def _build_and_load() -> ctypes.CDLL:
    build_log = ""
    digest = _digest()
    lib_path = BUILD_DIR / f"libpcis_kernels_{digest}.so"
    if not lib_path.exists():
        nvcc = _nvcc()
        obj_dir = BUILD_DIR / f"obj_{digest}.{os.getpid()}"
        obj_dir.mkdir(parents=True, exist_ok=True)
        try:
            # one nvcc per source, all started together, then one link
            jobs = []
            for src in _sources():
                obj = obj_dir / f"{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )
                jobs.append((cmd, obj, proc))
            outs = [proc.communicate()[0] for _, _, proc in jobs]  # wait for all
            build_log = "".join(outs)
            for (cmd, _, proc), out in zip(jobs, outs):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
                    )
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_log += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{build_log}"
                )
            os.replace(tmp, lib_path)
        finally:
            shutil.rmtree(obj_dir, ignore_errors=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    lib.build_log = build_log
    return lib


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` (the kernels one call of ``wrapper`` launched) to
    ``wrapper.launches``: the wrappers run on one thread per device, and
    ``+=`` on a shared attribute is not atomic."""
    with _count_lock:
        wrapper.launches += n


def launch_counter_table() -> dict:
    """Every kernel wrapper that counts its launches, by kernel: K1-K11, the
    ports of the TPU kernels, K12, the tunnelled claim step, ``blur``, the
    Gaussian blur's kernel (no TPU kernel for either: XLA's code), and
    ``maxima``, the plateau maxima pair after K2 (none: the JAX package
    rides K2's band sweeps)."""
    from particle_col_image_segmentation_tpu_torch import ops
    from particle_col_image_segmentation_tpu_torch.ops import watershed_tiles as wt

    return {
        "K1": [ops.median_label_filter_cuda, ops.median_label_filter_rows_padded_cuda],
        "K2": [ops.ccl_cuda],
        "K3": [ops.compact_labels_cuda],
        "K4": [ops.region_counts_cuda, ops.region_sums_cuda, ops.bin_histogram_cuda],
        "K5": [ops.region_table_cuda], "K6": [ops.table_lookup_cuda],
        "K7": [ops.centroid_sums_cuda], "K8": [ops.particle_fill_step_cuda],
        "K9": [ops.edt_sq_cuda], "K10": [wt.watershed_cost_pass_cuda],
        "K11": [wt.watershed_label_pass_cuda],
        "K12": [wt.tunnel_init_cuda, wt.claim_labels_tunnel_cuda],
        "blur": [ops.gaussian_blur_cuda], "maxima": [ops.plateau_maxima_cuda],
    }


def launch_counters() -> tuple:
    """(reset_counts, read_counts) over ``launch_counter_table``: reset just
    before a path runs, read just after (launches a kernel, K1-K12,
    ``blur`` and ``maxima``)."""
    counters = launch_counter_table()

    def reset_counts() -> None:
        with _count_lock:
            for fns in counters.values():
                for fn in fns:
                    fn.launches = 0

    def read_counts() -> dict:
        with _count_lock:
            return {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}

    return reset_counts, read_counts


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        msg = library().pcis_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s device (launch target)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(
                f"{name}: expected CUDA tensors on one device, got {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
