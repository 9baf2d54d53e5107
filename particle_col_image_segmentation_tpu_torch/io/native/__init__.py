"""ctypes bindings for the port's native TIFF codec (``pcis_io.cpp``).

The shared library is built with g++ on first use under ``build/`` at the
checkout root (``BUILD_DIR``), named by a hash of the source and the g++
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is written into the package.  Each build goes to a private temp
name and is renamed into place, so processes that build at once (test
workers, parallel CLIs) never load a half-written file.

Every entry point degrades as the JAX package's codec does: ``available()``
is False when the library cannot be built or loaded (the compiler's output
is logged once), and TIFFs the codec does not support make it report 0
pages, so callers fall back to PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger

SRC = Path(__file__).resolve().parent / "pcis_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pcis_torch_io"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBS = ("-lz",)

_log = get_logger("native")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


class TiffPageInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("samples_per_pixel", ctypes.c_uint32),
    ]


_P = ctypes.c_void_p
_SIGNATURES = {
    "pcis_tiff_inspect": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(TiffPageInfo)]),
    "pcis_tiff_read": (ctypes.c_int, [ctypes.c_char_p, _P, ctypes.c_uint64]),
    "pcis_tiff_write": (ctypes.c_int, [ctypes.c_char_p, _P, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint32]),
    "pcis_prefetch_start": (_P, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]),
    "pcis_prefetch_wait": (ctypes.c_uint64, [_P, ctypes.c_int]),
    "pcis_prefetch_geom": (ctypes.c_int, [_P, ctypes.c_int, ctypes.POINTER(TiffPageInfo)]),
    "pcis_prefetch_take": (ctypes.c_int, [_P, ctypes.c_int, _P, ctypes.c_uint64]),
    "pcis_prefetch_free": (None, [_P]),
}


def lib_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libpcis_io_{h.hexdigest()[:16]}.so"


def build() -> Optional[ctypes.CDLL]:
    """Build (if this source has no library yet) and load the codec; None,
    with the reason logged, when g++ is missing, fails, or the library does
    not load."""
    path = lib_path()
    if not path.exists():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode == 0:
                os.replace(tmp, path)
        except OSError as e:  # no g++, or an unwritable build directory
            _log.warning("native TIFF codec not built (%s); TIFFs are read with PIL", e)
            return None
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            _log.warning("native TIFF codec failed to build (g++ exit %d); TIFFs are "
                         "read with PIL:\n%s\n%s", res.returncode, " ".join(cmd), res.stderr)
            return None
    try:
        # the default RTLD_LOCAL: the JAX package's codec exports the same
        # symbols, and each handle must resolve its own
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _log.warning("native TIFF codec did not load (%s); TIFFs are read with PIL", e)
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The codec under ``BUILD_DIR``, built once a process; a failure is
    remembered, so it is tried and logged once."""
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            _lib = build()
            _build_failed = _lib is None
        return _lib


def available() -> bool:
    return get_lib() is not None


def read_tiff(path: str) -> Optional[np.ndarray]:
    """[N,H,W] (or [H,W] single page) for supported TIFFs; None → fall back."""
    lib = get_lib()
    if lib is None:
        return None
    info = TiffPageInfo()
    pages = lib.pcis_tiff_inspect(path.encode(), ctypes.byref(info))
    if pages <= 0:
        return None
    dtype = np.uint8 if info.bits_per_sample == 8 else np.uint16
    out = np.empty((pages, info.height, info.width), dtype)
    rc = lib.pcis_tiff_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        return None
    return out[0] if pages == 1 else out


def write_tiff(path: str, arr: np.ndarray) -> bool:
    """Write a single grayscale plane; False → caller should fall back."""
    lib = get_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 2 or arr.dtype not in (np.dtype(np.uint8), np.dtype(np.uint16)):
        return False
    bps = 8 if arr.dtype == np.uint8 else 16
    rc = lib.pcis_tiff_write(
        path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
        arr.shape[0], arr.shape[1], bps,
    )
    return rc == 0


class NativePrefetcher:
    """Threaded native decode pool over a fixed path list."""

    def __init__(self, paths: List[str], num_threads: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native io unavailable")
        self._lib = lib
        self._paths = paths
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.pcis_prefetch_start(arr, len(paths), num_threads)

    def get(self, idx: int) -> Optional[np.ndarray]:
        # the decode workers record each file's geometry themselves (one
        # mmap parse a file, inside the pool), so get() never re-reads it
        if self._handle is None:
            # a NULL handle would segfault inside the C wait, not raise
            raise RuntimeError("NativePrefetcher used after close()")
        if not 0 <= idx < len(self._paths):
            raise IndexError(idx)
        size = self._lib.pcis_prefetch_wait(self._handle, idx)
        info = TiffPageInfo()
        pages = self._lib.pcis_prefetch_geom(self._handle, idx, ctypes.byref(info))
        if size == 0 or pages <= 0:
            return None
        dtype = np.uint8 if info.bits_per_sample == 8 else np.uint16
        out = np.empty((pages, info.height, info.width), dtype)
        if out.nbytes != size:
            return None
        rc = self._lib.pcis_prefetch_take(
            self._handle, idx, out.ctypes.data_as(ctypes.c_void_p), out.nbytes
        )
        if rc != 0:
            return None
        return out[0] if pages == 1 else out

    def close(self):
        if self._handle:
            self._lib.pcis_prefetch_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
