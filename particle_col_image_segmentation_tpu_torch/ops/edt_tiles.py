"""K9: the capped squared-EDT kernel's wrapper, the transform's dispatch, and
the certified-exact transform built on it.

Counterpart of ``particle_col_image_segmentation_tpu/ops/edt_tiles.py``
(``edt_sq_pallas``, ``edt_sq_auto``) and of ``edt_sq_exact_auto`` in
``particle_col_image_segmentation_tpu/ops/edt.py``.  The JAX dispatch takes its Pallas
kernel only for cap > 8 on lane-aligned planes; here every CUDA tensor takes
``csrc/edt.cu`` whatever the cap or the plane size, and its output equals the
plain ``ops.edt.edt_sq`` exactly.  The kernel is one launch with no scratch
plane up to ``max_tile_cap()`` (180) and a row pass plus column tiles
through an int32 scratch plane past it, chosen by cap alone.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.edt import edt_sq, edt_sq_exact
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage

__all__ = ["edt_sq_cuda", "edt_sq_auto", "edt_sq_exact_auto", "max_tile_cap", "MAX_CAP"]

# (cap+1)² plus a dy² ≤ cap² must stay inside int32
MAX_CAP = 32766


def as_planes(name: str, t: torch.Tensor):
    """(B, H, W) of a non-empty [..., H, W] plane stack on the card, checked
    for the kernels' int32 plane indexing and grid limits."""
    if t.ndim < 2 or t.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty [..., H, W] stack, got {tuple(t.shape)}")
    H, W = t.shape[-2:]
    B = t.numel() // (H * W)
    if H * W >= 2**31 or B > 65535:
        raise ValueError(f"{name}: {B} planes of {H}x{W} exceed the kernel's index range")
    return B, H, W


def check_cap(name: str, cap: int) -> None:
    if not 0 <= cap <= MAX_CAP:
        raise ValueError(f"{name}: cap must be in [0, {MAX_CAP}], got {cap}")


def max_tile_cap() -> int:
    """The largest cap K9's one-kernel route takes (its window fits shared
    memory); larger caps take the row pass and column tiles."""
    return _kernels.library().pcis_edt_max_tile_cap()


def _flag_rows(flag_rows, H: int):
    lo, hi = (0, H) if flag_rows is None else flag_rows
    if not 0 <= lo <= hi <= H:
        raise ValueError(f"flag_rows {flag_rows} is not a row window of {H} rows")
    return lo, hi


def edt_sq_cuda(feature: torch.Tensor, cap: int, with_flag: bool = False, flag_rows=None):
    """K9 on a contiguous CUDA bool/uint8 [..., H, W] stack (nonzero =
    feature) → int32 squared distances, exact up to ``cap``, in
    (cap², (cap+1)²] past it.  Any H, W ≥ 1 and any cap in [0, MAX_CAP], cap > H
    included.  With ``with_flag``, returns (distances, flag): an int32 [1]
    on the card, nonzero iff some distance exceeds cap², written by the
    kernel itself (``edt_sq_cuda.last_route`` says which route ran).
    ``flag_rows=(lo, hi)`` lets only the rows [lo, hi) of each plane raise
    the flag: a row band transformed with halo rows around it (K9's band
    mode)."""
    _kernels.require_cuda("edt_sq_cuda", feature)
    if feature.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"edt_sq_cuda: expected bool or uint8 features, got {feature.dtype}")
    check_cap("edt_sq_cuda", cap)
    B, H, W = as_planes("edt_sq_cuda", feature)
    lo, hi = _flag_rows(flag_rows, H)
    out = torch.empty(feature.shape, dtype=torch.int32, device=feature.device)
    tiled = cap <= max_tile_cap()
    scratch = None if tiled else torch.empty_like(out)  # row-pass distances
    flag = torch.empty(1, dtype=torch.int32, device=feature.device) if with_flag else None
    lib = _kernels.library()
    with torch.cuda.device(feature.device):
        err = lib.pcis_edt_sq(
            feature.data_ptr(), out.data_ptr(), None if tiled else scratch.data_ptr(),
            None if flag is None else flag.data_ptr(), B, H, W, cap, lo, hi,
            _kernels.stream_of(feature),
        )
    _kernels.check(err, "edt_sq_cuda")
    _kernels.count_launch(edt_sq_cuda)
    edt_sq_cuda.last_route = "tile" if tiled else "two-kernel"
    return (out, flag) if with_flag else out


edt_sq_cuda.launches = 0
edt_sq_cuda.last_route = None


def edt_sq_auto(feature: torch.Tensor, cap: int, with_flag: bool = False, flag_rows=None):
    """K9 for a CUDA tensor, whatever the cap; the plain transform for a CPU
    tensor.  The values are the same either way.  With ``with_flag``,
    returns (distances, flag), the flag nonzero iff some distance of the
    rows ``flag_rows`` (default every row) exceeds cap² (K9 writes it on
    the card)."""
    if use_kernel(feature):
        return edt_sq_cuda(feature, cap, with_flag=with_flag, flag_rows=flag_rows)
    out = edt_sq(feature, cap)
    if not with_flag:
        return out
    lo, hi = _flag_rows(flag_rows, out.shape[-2])
    return out, (out[..., lo:hi, :] > cap * cap).any()


def edt_sq_exact_auto(feature: torch.Tensor, probe_cap: int = 32,
                      rows_per_step: int = 8) -> torch.Tensor:
    """Exact squared EDT with a capped fast path and a runtime certificate.

    The capped transform (K9 on a CUDA tensor) is exact wherever the true
    distance ≤ ``probe_cap`` and exceeds probe_cap² wherever it is not, so
    no value above probe_cap² anywhere in the batch proves the capped result
    exact; on the card K9 writes that certificate as a flag beside its
    output, and one host sync reads it.  Otherwise the exact O(H²·W)
    transform runs from scratch.  The output equals ``ops.edt.edt_sq_exact``
    either way."""
    if feature.dtype not in (torch.bool, torch.uint8):
        feature = feature != 0  # K9 and the plain versions read any nonzero as a feature
    feature = feature.contiguous()
    capped, deep = edt_sq_auto(feature, probe_cap, with_flag=True)
    with stage("pcis.sync.edt_certificate"):
        deep = bool(deep)
    if deep:
        with stage("pcis.edt.exact"):
            return edt_sq_exact(feature, rows_per_step)
    return capped
