"""K9: the capped squared-EDT kernel's wrapper, the transform's dispatch, and
the certified-exact transform built on it.

Counterpart of ``particle_col_image_segmentation_tpu/ops/edt_tiles.py``
(``edt_sq_pallas``, ``edt_sq_auto``) and of ``edt_sq_exact_auto`` in
``particle_col_image_segmentation_tpu/ops/edt.py``.  The JAX dispatch takes its Pallas
kernel only for cap > 8 on lane-aligned planes; here every CUDA tensor takes
``csrc/edt.cu`` whatever the cap or the plane size, and its output equals the
plain ``ops.edt.edt_sq`` exactly.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch._dispatch import use_kernel
from particle_col_image_segmentation_tpu_torch.ops.edt import edt_sq, edt_sq_exact

__all__ = ["edt_sq_cuda", "edt_sq_auto", "edt_sq_exact_auto", "MAX_CAP"]

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


def edt_sq_cuda(feature: torch.Tensor, cap: int) -> torch.Tensor:
    """K9 on a contiguous CUDA bool/uint8 [..., H, W] stack (nonzero =
    feature) → int32 squared distances, exact up to ``cap``, in
    (cap², (cap+1)²] past it.  Any H, W ≥ 1 and any cap in [0, MAX_CAP], cap > H included."""
    _kernels.require_cuda("edt_sq_cuda", feature)
    if feature.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"edt_sq_cuda: expected bool or uint8 features, got {feature.dtype}")
    check_cap("edt_sq_cuda", cap)
    B, H, W = as_planes("edt_sq_cuda", feature)
    out = torch.empty(feature.shape, dtype=torch.int32, device=feature.device)
    scratch = torch.empty_like(out)  # row-pass distances
    lib = _kernels.library()
    with torch.cuda.device(feature.device):
        err = lib.pcis_edt_sq(
            feature.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, W,
            cap, _kernels.stream_of(feature),
        )
    _kernels.check(err, "edt_sq_cuda")
    edt_sq_cuda.launches += 1
    return out


edt_sq_cuda.launches = 0


def edt_sq_auto(feature: torch.Tensor, cap: int) -> torch.Tensor:
    """K9 for a CUDA tensor, whatever the cap; the plain transform for a CPU
    tensor.  The values are the same either way."""
    if use_kernel(feature):
        return edt_sq_cuda(feature, cap)
    return edt_sq(feature, cap)


def edt_sq_exact_auto(feature: torch.Tensor, probe_cap: int = 32,
                      rows_per_step: int = 8) -> torch.Tensor:
    """Exact squared EDT with a capped fast path and a runtime certificate.

    The capped transform (K9 on a CUDA tensor) is exact wherever the true
    distance ≤ ``probe_cap`` and exceeds probe_cap² wherever it is not, so
    no value above probe_cap² anywhere in the batch proves the capped result
    exact.  Otherwise the exact O(H²·W) transform runs from scratch.  The
    output equals ``ops.edt.edt_sq_exact`` either way."""
    feature = (feature != 0).contiguous()
    capped = edt_sq_auto(feature, probe_cap)
    if bool((capped > probe_cap * probe_cap).any()):
        return edt_sq_exact(feature, rows_per_step)
    return capped
