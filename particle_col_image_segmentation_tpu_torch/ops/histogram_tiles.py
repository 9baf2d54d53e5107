"""K4 as the Otsu histogram: the fused bin-and-count kernel's wrapper and
its plain version.

Counterpart of the TPU route of
``particle_col_image_segmentation_tpu/ops/threshold.py`` ``_histogram_batch``,
which passes the bin ids to K4 (``regionprops_tiles.py`` ``_counts_kernel``)
as region ids, R + 1 = bins, with uint8 zeros as values.  Here
``csrc/histogram.cu`` bins each float32 pixel and counts it in one pass: no
bin-id plane, no zeros plane, no sums or class table.  Its counts equal the
plain version's (``bin_histogram``: the bin ids, then one ``bincount``) bit
for bit, since it bins in the same float32 order.
"""

from __future__ import annotations

import torch

from particle_col_image_segmentation_tpu_torch import _kernels

__all__ = ["bin_histogram", "bin_histogram_cuda"]


def _bin_index(x3: torch.Tensor, lo, span, bins: int) -> torch.Tensor:
    """int32 bin of each pixel: clip(int32((x − lo) / span · bins), 0,
    bins − 1), in that float32 order (x == hi lands in bin ``bins`` and is
    clipped)."""
    return ((x3 - lo) / span * bins).to(torch.int32).clamp_(0, bins - 1)


def _bincount(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """int32 [..., bins] counts of each plane's bin ids ([H, W] or [B, H, W]
    int32): one ``bincount`` of the planes' offset ids."""
    flat = idx.reshape(-1, idx.shape[-2] * idx.shape[-1]).to(torch.int64)
    planes = flat.shape[0]
    flat = flat + bins * torch.arange(planes, device=idx.device)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=planes * bins)
    return counts.to(torch.int32).reshape(idx.shape[:-2] + (bins,))


def bin_histogram(
    x3: torch.Tensor, lo: torch.Tensor, span: torch.Tensor, bins: int,
) -> torch.Tensor:
    """int32 [B, bins] counts of each plane of a float32 [B, H, W] stack over
    [lo, lo + span] ([B, 1, 1] each, as ``threshold._value_range`` gives
    them): the plain version of ``bin_histogram_cuda``."""
    return _bincount(_bin_index(x3, lo, span, bins), bins)


def bin_histogram_cuda(
    x3: torch.Tensor, lo: torch.Tensor, span: torch.Tensor, bins: int,
) -> torch.Tensor:
    """K4's histogram kernel on a contiguous float32 [B, H, W] CUDA stack and
    its planes' float32 ``lo`` and ``span`` (B values each, on the card; no
    host sync reads them) → int32 [B, bins] counts, equal to
    ``bin_histogram`` for any ``bins`` ≥ 1 (past 16384 bins, one launch a
    slice of 16384)."""
    _kernels.require_cuda("bin_histogram_cuda", x3, lo, span)
    if x3.dtype != torch.float32 or lo.dtype != torch.float32 or span.dtype != torch.float32:
        raise ValueError(
            f"bin_histogram_cuda: expected float32 pixels, lo and span, got {x3.dtype}, "
            f"{lo.dtype} and {span.dtype}"
        )
    if x3.ndim != 3 or x3.numel() == 0:
        raise ValueError(
            f"bin_histogram_cuda: expected a non-empty [B, H, W] stack, got {tuple(x3.shape)}"
        )
    B, H, W = x3.shape
    if lo.numel() != B or span.numel() != B:
        raise ValueError(f"bin_histogram_cuda: expected {B} lo and span values, got "
                         f"{lo.numel()} and {span.numel()}")
    if B > 65535 or H * W >= 2**31:
        raise ValueError(
            f"bin_histogram_cuda: {tuple(x3.shape)} exceeds 65535 planes or int32 indices"
        )
    if not 1 <= bins < 2**31:
        raise ValueError(f"bin_histogram_cuda: bins {bins} outside [1, 2**31)")
    counts = torch.empty((B, bins), dtype=torch.int32, device=x3.device)
    lib = _kernels.library()
    with torch.cuda.device(x3.device):
        err = lib.pcis_bin_histogram(
            x3.data_ptr(), lo.data_ptr(), span.data_ptr(), counts.data_ptr(), B, H, W, bins,
            _kernels.stream_of(x3),
        )
    _kernels.check(err, "bin_histogram_cuda")
    _kernels.count_launch(bin_histogram_cuda)
    return counts


bin_histogram_cuda.launches = 0
