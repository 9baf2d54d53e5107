"""The least bytes a kernel or a call must move, from shapes alone, and the
card's peak bandwidth: the yardstick of every roofline share.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; so a share can never pass 100 % unless
the time leaves out part of the work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, HBM3: NVIDIA's data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def k2_bytes(px: int, in_bytes: int) -> int:
    """K2 (CCL): the values read once, the int32 labels written once."""
    return px * (in_bytes + 4)


def k10_bytes(px: int) -> int:
    """K10 (watershed phase 1): float32 map and a flag byte in, float32
    cost out."""
    return px * (4 + 1 + 4)


def k11_bytes(px: int) -> int:
    """K11 (watershed phase 2): float32 cost and map, a flag byte and int32
    markers in, int32 labels out."""
    return px * (4 + 4 + 1 + 4 + 4)


def segment_call_bytes(B: int, H: int, W: int, options: dict) -> int:
    """``fused_segment_batch``: uint8 planes in; int32 ``seg`` and the two
    int32 region tables of max_regions + 1 rows out (the per-plane stats
    are a few bytes)."""
    return B * H * W * (1 + 4) + B * (options["max_regions"] + 1) * 4 * 2


def refine_call_bytes(B: int, H: int, W: int, options: dict) -> int:
    """``refine_plane_device``: float32 maps in; int32 labels and markers
    and float32 distance out, and the five int32 columns of the centroid
    table of max_regions + 1 rows."""
    return B * H * W * (4 + 4 + 4 + 4) + B * (options["max_regions"] + 1) * 4 * 5


CALL_BYTES = {"segment": segment_call_bytes, "refine": refine_call_bytes}
