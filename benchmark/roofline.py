"""The least bytes a kernel must move, from shapes alone, and the card's
peak bandwidth: the yardstick of every roofline share.  A call's least
bytes are its entry driver's (``entries/<entry>.py``, ``CALL_BYTES``).

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
