"""Parity metrics (BASELINE.json contract; the port's copy of the JAX
package's ``utils/metrics.py``).

``boundary_iou`` is the watershed-parity measure: skimage's priority-flood
tie-breaking is sequential and unreproducible in a parallel flood, so
watershed outputs are compared by the IoU of their *boundary bands* rather
than exact equality.  All other kernels are held to exact integer parity
(``masks_equal``) and ≤1e-6 float parity.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi


def label_boundaries(labels: np.ndarray) -> np.ndarray:
    """Pixels adjacent (4-conn) to a different label — the boundary band."""
    lab = np.asarray(labels)
    bound = np.zeros(lab.shape, bool)
    bound[:-1, :] |= lab[:-1, :] != lab[1:, :]
    bound[1:, :] |= lab[:-1, :] != lab[1:, :]
    bound[:, :-1] |= lab[:, :-1] != lab[:, 1:]
    bound[:, 1:] |= lab[:, :-1] != lab[:, 1:]
    return bound


def boundary_iou(a: np.ndarray, b: np.ndarray, tolerance_px: int = 1) -> float:
    """IoU of the two labelings' boundary bands, each dilated by
    ``tolerance_px`` (so off-by-one tie pixels don't count as misses)."""
    ba, bb = label_boundaries(a), label_boundaries(b)
    if tolerance_px > 0:
        st = ndi.generate_binary_structure(2, 2)
        ba = ndi.binary_dilation(ba, st, iterations=tolerance_px)
        bb = ndi.binary_dilation(bb, st, iterations=tolerance_px)
    union = np.logical_or(ba, bb).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(ba, bb).sum() / union)


def masks_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Exact integer mask parity (the contract for every non-watershed op)."""
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))
