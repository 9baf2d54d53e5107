"""skimage-equivalent image primitives in pure NumPy/SciPy (the port's copy of
the JAX package's ``oracle/ndimage.py``, which the port does not import).

These reproduce the semantics of the skimage calls made by the reference
(tiff_analysis.py:43-45 imports; refine_boundaries.py:22-24 imports):

  * ``disk(r)``                — skimage.morphology.disk
  * ``label(img)``             — skimage.measure.label (equal-value
                                 connectivity, default full connectivity,
                                 background=0, ids in raster-first-pixel order)
  * ``regionprops(lab)``       — area / centroid / bbox / coords subset
  * ``binary_dilation``        — skimage.morphology.binary_dilation
  * ``local_maxima``           — skimage.morphology.local_maxima
                                 (plateau-aware, allow_borders=True)
  * ``watershed``              — skimage.segmentation.watershed
                                 (priority-flood, connectivity=1, FIFO ties)
  * ``imgaussfilt``            — MATLAB imgaussfilt (replicate padding,
                                 kernel size 2*ceil(2σ)+1)
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
from scipy import ndimage as ndi

__all__ = [
    "disk",
    "label",
    "regionprops",
    "Region",
    "binary_dilation",
    "binary_erosion",
    "local_maxima",
    "watershed",
    "imgaussfilt",
    "bwboundaries_pixels",
]


def disk(radius: int, dtype=np.uint8) -> np.ndarray:
    """skimage.morphology.disk parity: pixels with x²+y² ≤ r²."""
    r = int(radius)
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    return (yy * yy + xx * xx <= r * r).astype(dtype)


_STRUCT8 = np.ones((3, 3), dtype=bool)


def label(
    image: np.ndarray,
    background: int = 0,
    connectivity: int = 2,
    return_num: bool = False,
):
    """Connected-component labeling with skimage.measure.label semantics.

    Two pixels are connected when they are neighbors (full 8-connectivity by
    default, 4 when connectivity=1) and have the same value.  Pixels equal to
    ``background`` get label 0.  Output ids are 1..N ordered by the raster
    position of each component's first pixel (skimage ordering).
    """
    image = np.asarray(image)
    uniq_vals = np.unique(image)
    if len(uniq_vals) > 16:
        provisional = _label_graph(image, background, connectivity)
    else:
        structure = _STRUCT8 if connectivity == 2 else None  # None → 4-conn
        provisional = np.zeros(image.shape, dtype=np.int64)
        offset = 0
        for v in uniq_vals:
            if v == background:
                continue
            comp, n = ndi.label(image == v, structure=structure)
            mask = comp > 0
            provisional[mask] = comp[mask] + offset
            offset += n
    out, n = _relabel_raster_order(provisional)
    if return_num:
        return out, n
    return out


def _label_graph(image: np.ndarray, background, connectivity: int) -> np.ndarray:
    """Equal-value CCL via one sparse connected-components pass — the
    per-value scipy loop is O(#distinct values) and explodes on float images
    (e.g. distance transforms)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as cc

    H, W = image.shape
    idx = np.arange(H * W).reshape(H, W)
    fg = np.ones((H, W), bool) if background is None else image != background
    rows_list, cols_list = [], []
    offsets = [(0, 1), (1, 0)]
    if connectivity == 2:
        offsets += [(1, 1), (1, -1)]
    for dy, dx in offsets:
        a = (slice(0, H - dy), slice(max(0, -dx), W - max(0, dx)))
        b = (slice(dy, H), slice(max(0, dx), W - max(0, -dx)))
        eq = (image[a] == image[b]) & fg[a] & fg[b]
        rows_list.append(idx[a][eq])
        cols_list.append(idx[b][eq])
    r = np.concatenate(rows_list)
    c = np.concatenate(cols_list)
    g = coo_matrix(
        (np.ones(len(r), bool), (r, c)), shape=(H * W, H * W)
    )
    n, comp = cc(g, directed=False)
    out = comp.reshape(H, W).astype(np.int64) + 1
    out[~fg] = 0
    return out


def _relabel_raster_order(provisional: np.ndarray):
    """Relabel positive ids to 1..N by raster order of first occurrence."""
    flat = provisional.ravel()
    uniq, first_idx = np.unique(flat, return_index=True)
    keep = uniq > 0
    uniq, first_idx = uniq[keep], first_idx[keep]
    order = np.argsort(first_idx, kind="stable")
    remap = np.zeros(int(uniq.max()) + 1 if uniq.size else 1, dtype=np.int64)
    remap[uniq[order]] = np.arange(1, uniq.size + 1)
    return remap[flat].reshape(provisional.shape).astype(np.int64), int(uniq.size)


class Region:
    """Subset of skimage RegionProperties used by the reference.

    Supports attribute access (.area, .centroid, .bbox, .coords, .label),
    dict-style access (reference: tiff_analysis.py:1033 reads
    ``cluster["area"]``), and ad-hoc attributes (reference :781 monkey-patches
    ``.cells``).
    """

    def __init__(self, lab: int, area: int, centroid, bbox, coords):
        self.label = lab
        self.area = area
        self.centroid = centroid
        self.bbox = bbox
        self.coords = coords

    def __getitem__(self, key):
        return getattr(self, key)

    def __repr__(self):
        return f"Region(label={self.label}, area={self.area}, centroid={self.centroid})"


def regionprops(label_image: np.ndarray) -> List[Region]:
    """Per-region area / centroid / bbox / coords, for labels 1..N in order."""
    lab = np.asarray(label_image)
    n = int(lab.max()) if lab.size else 0
    if n == 0:
        return []
    flat = lab.ravel()
    pos = np.flatnonzero(flat)
    ids = flat[pos]
    order = np.argsort(ids, kind="stable")  # stable → coords stay raster-ordered
    pos, ids = pos[order], ids[order]
    counts = np.bincount(ids, minlength=n + 1)[1:]
    rows, cols = np.divmod(pos, lab.shape[1])
    starts = np.concatenate([[0], np.cumsum(counts)])
    regions = []
    for k in range(n):
        s, e = starts[k], starts[k + 1]
        if s == e:  # absent label id — skimage skips it, so do we
            continue
        r, c = rows[s:e], cols[s:e]
        regions.append(
            Region(
                lab=k + 1,
                area=int(counts[k]),
                centroid=(float(r.mean()), float(c.mean())),
                bbox=(int(r.min()), int(c.min()), int(r.max()) + 1, int(c.max()) + 1),
                coords=np.stack([r, c], axis=1),
            )
        )
    return regions


def binary_dilation(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """skimage.morphology.binary_dilation parity (centered SE)."""
    return ndi.binary_dilation(np.asarray(image, bool), structure=footprint > 0)


def binary_erosion(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    return ndi.binary_erosion(
        np.asarray(image, bool), structure=footprint > 0, border_value=True
    )


def local_maxima(image: np.ndarray, connectivity: int = 2) -> np.ndarray:
    """Plateau-aware local maxima (skimage.morphology.local_maxima parity).

    A connected plateau of equal values is a local maximum iff none of its
    pixels has a strictly greater neighbor. allow_borders=True semantics.
    """
    img = np.asarray(image)
    structure = _STRUCT8 if connectivity == 2 else ndi.generate_binary_structure(2, 1)
    maxf = ndi.maximum_filter(img, footprint=structure, mode="constant", cval=-np.inf)
    has_higher_neighbor = maxf > img
    # Label equal-value plateaus, then invalidate plateaus touching a higher px.
    # A below-minimum background sentinel ensures every pixel gets labeled.
    sentinel = np.min(img) - 1
    plateaus = label(img, background=sentinel, connectivity=connectivity)
    n = plateaus.max()
    if n == 0:
        return np.zeros_like(img, dtype=bool)
    bad = np.zeros(n + 1, dtype=bool)
    np.logical_or.at(bad, plateaus[has_higher_neighbor], True)
    return ~bad[plateaus]


def watershed(
    image: np.ndarray,
    markers: np.ndarray,
    mask: Optional[np.ndarray] = None,
    connectivity: int = 1,
) -> np.ndarray:
    """Priority-flood watershed (skimage.segmentation.watershed parity).

    Floods ``markers`` outward through ``mask`` in order of ascending
    ``image`` value, FIFO tie-breaking (skimage's age counter).
    Reference call site: refine_boundaries.py:73.
    """
    img = np.asarray(image)
    out = np.asarray(markers).astype(np.int64).copy()
    if mask is None:
        mask = np.ones(img.shape, dtype=bool)
    else:
        mask = np.asarray(mask, bool)
    out[~mask] = 0
    H, W = img.shape
    if connectivity == 2:
        neigh = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
    else:
        neigh = [(-1, 0), (0, -1), (0, 1), (1, 0)]
    heap: list = []
    age = 0
    ys, xs = np.nonzero((out > 0) & mask)
    for y, x in zip(ys.tolist(), xs.tolist()):
        heapq.heappush(heap, (img[y, x], age, y, x))
        age += 1
    labeled = out > 0
    while heap:
        _, _, y, x = heapq.heappop(heap)
        lab_v = out[y, x]
        for dy, dx in neigh:
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and mask[ny, nx] and not labeled[ny, nx]:
                labeled[ny, nx] = True
                out[ny, nx] = lab_v
                heapq.heappush(heap, (img[ny, nx], age, ny, nx))
                age += 1
    return out


def imgaussfilt(image: np.ndarray, sigma: float) -> np.ndarray:
    """MATLAB imgaussfilt parity: Gaussian blur, kernel 2*ceil(2σ)+1,
    'replicate' padding (reference .m:43-62)."""
    img = np.asarray(image, dtype=np.float64)
    half = int(np.ceil(2 * sigma))
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    out = ndi.convolve1d(img, k, axis=0, mode="nearest")
    out = ndi.convolve1d(out, k, axis=1, mode="nearest")
    return out


def bwboundaries_pixels(mask: np.ndarray) -> np.ndarray:
    """Boundary pixel coordinates of a binary mask (MATLAB bwboundaries
    analogue used only as a pixel list; reference .m:291-292).

    Boundary = mask pixels with at least one 4-neighbor outside the mask
    (or on the image border).
    """
    m = np.asarray(mask, bool)
    er = ndi.binary_erosion(m, structure=ndi.generate_binary_structure(2, 1), border_value=False)
    ys, xs = np.nonzero(m & ~er)
    return np.stack([ys, xs], axis=1)
