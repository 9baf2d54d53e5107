"""``Region``, the subset of skimage's RegionProperties the reference reads
(the port's copy of the class in the JAX package's ``oracle/ndimage.py``)."""

from __future__ import annotations


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
