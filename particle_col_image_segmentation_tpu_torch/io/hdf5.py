"""Host-side HDF5 codecs.

Reference behavior (tiff_analysis.py:118-120, 639-641): open the file, take
the *first* dataset key, read it fully into a NumPy array.
refine_boundaries.py:29-31 reads the named ``exported_data`` dataset.
"""

from __future__ import annotations

import numpy as np


def load_h5_plane(path: str, key: str | None = None) -> np.ndarray:
    """Load a dataset from an Ilastik-style .h5 export.

    ``key=None`` reads the first key (reference tiff_analysis semantics);
    pass ``"exported_data"`` for probability exports (refine_boundaries).
    """
    import h5py

    with h5py.File(path, "r") as f:
        if key is None:
            key = next(iter(f.keys()))
        return np.asarray(f[key][()])


def save_h5_plane(path: str, arr: np.ndarray, key: str = "exported_data") -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset(key, data=arr)
