"""Dataset discovery (host side): the port's copy of the two functions it
calls from the JAX package's ``io/discovery.py``.

Reference counterparts: tiff_analysis.py:1113-1123 (recursive .h5 grouping)
and the shared path-derivation helpers (tiff_analysis.py:619-624).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


def get_h5_files_recursively(folder_path: str) -> Dict[str, List[str]]:
    """folder → list of .h5 filenames, via full walk (reference :1113-1123)."""
    h5_files: Dict[str, List[str]] = {}
    for root, _, files in os.walk(folder_path):
        for file in files:
            if file.endswith(".h5"):
                h5_files.setdefault(root, []).append(file)
    return h5_files


def get_pos_and_density_file_names(cur_folder: str) -> Tuple[str, str]:
    """Derive the density CSV path (written to the parent dir, named from the
    two ancestor folders) and the per-folder positions CSV path
    (reference :619-624)."""
    # Resolve first: the reference's TOP_LEVEL_FOLDER is always a deep
    # absolute path, so parts[-3:-1] exist there; a shallow relative CLI
    # argument (e.g. "exp/run") must not crash the name derivation.
    parts = os.path.abspath(cur_folder).split(os.sep)
    # even after abspath a path can have fewer than three components
    # (e.g. "/data" → ["", "data"]); pad with empty ancestor tokens rather
    # than crash the name derivation
    while len(parts) < 3:
        parts.insert(0, "")
    density_name = f"{parts[-3]}_{parts[-2]}_cell_density_info.csv"
    density_path = os.path.join(cur_folder, "..", density_name)
    cell_pos_path = os.path.join(cur_folder, f"{parts[-1]}_cell_pos.csv")
    return density_path, cell_pos_path
