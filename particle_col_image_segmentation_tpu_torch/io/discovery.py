"""Dataset discovery and raw-capture folder normalization (host side): the
port's copy of the JAX package's ``io/discovery.py``.

Reference counterparts: tiff_analysis.py:1113-1123 (recursive .h5 grouping),
create_file_structure.py (acquisition folder normalizer), and the shared
path-derivation helpers (tiff_analysis.py:619-624).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from particle_col_image_segmentation_tpu_torch.config import CAPTURE_CHANNELS


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


# ---- raw-capture normalization (create_file_structure.py parity) ----------


def create_folder(folder_name: str) -> None:
    if not os.path.exists(folder_name):
        os.makedirs(folder_name)


def remove_channels(filename: str) -> str:
    """Strip ``_CY5_``/``_RFP_``/``_GFP_``/``_DAPI_`` tokens
    (reference create_file_structure.py:23-26)."""
    for channel in CAPTURE_CHANNELS:
        filename = filename.replace(f"_{channel['name']}_", "_")
    return filename


def clean_acquisition_name(input_file: str) -> str:
    """Folder name = filename minus .tif suffix, channel tokens, _zstack
    (reference :28-32).  Tokens are stripped from the BASENAME only — the
    reference replaces over the whole path (create_file_structure.py:30-31),
    which silently redirects output when a directory name contains a
    channel/_zstack token."""
    head, tail = os.path.split(input_file)
    tail = remove_channels(tail.split(".tif")[0]).replace("_zstack", "")
    return os.path.join(head, tail)


def get_similar_files(file_name: str, folder: str) -> List[str]:
    """Sibling _mip.tif/.jpg files sharing the cleaned prefix
    (reference :40-49)."""
    similar = [os.path.join(folder, file_name)]
    clean = remove_channels(file_name).replace("_zstack", "").replace(".tif", "")
    for file in os.listdir(folder):
        check = remove_channels(file).replace("_zstack", "").replace(".tif", "")
        # token-boundary match, not substring (reference :44 uses `in`):
        # 'run_Pos1' must not steal 'run_Pos10_mip.tif' — a substring hit
        # silently misfiles the sibling acquisition's MIP on disk
        if (check == clean or check.startswith(clean + "_")) and (
            "_mip.tif" in file.lower() or ".jpg" in file.lower()
        ):
            similar.append(os.path.join(folder, file))
    return similar


def get_tiff_files(top_level_folder_path: str) -> List[str]:
    """One-level scan for non-mip .tif files, skipping dot-dirs
    (reference :69-82)."""
    tiff_files = []
    for folder in os.listdir(top_level_folder_path):
        folder_path = os.path.join(top_level_folder_path, folder)
        if not os.path.isdir(folder_path) or folder.startswith("."):
            continue
        for file in os.listdir(folder_path):
            if file.lower().endswith(".tif") and "mip" not in file.lower():
                tiff_files.append(os.path.join(folder_path, file))
    return tiff_files


def normalize_acquisition(input_file: str) -> str:
    """Move a z-stack and its MIP siblings into a clean per-acquisition folder
    (reference :52-60). Returns the created folder."""
    input_file_name = os.path.basename(input_file)
    input_folder = os.path.dirname(input_file)
    clean_folder = clean_acquisition_name(input_file)
    create_folder(clean_folder)
    for file in get_similar_files(input_file_name, input_folder):
        os.rename(file, os.path.join(clean_folder, os.path.basename(file)))
    return clean_folder


def normalize_capture_tree(top_level_folder: str) -> List[str]:
    """create_file_structure.process_folder parity (reference :84-88)."""
    return [normalize_acquisition(f) for f in get_tiff_files(top_level_folder)]
