"""Z-stack → per-plane per-channel TIFF splitting (split_zstack.py parity):
the port's copy of the JAX package's ``models/zsplit.py``.

The folder/naming logic reproduces the reference exactly; the codec is the
port's ``io/tiff.py`` (its native codec, PIL for what that cannot read).
The plane loop (reference :52-65) preserves the reference's quirks: a
per-plane shape check falls back to the 2-channel {0: RFP, 1: GFP} map,
sticky for the rest of the stack via reassignment each iteration.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

from particle_col_image_segmentation_tpu_torch.io.discovery import create_folder
from particle_col_image_segmentation_tpu_torch.io.tiff import read_zstack, write_tiff
from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger

DEFAULT_CHANNEL_MAP = {0: "CY5", 1: "RFP", 2: "GFP", 3: "DAPI"}

_log = get_logger("zsplit")


def _strip_tokens(path: str, tokens: Sequence[str]) -> str:
    """Remove filename tokens from the BASENAME only.  The reference
    replaces over the whole path string (split_zstack.py:28-30,34), which
    silently redirects output when a *directory* name contains a token
    (e.g. an acquisition root with "_mip" in it) — fixed here."""
    head, tail = os.path.split(path)
    for t in tokens:
        tail = tail.replace(t, "")
    return os.path.join(head, tail)


def get_clean_file_name(input_file: str) -> Tuple[str, str]:
    """Detect the channel-set token and derive the clean base name
    (reference split_zstack.py:19-30)."""
    root, _, _ = os.path.basename(input_file).partition(".")
    base_name = os.path.join(os.path.dirname(input_file), root)
    if "CY5_RFP_GFP_DAPI_" in root:
        channels = "_CY5_RFP_GFP_DAPI"
    elif "RFP_GFP_" in root:
        channels = "_RFP_GFP"
    else:
        return "", base_name
    clean = _strip_tokens(base_name, (channels, "_zstack", "_mip"))
    return channels, clean


def create_channel_folder(destination: str, used_channels: str, channel_name: str) -> str:
    """Derive and create the per-channel output folder (reference :32-36).

    The extension token strips case-insensitively: the folder scan accepts
    '.TIF' stacks, whose channel folders must not embed the extension."""
    tokens = (".tif", ".TIF", "_mip") + (
        (used_channels,) if used_channels else ()
    )
    clean = _strip_tokens(destination, tokens) + "_" + channel_name
    create_folder(clean)
    return clean


def split_planes(
    zstack, channel_indices: Sequence[int], channel_map=None
) -> Iterable[Tuple[int, str, "object"]]:
    """Yield (plane_index, channel_name, plane) for the selected channels.

    Reproduces the reference plane loop (:52-58) including the sticky
    2-channel fallback when a plane doesn't have 4 channels.
    """
    channel_map = dict(channel_map or DEFAULT_CHANNEL_MAP)
    channel_indices = list(channel_indices)
    for i, z_slice in enumerate(zstack):
        if z_slice.shape[0] != 4:
            if z_slice.shape[0] < 2:
                # the reference's fallback indexes channels {0, 1}; a
                # 1-channel plane would IndexError inside the fancy index
                raise ValueError(
                    f"plane {i} has {z_slice.shape[0]} channel(s) — the "
                    "2-channel RFP/GFP fallback (reference :53-55) needs "
                    "at least 2"
                )
            channel_map = {0: "RFP", 1: "GFP"}
            channel_indices = [0, 1]
        names = [channel_map[idx] for idx in channel_indices]
        selected = z_slice[channel_indices]
        for name, plane in zip(names, selected):
            yield i, name, plane


def process_tif(input_file: str, channel_indices: Sequence[int]) -> List[str]:
    """Move the stack into its clean folder, split planes per channel
    (reference :38-65). Returns written file paths."""
    input_file_end, _, _ = os.path.basename(input_file).partition(".")
    used_channels, clean_file_name = get_clean_file_name(input_file)
    create_folder(clean_file_name)
    destination = os.path.join(clean_file_name, os.path.basename(input_file))
    os.rename(input_file, destination)
    # Non-tif siblings (mip .jpg) are only moved (reference :48-49).  The
    # reference would also row-iterate a _mip.tif through the plane loop
    # (:52) and write per-row fragments — a latent defect (2-D mips are
    # projections, not stacks); here mips of any format are move-only.
    # basename only: a DIRECTORY containing "_mip" must not downgrade the
    # stacks inside it to move-only (same path-token bug class _strip_tokens
    # fixes for output naming)
    if (
        not input_file.lower().endswith(".tif")  # process_folder matches
        # extensions case-insensitively; '.TIF' stacks must split, not just
        # move
        or "_mip" in os.path.basename(input_file).lower()
    ):
        return []
    # The filename token is only a fallback hint: the TIFF's own ImageJ
    # channels= metadata (when present) decides the page grouping, exactly
    # as tifffile reconstructs [Z, C, H, W] for the reference (:50-51).
    n_ch = 4 if used_channels == "_CY5_RFP_GFP_DAPI" else 2
    zstack = read_zstack(destination, num_channels=n_ch)
    if zstack.ndim == 2:
        # a single-PAGE file named like a z-stack: row-iterating it (what
        # the reference's loop would do) writes per-row garbage fragments
        raise ValueError(
            f"{destination} has a single 2-D page — not a splittable "
            "z-stack (mips are move-only; rename without '_zstack')"
        )
    written = []
    folders = {}  # channel name → created output folder (loop-invariant)
    channel_file_name = input_file_end.replace(used_channels, "")
    for i, channel_name, plane in split_planes(zstack, channel_indices):
        channel_folder = folders.get(channel_name)
        if channel_folder is None:
            channel_folder = folders[channel_name] = create_channel_folder(
                destination, used_channels, channel_name
            )
        output_file = os.path.join(
            channel_folder, f"{channel_file_name}_z{i}_{channel_name}.tif"
        )
        write_tiff(output_file, plane)
        written.append(output_file)
    return written


def process_folder(top_level_folder: str, channel_indices: Sequence[int]) -> None:
    """One-level scan for _zstack.tif / _mip.tif / _mip.jpg (reference :73-89).

    One malformed capture must not abort the whole scan (earlier files are
    already renamed into their clean folders): failures are logged with the
    path and the scan continues.
    """
    failed = []
    for folder in sorted(os.listdir(top_level_folder)):
        folder_path = os.path.join(top_level_folder, folder)
        if not os.path.isdir(folder_path) or folder.startswith("."):
            continue
        for file in sorted(os.listdir(folder_path)):
            low = file.lower()
            if (
                low.endswith("_zstack.tif")
                or low.endswith("_mip.tif")
                or low.endswith("_mip.jpg")
            ):
                path = os.path.join(folder_path, file)
                try:
                    process_tif(path, channel_indices)
                except Exception as e:  # noqa: BLE001 — contain per file
                    failed.append(path)
                    _log.error("split failed for %s: %s: %s", path,
                              type(e).__name__, e)
    if failed:
        raise RuntimeError(
            f"{len(failed)} capture(s) failed to split (all others "
            f"completed): {failed}"
        )
