"""Host-side TIFF codecs of the port (the JAX package's ``io/tiff.py``).

tifffile is not available; the port's own native C++ codec (``io/native``)
reads uncompressed, LZW and deflate grayscale TIFFs and writes single
planes, and PIL handles everything else, as in the reference's reads and
writes (split_zstack.py:50-51,64-65).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def read_tiff_stack(path: str) -> np.ndarray:
    """Read all pages → [N, H, W] (or [H, W] for single-page).

    Uses the native C++ codec (io/native) for the grayscale TIFFs it
    supports; PIL reads the ones it reports as 0 pages.
    """
    from particle_col_image_segmentation_tpu_torch.io import native

    arr = native.read_tiff(path)
    if arr is not None:
        return arr
    from PIL import Image

    frames = []
    with Image.open(path) as img:
        i = 0
        while True:
            try:
                img.seek(i)
            except EOFError:
                break
            frames.append(np.asarray(img))
            i += 1
    if len(frames) == 1:
        return frames[0]
    return np.stack(frames)


def read_imagej_channels(path: str) -> Optional[int]:
    """Channel count from ImageJ hyperstack metadata (ImageDescription tag
    270, ``channels=N``), or None when absent.  This is how tifffile knows
    the true [Z, C, H, W] structure the reference iterates — page counts
    alone cannot distinguish Z·C groupings."""
    import re

    from PIL import Image

    try:
        with Image.open(path) as img:
            desc = img.tag_v2.get(270, "") if hasattr(img, "tag_v2") else ""
    except Exception:
        return None
    m = re.search(r"channels=(\d+)", str(desc))
    return int(m.group(1)) if m else None


def read_zstack(path: str, num_channels: Optional[int] = None) -> np.ndarray:
    """Read a z-stack; with ``num_channels`` reshape pages [Z*C,H,W] →
    [Z, C, H, W] (the layout split_zstack iterates, reference :52-58).

    The TIFF's own ImageJ ``channels=`` metadata takes precedence over the
    caller's ``num_channels`` hint: grouping pages by a wrong guess would
    mix different z planes into fake channels."""
    arr = read_tiff_stack(path)
    meta_ch = read_imagej_channels(path)
    if meta_ch is not None:
        num_channels = meta_ch
    if num_channels is not None and arr.ndim == 3:
        z, rem = divmod(arr.shape[0], num_channels)
        if rem or z == 0:
            # silently dropping the remainder pages (or the whole stack
            # when pages < channels) is data loss with no diagnostic
            raise ValueError(
                f"{path}: {arr.shape[0]} pages do not group into "
                f"{num_channels} channels"
            )
        arr = arr.reshape(z, num_channels, *arr.shape[1:])
    return arr


def write_tiff(path: str, arr: np.ndarray) -> None:
    """Write one plane (or a stack of planes) as TIFF."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype in (np.dtype(np.uint8), np.dtype(np.uint16)):
        from particle_col_image_segmentation_tpu_torch.io import native

        if native.write_tiff(path, arr):
            return
    from PIL import Image
    if arr.ndim == 2:
        Image.fromarray(arr).save(path)
    else:
        pages = [Image.fromarray(p) for p in arr]
        pages[0].save(path, save_all=True, append_images=pages[1:])
