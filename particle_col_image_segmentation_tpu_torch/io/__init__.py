"""Host I/O of the port: HDF5 and TIFF codecs (the native TIFF codec in
``io/native``), dataset discovery and raw-capture normalization, and the
prefetching host-to-device loader.  The HDF5 reader imports h5py only when
it reads, so importing this package needs no h5py."""

from particle_col_image_segmentation_tpu_torch.io.hdf5 import load_h5_plane  # noqa: F401
from particle_col_image_segmentation_tpu_torch.io.discovery import (  # noqa: F401
    get_h5_files_recursively,
)
