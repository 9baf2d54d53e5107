"""Host I/O of the port: HDF5 and TIFF codecs (the native TIFF codec in
``io/native``), dataset discovery and raw-capture normalization, and the
prefetching host-to-device loader."""
