"""Host I/O of the port: HDF5 codecs, dataset discovery and the
prefetching host-to-device loader."""
