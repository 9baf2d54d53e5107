"""Multi-device execution: the device mesh and its data axis.

Counterpart of ``particle_col_image_segmentation_tpu/parallel``.  Planes are
independent, so the data axis splits a batch of planes over the mesh's
devices and runs the whole single-device pipeline on each chunk, one worker
thread a device, with no communication between devices.  The spatial axis
(plane rows sharded across devices with halo exchange: the JAX package's
``parallel/halo.py`` and ``parallel/sharded.py``) is not ported.
"""

from particle_col_image_segmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPACE_AXIS,
    Mesh,
    make_mesh,
    run_per_device,
)
