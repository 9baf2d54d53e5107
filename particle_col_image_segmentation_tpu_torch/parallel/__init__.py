"""Multi-device execution: the device mesh, its data axis and its space axis.

Counterpart of ``particle_col_image_segmentation_tpu/parallel``.  Planes are
independent, so the data axis splits a batch of planes over the mesh's
devices and runs the whole single-device pipeline on each chunk, one worker
thread a device, with no communication between devices.  The space axis
splits each plane's rows into bands, one a device: windowed steps read halo
rows copied from the neighbouring bands (``halo``), and the CCL's bands are
joined on the host (``sharded``).  ``initialize_multihost`` joins the
processes of a multi-process run (``torch.distributed``, gloo) into one
global mesh, a data row a process; ``process_allgather`` gathers the
outputs the band-sharded functions return for each process's rows.
"""

from particle_col_image_segmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPACE_AXIS,
    Mesh,
    initialize_multihost,
    make_mesh,
    process_allgather,
    run_per_device,
)
from particle_col_image_segmentation_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_segment_batch,
)
