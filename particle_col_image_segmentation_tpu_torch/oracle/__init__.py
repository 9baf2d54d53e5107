"""CPU oracle: reference-semantics NumPy/SciPy implementations (the port's
own copies).

skimage is not a dependency, so ``ndimage`` reimplements the skimage
primitives the reference relies on (label, regionprops, disk,
binary_dilation, local_maxima, watershed) in NumPy/SciPy, and
``reference_pipeline`` is the reference-semantics analysis pipeline that
the port's analysis plane is held against, with the host helpers the port
calls.  The watershed's boundary IoU is scored against ``ndimage.watershed``.
"""

from particle_col_image_segmentation_tpu_torch.oracle import ndimage  # noqa: F401
from particle_col_image_segmentation_tpu_torch.oracle import reference_pipeline  # noqa: F401
