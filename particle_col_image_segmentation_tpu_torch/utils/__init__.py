"""Tracing helpers, logging and the run manifest of the port."""

from particle_col_image_segmentation_tpu_torch.utils.logging import get_logger  # noqa: F401
from particle_col_image_segmentation_tpu_torch.utils.manifest import RunManifest  # noqa: F401
from particle_col_image_segmentation_tpu_torch.utils.profiling import stage  # noqa: F401
