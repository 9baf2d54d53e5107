"""End-to-end pipelines of the port."""

from particle_col_image_segmentation_tpu_torch.models.single_channel import (  # noqa: F401
    PlaneAnalysis,
    analyze_plane,
)
from particle_col_image_segmentation_tpu_torch.models.zstack import (  # noqa: F401
    ZStackStats,
    zstack_stats_device,
)
