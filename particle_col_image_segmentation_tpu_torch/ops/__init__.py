"""Device ops of the fused segmentation pass: plain PyTorch versions, the
CUDA kernel wrappers (``*_cuda``) and the dispatch between them (``*_auto``)."""

from particle_col_image_segmentation_tpu_torch.ops.ccl import (  # noqa: F401
    compact_labels,
    compact_labels_auto,
    connected_components,
    connected_components_auto,
    label_image,
)
from particle_col_image_segmentation_tpu_torch.ops.ccl_tiles import (  # noqa: F401
    ccl_cuda,
    compact_labels_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.filters import (  # noqa: F401
    median_label_filter,
)
from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import (  # noqa: F401
    median_label_filter_auto,
    median_label_filter_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops import (  # noqa: F401
    region_counts,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (  # noqa: F401
    region_counts_auto,
    region_counts_cuda,
)
