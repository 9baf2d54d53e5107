"""Device ops of the port: plain PyTorch versions, the CUDA kernel wrappers
(``*_cuda``) and the dispatch between them (``*_auto``)."""

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
from particle_col_image_segmentation_tpu_torch.ops.edt import edt_sq  # noqa: F401
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import (  # noqa: F401
    edt_sq_auto,
    edt_sq_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.fill_tiles import (  # noqa: F401
    particle_fill_step,
    particle_fill_step_auto,
    particle_fill_step_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.filters import (  # noqa: F401
    median_label_filter,
)
from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import (  # noqa: F401
    median_label_filter_auto,
    median_label_filter_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.morphology import dilate_disk  # noqa: F401
from particle_col_image_segmentation_tpu_torch.ops.regionprops import (  # noqa: F401
    HILO_BASE,
    RegionTable,
    centroids_f64,
    centroids_int,
    region_counts,
    region_props,
    region_sums,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (  # noqa: F401
    region_counts_auto,
    region_counts_cuda,
    region_props_auto,
    region_sums_auto,
    region_sums_cuda,
    region_table_cuda,
    table_lookup,
    table_lookup_auto,
    table_lookup_cuda,
)
