"""Device ops of the port: plain PyTorch versions, the CUDA kernel wrappers
(``*_cuda``) and the dispatch between them (``*_auto``)."""

from particle_col_image_segmentation_tpu_torch.ops.blur_tiles import (  # noqa: F401
    MAX_HALF,
    gaussian_blur_cuda,
    gaussian_taps,
)
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
from particle_col_image_segmentation_tpu_torch.ops.edt import (  # noqa: F401
    edt,
    edt_exact,
    edt_sq,
    edt_sq_exact,
    sqrt_f32,
)
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import (  # noqa: F401
    edt_sq_auto,
    edt_sq_cuda,
    edt_sq_exact_auto,
    max_tile_cap,
)
from particle_col_image_segmentation_tpu_torch.ops.fill_tiles import (  # noqa: F401
    max_fused_cap,
    particle_fill_step,
    particle_fill_step_auto,
    particle_fill_step_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.filters import (  # noqa: F401
    blur_plain,
    gaussian_blur,
    median_label_filter,
    median_label_filter_padded,
    median_label_filter_rows_padded,
)
from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import (  # noqa: F401
    median_label_filter_auto,
    median_label_filter_cuda,
    median_label_filter_rows_padded_auto,
    median_label_filter_rows_padded_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.histogram_tiles import (  # noqa: F401
    bin_histogram,
    bin_histogram_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.maxima_tiles import (  # noqa: F401
    plateau_maxima_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.morphology import (  # noqa: F401
    boundary_mask,
    close_disk,
    dilate_disk,
    erode_disk,
    fill_holes,
    fill_holes_fixpoint,
    local_maxima,
    local_maxima_auto,
    open_disk,
)
from particle_col_image_segmentation_tpu_torch.ops.pairwise import (  # noqa: F401
    min_dist_to_set,
    nearest_neighbor_dists,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops import (  # noqa: F401
    HILO_BASE,
    CentroidTable,
    RegionTable,
    centroid_sums,
    centroids_f64,
    centroids_int,
    region_counts,
    region_props,
    region_sums,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (  # noqa: F401
    centroid_sums_auto,
    centroid_sums_cuda,
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
from particle_col_image_segmentation_tpu_torch.ops.threshold import (  # noqa: F401
    histogram,
    otsu_threshold,
    otsu_threshold_batch,
    threshold_and_count,
    threshold_and_count_batch,
)
from particle_col_image_segmentation_tpu_torch.ops.watershed import (  # noqa: F401
    watershed,
    watershed_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (  # noqa: F401
    watershed_cuda,
)
