"""CSV writers with the reference's exact output contract."""

from particle_col_image_segmentation_tpu_torch.report.csvio import (  # noqa: F401
    write_cell_position_info,
    write_density_info,
    write_merged_cell_position_info,
)
