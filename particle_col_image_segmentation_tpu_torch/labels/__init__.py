"""Per-plane region analytics of the port (``labels.analysis``) and the
class maps (``labels.classmaps``)."""

from particle_col_image_segmentation_tpu_torch.labels import classmaps  # noqa: F401
