import sys

from particle_col_image_segmentation_tpu_torch.cli import main

sys.exit(main())
