"""Parity figures (matplotlib, imported only when figures are drawn).

Unlike the JAX package's ``viz``, this package re-exports nothing: the
figures import matplotlib at module level, and the card's machine has no
matplotlib, so ``import particle_col_image_segmentation_tpu_torch.viz``
must not pull it in."""
