"""Parity: the PyTorch port's label median (the plain version behind K1)
against the JAX package and scipy.

Inputs are made with numpy from a seed and handed to both packages.  Every
output is an integer plane, so the tolerance is exact equality.  The Pallas
kernel runs in interpret mode at the shapes ``test_ops_core.py`` uses.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import filters as jax_filters
from particle_col_image_segmentation_tpu.ops.filters_tiles import (
    median_label_filter_pallas,
)
from particle_col_image_segmentation_tpu_torch.ops.filters import median_label_filter
from particle_col_image_segmentation_tpu_torch.ops.filters_tiles import (
    median_label_filter_auto,
    median_label_filter_cuda,
)

from fixtures import random_class_plane, synthetic_label_plane


def _planes(shape, seed):
    if len(shape) == 2:
        return synthetic_label_plane(seed=seed, shape=shape)
    return np.stack([synthetic_label_plane(seed=seed + b, shape=shape[1:])
                     for b in range(shape[0])])


@pytest.mark.parametrize("shape", [(64, 128), (2, 64, 128)])
def test_median_matches_jax_and_pallas(shape):
    img = _planes(shape, seed=3)
    img[..., ::7, ::5] = 1  # salt, so the median has work everywhere
    got = median_label_filter(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(
        got, np.asarray(jax_filters.median_label_filter(jnp.asarray(img)))
    )
    np.testing.assert_array_equal(
        got,
        np.asarray(median_label_filter_pallas(jnp.asarray(img), tile=32, interpret=True)),
    )


@pytest.mark.parametrize("size", [3, 5, 7])
@pytest.mark.parametrize("shape", [(37, 53), (3, 4), (2, 9)])
def test_median_matches_scipy_odd_shapes(shape, size):
    """Reflected edges (scipy 'reflect': -1 → 0, -2 → 1), including planes
    narrower than the window's half-width."""
    img = random_class_plane(shape, n_classes=6, seed=sum(shape) + size) - 1
    got = median_label_filter(torch.from_numpy(img), size=size).numpy()
    np.testing.assert_array_equal(got, ndi.median_filter(img, size=size))


def test_values_past_num_classes_clamp_like_jax():
    """median = #{v < K-1 : count(window ≤ v) < 13}: values ≥ K-1 count as
    K-1 in both packages, where scipy keeps them."""
    rng = np.random.default_rng(17)
    img = rng.integers(0, 12, (40, 48)).astype(np.uint8)
    got = median_label_filter(torch.from_numpy(img), 5, 8).numpy()
    want = np.asarray(jax_filters.median_label_filter(jnp.asarray(img), 5, 8))
    np.testing.assert_array_equal(got, want)
    assert got.max() == 7
    assert not np.array_equal(got, ndi.median_filter(img, size=5))


def test_auto_takes_plain_on_cpu_and_wrapper_refuses_cpu():
    img = torch.from_numpy(random_class_plane((24, 40), n_classes=5, seed=4))
    before = median_label_filter_cuda.launches
    assert torch.equal(median_label_filter_auto(img), median_label_filter(img))
    assert median_label_filter_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        median_label_filter_cuda(img)


@pytest.mark.parametrize("size", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(3, 2, 5), (1, 7), (4, 1), (2, 3, 3)])
def test_median_narrower_than_the_halo_matches_jax_and_scipy(shape, size):
    """Planes narrower than size // 2 reflect periodically (scipy 'reflect')
    in the plain version K1 is judged by.  The JAX package agrees with
    scipy only where the plane is at least size // 2 wide and tall (its
    padding reflects once), so it is held to the port there alone."""
    img = np.random.default_rng(size).integers(0, 6, shape).astype(np.uint8)
    got = median_label_filter(torch.from_numpy(img), size, 8).numpy()
    if min(shape[-2:]) >= size // 2:
        np.testing.assert_array_equal(
            got, np.asarray(jax_filters.median_label_filter(jnp.asarray(img), size, 8)))
    planes = img.reshape((-1,) + img.shape[-2:])
    want = np.stack([ndi.median_filter(p, size=size, mode="reflect") for p in planes])
    np.testing.assert_array_equal(got, want.reshape(img.shape))
