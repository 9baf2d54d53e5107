"""Parity: the PyTorch port's region tables (the plain version behind K4)
against the JAX scatter path and the MXU Pallas kernel.

Inputs are made with numpy from a seed and handed to both packages; tables
are integers, so the tolerance is exact equality.  One known difference:
rows with ``area == 0`` hold class 0 in the port and in ``region_counts_mxu``
but INT32_MIN (segment_max's identity) on the JAX scatter path, so class
tables are compared against the scatter path only where ``area > 0``, and in
full against the MXU kernel (interpret mode, ``rows_per_chunk=8`` as in
``test_ops_core.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.regionprops import (
    region_counts as jax_region_counts,
)
from particle_col_image_segmentation_tpu.ops.regionprops_tiles import (
    region_counts_mxu,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_counts
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (
    region_counts_auto,
    region_counts_cuda,
)

I32_MAX, I32_MIN = 2**31 - 1, -(2**31)


def _case(lo_val, hi_val, seed):
    """Ids in [-3, R+9) — negative and past-capacity ids included — over a
    64×256 plane, values homogeneous per id (as every CCL component is)."""
    rng = np.random.default_rng(seed)
    R = 700
    seg = rng.integers(-3, R + 9, (64, 256)).astype(np.int32)
    cls_of = rng.integers(lo_val, hi_val, R + 16).astype(np.int32)
    img = cls_of[np.clip(seg, 0, None)]
    return seg, img, R - 1


@pytest.mark.parametrize("val_bound", [None, 7])
def test_region_counts_matches_jax_and_mxu(val_bound):
    if val_bound is None:  # signed values over the MXU path's full range
        seg, img, max_regions = _case(-16384, 16384, seed=5)
    else:
        seg, img, max_regions = _case(0, 8, seed=6)
    area, cls = region_counts(torch.from_numpy(seg), torch.from_numpy(img), max_regions)
    area, cls = area.numpy(), cls.numpy()
    assert area.shape == cls.shape == (max_regions + 1,)
    assert area.dtype == cls.dtype == np.int32
    a0, c0 = jax_region_counts(jnp.asarray(seg), jnp.asarray(img), max_regions)
    np.testing.assert_array_equal(area, np.asarray(a0))
    valid = area > 0
    np.testing.assert_array_equal(cls[valid], np.asarray(c0)[valid])
    a1, c1 = region_counts_mxu(
        jnp.asarray(seg), jnp.asarray(img), max_regions, rows_per_chunk=8,
        interpret=True, val_bound=val_bound,
    )
    np.testing.assert_array_equal(area, np.asarray(a1))
    np.testing.assert_array_equal(cls, np.asarray(c1))
    assert (cls[~valid] == 0).all()


def test_region_counts_batched_matches_mxu():
    seg, img, max_regions = _case(0, 8, seed=7)
    seg2, img2 = np.stack([seg, seg[::-1]]), np.stack([img, img[::-1] // 2])
    area, cls = region_counts(torch.from_numpy(seg2), torch.from_numpy(img2), max_regions)
    assert area.shape == (2, max_regions + 1)
    a1, c1 = region_counts_mxu(
        jnp.asarray(seg2), jnp.asarray(img2), max_regions, rows_per_chunk=8,
        interpret=True,
    )
    np.testing.assert_array_equal(area.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(c1))


def test_saturating_sum_matches_mxu():
    """One 320×512 region of 16383 sums to 5.4e9 and of -16384 to -5.4e9:
    both saturate to the int32 range before the division, as in the TPU
    kernel's _recombine_saturating."""
    seg = np.zeros((2, 320, 512), np.int32)
    seg[:, :, 500:] = 1
    img = np.full((2, 320, 512), 16383, np.int32)
    img[1] = -16384
    area, cls = region_counts(torch.from_numpy(seg), torch.from_numpy(img), 4)
    a1, c1 = region_counts_mxu(
        jnp.asarray(seg), jnp.asarray(img), 4, rows_per_chunk=64, interpret=True,
    )
    np.testing.assert_array_equal(area.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(c1))
    n0 = 320 * 500
    assert cls[0, 0] == I32_MAX // n0 and cls[1, 0] == I32_MIN // n0
    assert cls[0, 1] == 16383 and cls[1, 1] == -16384


def test_auto_takes_plain_on_cpu_and_wrapper_refuses_cpu():
    seg, img, max_regions = _case(0, 8, seed=8)
    seg_t, img_t = torch.from_numpy(seg), torch.from_numpy(img.astype(np.uint8))
    before = region_counts_cuda.launches
    got = region_counts_auto(seg_t, img_t, max_regions, val_bound=7)
    want = region_counts(seg_t, img_t, max_regions)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert region_counts_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        region_counts_cuda(seg_t, img_t, max_regions)
