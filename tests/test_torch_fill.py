"""Parity: the PyTorch port's capped EDT, disk dilation and particle-fill
step (the plain versions behind K9 and K8) against the JAX package's XLA
transforms, its Pallas kernels (interpret mode, as ``test_ops_morphology.py``
runs them) and the NumPy oracle.

Inputs are made with numpy from a seed and handed to both packages; every
output is an integer or a mask, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.edt import edt_sq as jax_edt_sq
from particle_col_image_segmentation_tpu.ops.edt_tiles import edt_sq_pallas
from particle_col_image_segmentation_tpu.ops.fill_tiles import (
    particle_fill_step_auto as jax_fill_auto,
    particle_fill_step_pallas,
)
from particle_col_image_segmentation_tpu.ops.morphology import (
    dilate_disk as jax_dilate_disk,
)
from particle_col_image_segmentation_tpu.oracle import ndimage as ond
from particle_col_image_segmentation_tpu_torch.ops.edt import edt_sq
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_auto, edt_sq_cuda
from particle_col_image_segmentation_tpu_torch.ops.fill_tiles import (
    particle_fill_step,
    particle_fill_step_auto,
    particle_fill_step_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.morphology import dilate_disk

from fixtures import synthetic_label_plane

CAPS = [0, 1, 2, 5, 8, 9, 20, 32]


def _mask(shape, density, seed):
    return np.random.default_rng(seed).random(shape) < density


@pytest.mark.parametrize("cap", CAPS)
def test_edt_sq_matches_jax_xla_and_pallas(cap):
    """Both phase-1 branches (direct taps for cap ≤ 8, doubling above), on a
    batch whose planes are sparse, empty and full."""
    m = _mask((3, 64, 72), 0.02, seed=cap)
    m[1] = False
    m[2, :, :5] = True
    got = edt_sq(torch.from_numpy(m), cap).numpy()
    assert got.dtype == np.int32 and got.shape == m.shape
    np.testing.assert_array_equal(got, np.asarray(jax_edt_sq(jnp.asarray(m), cap)))
    pallas = edt_sq_pallas(jnp.asarray(m), cap=cap, tile=16, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    assert (got[1] == (cap + 1) ** 2).all()


@pytest.mark.parametrize("shape,cap", [((5, 7), 20), ((1, 1), 3), ((97, 130), 9), ((2, 33, 1), 4)])
def test_edt_sq_odd_shapes_and_cap_past_the_plane(shape, cap):
    m = _mask(shape, 0.05, seed=len(shape) + cap)
    got = edt_sq(torch.from_numpy(m), cap).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_edt_sq(jnp.asarray(m), cap)))


def test_edt_sq_is_the_exact_distance_up_to_the_cap():
    from scipy import ndimage as ndi

    m = _mask((80, 90), 0.01, seed=3)
    got = edt_sq(torch.from_numpy(m), 12).numpy()
    exact = np.rint(ndi.distance_transform_edt(~m) ** 2).astype(np.int64)
    near = exact <= 144
    np.testing.assert_array_equal(got[near], exact[near])
    assert ((got[~near] > 144) & (got[~near] <= 169)).all()


@pytest.mark.parametrize("radius", [1, 2, 5])
def test_dilate_disk_matches_jax_and_oracle(radius):
    m = _mask((2, 64, 96), 0.01, seed=radius)
    got = dilate_disk(torch.from_numpy(m), radius).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, np.asarray(jax_dilate_disk(jnp.asarray(m), radius)))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], ond.binary_dilation(m[b], ond.disk(radius))
        )


@pytest.mark.parametrize("seed,cap,dt2,dr2", [(11, 20, 4, 400), (12, 20, 4, 400), (13, 5, 9, 4)])
def test_particle_fill_step_matches_pallas_and_jax(seed, cap, dt2, dr2):
    img = np.stack([
        synthetic_label_plane(seed=seed, shape=(64, 128)),
        synthetic_label_plane(seed=seed + 50, shape=(64, 128)),
    ]).astype(np.uint8)
    got, cnt = particle_fill_step(torch.from_numpy(img), 2, 1, cap, dt2, dr2)
    assert got.dtype == torch.uint8 and cnt.dtype == torch.int32 and cnt.shape == (2,)
    want, wcnt = particle_fill_step_pallas(
        jnp.asarray(img), 2, 1, cap, dt2, dr2, tile=8, interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    auto, acnt = jax_fill_auto(jnp.asarray(img[0]), 2, 1, cap, dt2, dr2)
    g0, c0 = particle_fill_step(torch.from_numpy(img[0]), 2, 1, cap, dt2, dr2)
    assert c0.shape == () and int(c0) == int(acnt) == int(cnt[0]) > 0
    np.testing.assert_array_equal(g0.numpy(), np.asarray(auto))


def test_particle_fill_step_without_particles_changes_nothing():
    img = synthetic_label_plane(seed=4, shape=(48, 64)).astype(np.uint8)
    img[img == 2] = 3
    got, cnt = particle_fill_step(torch.from_numpy(img), 2, 1, 20, 4, 400)
    assert int(cnt) == 0
    np.testing.assert_array_equal(got.numpy(), img)


def test_auto_takes_plain_on_cpu_and_wrappers_refuse_cpu():
    m = torch.from_numpy(_mask((32, 40), 0.05, seed=1))
    img = torch.from_numpy(synthetic_label_plane(seed=2, shape=(32, 40)).astype(np.uint8))
    before = (edt_sq_cuda.launches, particle_fill_step_cuda.launches)
    assert torch.equal(edt_sq_auto(m, 3), edt_sq(m, 3))
    got = particle_fill_step_auto(img, 2, 1, 20, 4, 400)
    want = particle_fill_step(img, 2, 1, 20, 4, 400)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (edt_sq_cuda.launches, particle_fill_step_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        edt_sq_cuda(m, 3)
    with pytest.raises(ValueError, match="CUDA"):
        particle_fill_step_cuda(img, 2, 1, 20, 4, 400)
    with pytest.raises(ValueError, match="cap"):
        edt_sq(m, -1)


def _tile_edge_planes(cap):
    """[3, 128, 256] planes of cells (1) with particle pixels (2) at exactly
    ``cap`` (plane 0) and ``cap + 1`` (plane 1) px from the 64-row and the
    128-column tile boundaries, on either side; plane 2 has no particle."""
    x = np.ones((3, 128, 256), np.uint8)
    for b, at in ((0, cap), (1, cap + 1)):
        x[b, 63 + at, 10] = x[b, 64 - at, 200] = 2  # below / above the row boundary
        x[b, 100, 127 + at] = x[b, 20, 128 - at] = 2  # right / left of the column boundary
    return x


@pytest.mark.parametrize("cap,dt2,dr2", [
    (20, 4, 400), (20, 0, 440), (20, 442, -1), (2, 10, 0), (5, 9, 4), (1, 1, 0),
])
def test_fill_step_at_tile_edges_and_past_the_cap_matches_pallas_and_jax(cap, dt2, dr2):
    """Particles at cap and cap + 1 across a tile boundary, and dt2 >
    (cap + 1)² (every cell pixel fills, particles or none: the clamped d² is
    at most (cap + 1)²), against the Pallas kernel in interpret mode and the
    JAX dispatch."""
    img = _tile_edge_planes(cap)
    got, cnt = particle_fill_step(torch.from_numpy(img), 2, 1, cap, dt2, dr2)
    want, wcnt = particle_fill_step_pallas(
        jnp.asarray(img), 2, 1, cap, dt2, dr2, tile=32, interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    auto, acnt = jax_fill_auto(jnp.asarray(img), 2, 1, cap, dt2, dr2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(auto))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(acnt))
    if dt2 > (cap + 1) ** 2:
        np.testing.assert_array_equal(cnt.numpy(), (img == 1).sum(axis=(1, 2)))
    else:
        assert int(cnt[2]) == 0  # no particle, nothing within reach
