"""Parity: the PyTorch port's watershed and local maxima (the plain versions
behind K10/K11 and K2's plateau use) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  Labels,
maxima and ``converged`` flags are integers or booleans, so the tolerance is
exact equality.  The JAX side runs its XLA fixpoints and, kept small because
interpret mode is slow, its Pallas band sweeps in interpret mode
(``watershed_sweeps(tile=32)``, ``_local_maxima_sweeps``).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import scans as jax_scans
from particle_col_image_segmentation_tpu.ops.morphology import (
    _local_maxima_sweeps,
    local_maxima as jax_local_maxima,
)
from particle_col_image_segmentation_tpu.ops.watershed import watershed as jax_watershed
from particle_col_image_segmentation_tpu.ops.watershed_tiles import watershed_sweeps
from particle_col_image_segmentation_tpu.oracle import ndimage as ond
from particle_col_image_segmentation_tpu_torch.ops.morphology import (
    local_maxima,
    local_maxima_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.scans import seg_or_scan_bidi
from particle_col_image_segmentation_tpu_torch.ops.watershed import watershed, watershed_auto
from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import watershed_cuda


def bench_relief(n: int = 128, pairs: int = 30, seed: int = 0, margin: int = 40,
                 r2_range=(150, 400)) -> np.ndarray:
    """The bench's touching-cell relief (``bench.py`` config #3): ``pairs``
    touching disc pairs with centres in [margin, n−margin), r² in
    ``r2_range``, and prob = 1 − edt/max.  The defaults are the bench's."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), bool)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(pairs):
        cy, cx = rng.integers(margin, n - margin, 2)
        r2 = int(rng.integers(*r2_range))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        m |= (yy - cy) ** 2 + (xx - cx - int(1.5 * np.sqrt(r2))) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def quantize16(prob: np.ndarray) -> np.ndarray:
    """The bench's 16-level quantization of a relief."""
    return (np.round(prob * 15.0) / 15.0).astype(np.float32)


def markers_of(prob: np.ndarray):
    """(markers int32, mask bool) as refine seeds them: labelled local maxima
    of the EDT of the object mask prob < 0.5."""
    mask = prob < 0.5
    mk = ond.label(ond.local_maxima(ndi.distance_transform_edt(mask)).astype(np.uint8))
    return np.asarray(mk).astype(np.int32), mask


def _both(img, mk, mask, **kw):
    got, gconv = watershed(
        torch.from_numpy(img), torch.from_numpy(mk),
        None if mask is None else torch.from_numpy(mask), with_flag=True, **kw,
    )
    want, wconv = jax_watershed(
        jnp.asarray(img), jnp.asarray(mk), None if mask is None else jnp.asarray(mask),
        with_flag=True, **kw,
    )
    return got.numpy(), gconv.numpy(), np.asarray(want), np.asarray(wconv)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("relief", ["smooth", "q16"])
def test_watershed_matches_jax_xla_and_sweeps(relief, connectivity):
    prob = bench_relief()
    mk, mask = markers_of(prob)
    img = prob if relief == "smooth" else quantize16(prob)
    got, gconv, want, wconv = _both(img, mk, mask, connectivity=connectivity)
    assert got.dtype == np.int32 and bool(gconv) and bool(wconv)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[mask])) == mk.max() >= 2  # every seed floods
    sweeps, sconv = watershed_sweeps(
        jnp.asarray(img), jnp.asarray(mk), jnp.asarray(mask),
        connectivity=connectivity, tile=32, interpret=True, with_flag=True,
    )
    assert bool(sconv)
    np.testing.assert_array_equal(got, np.asarray(sweeps))


def test_watershed_unreachable_mask_and_seeds_outside_it():
    rng = np.random.default_rng(3)
    img = rng.random((48, 80)).astype(np.float32)
    mask = np.ones((48, 80), bool)
    mask[:, 38:42] = False  # a wall: the right half has one seed of its own
    mask[20:28, 60:70] = False
    mask[22:26, 63:67] = True  # an island no seed reaches
    mk = np.zeros((48, 80), np.int32)
    mk[5, 5], mk[40, 30], mk[10, 75] = 1, 2, 3
    mk[0, 40] = 4  # a seed outside the mask floods nothing
    for connectivity in (1, 2):
        got, gconv, want, wconv = _both(img, mk, mask, connectivity=connectivity)
        assert bool(gconv) and bool(wconv)
        np.testing.assert_array_equal(got, want)
        assert (got[~mask] == 0).all() and (got[22:26, 63:67] == 0).all()
        assert 4 not in got and set(np.unique(got[mask])) >= {1, 2, 3}


def test_watershed_batched_planes_match_jax_and_single_planes():
    rng = np.random.default_rng(7)
    img = rng.random((3, 64, 128)).astype(np.float32)
    img[1, -12:, :] = 0.01  # a low corridor along a plane's bottom edge
    mk = np.zeros((3, 64, 128), np.int32)
    mask = np.ones((3, 64, 128), bool)
    mask[2, :4, :] = False
    for b in range(3):
        mk[b, 8, 8 + 11 * b] = 1 + b
        mk[b, 55, 100 - 9 * b] = 4 + b
    got, gconv, want, wconv = _both(img, mk, mask, connectivity=1)
    assert gconv.shape == (3,) and gconv.all() and wconv.all()
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        one = watershed(torch.from_numpy(img[b]), torch.from_numpy(mk[b]),
                        torch.from_numpy(mask[b]))
        np.testing.assert_array_equal(got[b], one.numpy())


def test_watershed_budget_runs_out_like_jax():
    prob = bench_relief()
    mk, mask = markers_of(prob)
    img = np.stack([prob, quantize16(prob)])
    mks, masks = np.stack([mk, mk]), np.stack([mask, mask])
    got, gconv, want, wconv = _both(img, mks, masks, max_iters=2)
    assert not gconv.any() and not wconv.any()
    np.testing.assert_array_equal(got, want)  # the same two Jacobi steps


def test_watershed_tunnel_basins_is_not_ported():
    x = torch.zeros((8, 8))
    mk = torch.zeros((8, 8), dtype=torch.int32)
    for fn in (watershed, watershed_auto):
        with pytest.raises(NotImplementedError, match="tunnel_basins"):
            fn(x, mk, tunnel_basins=True)


def test_watershed_auto_takes_the_plain_path_on_cpu_and_the_kernel_refuses_it():
    prob = bench_relief()
    mk, mask = markers_of(prob)
    args = (torch.from_numpy(prob), torch.from_numpy(mk), torch.from_numpy(mask))
    np.testing.assert_array_equal(watershed_auto(*args).numpy(), watershed(*args).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        watershed_cuda(*args)


def _plateau_dsq(seed: int, shape=(128, 128)):
    """An EDT² image with large plateaus: dilated sparse seeds."""
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < 0.03
    m = ond.binary_dilation(m, ond.disk(5))
    dsq = np.round(ndi.distance_transform_edt(m) ** 2).astype(np.int32)
    dsq[:20, :30] = 7  # one wide plateau, and the zero plateau around the cells
    return dsq


@pytest.mark.parametrize("connectivity", [1, 2])
def test_local_maxima_matches_jax_flood_and_sweeps(connectivity):
    dsq = np.stack([_plateau_dsq(0), _plateau_dsq(1)])
    got, gconv = local_maxima(torch.from_numpy(dsq), connectivity, with_flag=True)
    want, wconv = jax_local_maxima(jnp.asarray(dsq), connectivity, with_flag=True)
    assert gconv.all() and np.asarray(wconv).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sweeps, sconv = _local_maxima_sweeps(
        jnp.asarray(dsq), connectivity, True, tile=32, max_sweeps=16, interpret=True,
    )
    assert np.asarray(sconv).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(sweeps))
    auto = local_maxima_auto(torch.from_numpy(dsq), connectivity)
    np.testing.assert_array_equal(auto.numpy(), got.numpy())
    for b in range(2):
        np.testing.assert_array_equal(
            got.numpy()[b], ond.local_maxima(dsq[b].astype(np.float64), connectivity=connectivity)
        )


def test_local_maxima_budget_flag_matches_jax():
    dsq = _plateau_dsq(2)
    got, gconv = local_maxima(torch.from_numpy(dsq), 2, max_iters=1, with_flag=True)
    want, wconv = jax_local_maxima(jnp.asarray(dsq), 2, max_iters=1, with_flag=True)
    assert bool(gconv) == bool(wconv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [-1, -2])
def test_seg_or_scan_bidi_matches_jax(axis):
    rng = np.random.default_rng(4)
    vals = rng.random((3, 17, 23)) < 0.1
    same = rng.random((3, 17, 23)) < 0.7
    if axis == -1:
        same[..., 0] = False
    else:
        same[..., 0, :] = False
    got = seg_or_scan_bidi(torch.from_numpy(vals), torch.from_numpy(same), axis)
    want = jax_scans.seg_or_scan_bidi(jnp.asarray(vals), jnp.asarray(same), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
