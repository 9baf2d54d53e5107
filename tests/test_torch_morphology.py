"""Parity: the PyTorch port's disk morphology, hole filling, boundary mask
and capped float distance (``ops.morphology``, ``ops.edt.edt``) against the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Masks
and flags are compared exactly; the float32 distances as bit patterns (both
packages take the correctly rounded float32 root of the same int32 d²).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.edt import edt as jax_edt
from particle_col_image_segmentation_tpu.ops import morphology as jax_morph
from particle_col_image_segmentation_tpu_torch.ops import (
    boundary_mask,
    close_disk,
    edt,
    erode_disk,
    fill_holes,
    fill_holes_fixpoint,
    open_disk,
)

from chip_smoke import serpentine

RADII = [0, 1, 2, 5, 20]


def _masks():
    """2-D and [3, H, W] masks: sparse and dense noise, discs, empty and
    full planes, odd shapes."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:61, :77]
    discs = np.zeros((61, 77), bool)
    for cy, cx, r in ((15, 20, 9), (40, 55, 14), (50, 10, 4)):
        discs |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    batch = np.stack([rng.random((45, 58)) < 0.5, np.zeros((45, 58), bool),
                      np.ones((45, 58), bool)])
    return {
        "discs 2-D": discs,
        "noise 2-D": rng.random((33, 50)) < 0.15,
        "batch dense/empty/full": batch,
        "odd [3,7,129]": rng.random((3, 7, 129)) < 0.6,
        "one row": rng.random((1, 40)) < 0.5,
    }


MASKS = _masks()


def _jax(fn, m, *args):
    return np.asarray(fn(jnp.asarray(m), *args))


def _port(fn, m, *args):
    return fn(torch.from_numpy(m), *args).numpy()


def test_boundary_mask_matches_jax():
    for name, m in MASKS.items():
        got = _port(boundary_mask, m)
        assert got.dtype == np.bool_ and got.shape == m.shape, name
        np.testing.assert_array_equal(got, _jax(jax_morph.boundary_mask, m), err_msg=name)
    # a uint8 mask reads nonzero as True
    m = (MASKS["discs 2-D"] * 3).astype(np.uint8)
    np.testing.assert_array_equal(_port(boundary_mask, m), _jax(jax_morph.boundary_mask, m))


@pytest.mark.parametrize("op", ["erode_disk", "open_disk", "close_disk"])
@pytest.mark.parametrize("radius", RADII)
def test_disk_morphology_matches_jax(op, radius):
    port_fn = {"erode_disk": erode_disk, "open_disk": open_disk, "close_disk": close_disk}[op]
    for name, m in MASKS.items():
        got = _port(port_fn, m, radius)
        assert got.dtype == np.bool_ and got.shape == m.shape, name
        np.testing.assert_array_equal(got, _jax(getattr(jax_morph, op), m, radius),
                                      err_msg=f"{op} r={radius} {name}")


def _fill_cases():
    nested = np.zeros((40, 40), bool)  # a ring in a hole in a ring
    nested[5:35, 5:35] = True
    nested[8:32, 8:32] = False
    nested[12:28, 12:28] = True
    nested[16:24, 16:24] = False
    border = np.zeros((30, 36), bool)  # background bays open to the border
    border[5:25, 4:30] = True
    border[10:20, 4:12] = False
    border[0:12, 20:24] = False
    border[14:18, 26:30] = False  # a closed hole beside them
    diag = np.ones((20, 20), bool)  # background joined to the border only diagonally
    diag[1:10, 1:10] = False
    for i in range(10):
        diag[i, i] = True
    diag[0, 0] = False
    batch = np.stack([nested[:30, :36], border, np.ones((30, 36), bool)])
    return {"nested": nested, "border bays": border, "diagonal": diag, "batch": batch}


@pytest.mark.parametrize("case", list(_fill_cases()))
def test_fill_holes_matches_jax(case):
    m = _fill_cases()[case]
    want, want_conv = jax_morph.fill_holes(jnp.asarray(m), with_flag=True)
    for fn in (fill_holes, fill_holes_fixpoint):
        got, conv = fn(torch.from_numpy(m), with_flag=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=case)
        assert conv.shape == () and bool(conv) == bool(want_conv) is True
        np.testing.assert_array_equal(fn(torch.from_numpy(m)).numpy(), np.asarray(want))
    if case == "diagonal":  # 4-connected background: the diagonal pocket is a hole
        assert np.asarray(want)[1:10, 1:10].all()


@pytest.mark.parametrize("max_iters", [1, 3, 6, 256])
def test_fill_holes_budget_and_flag_match_jax(max_iters):
    """Past a small budget the JAX flood wrongly fills the unreached part of
    the corridor and says so; the plain port does the same, flag included."""
    m = serpentine()
    want, want_conv = jax_morph.fill_holes(jnp.asarray(m), max_iters=max_iters, with_flag=True)
    got, conv = fill_holes(torch.from_numpy(m), max_iters=max_iters, with_flag=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(conv) == bool(want_conv)
    assert bool(want_conv) == (max_iters == 256)
    if max_iters == 256:  # the whole corridor is open to the border
        np.testing.assert_array_equal(got.numpy(), m)


@pytest.mark.parametrize("cap", [0, 2, 20])
def test_edt_matches_jax_bit_for_bit(cap):
    for name, m in MASKS.items():
        got = _port(edt, m, cap)
        want = _jax(jax_edt, m, cap)
        assert got.dtype == np.float32 and got.shape == m.shape, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
    ints = MASKS["noise 2-D"].astype(np.int32) * 7  # any nonzero is a feature
    np.testing.assert_array_equal(_port(edt, ints, cap).view(np.int32),
                                  _jax(jax_edt, ints != 0, cap).view(np.int32))
