"""Parity: the port's own copies of the oracle (``oracle/ndimage.py``) and
the parity metrics (``utils/metrics.py``) against the JAX package's.

Both are NumPy/SciPy code; each function gets the same seeded inputs in
both packages, and every result must be equal: arrays exactly, floats
bit for bit (tolerance 0).
"""

import numpy as np
import pytest
from scipy import ndimage as ndi

from particle_col_image_segmentation_tpu.oracle import ndimage as jax_ond
from particle_col_image_segmentation_tpu.utils import metrics as jax_metrics
from particle_col_image_segmentation_tpu_torch import oracle
from particle_col_image_segmentation_tpu_torch.oracle import ndimage as ond
from particle_col_image_segmentation_tpu_torch.utils import metrics

from fixtures import synthetic_label_plane


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_the_oracle_package_exports_its_copies():
    assert oracle.ndimage is ond
    assert sorted(ond.__all__) == sorted(jax_ond.__all__)
    for name in ond.__all__:
        assert getattr(ond, name).__module__ == ond.__name__, name


@pytest.mark.parametrize("radius", [0, 1, 2, 5, 20])
def test_disk(radius):
    _equal(ond.disk(radius), jax_ond.disk(radius))
    _equal(ond.disk(radius, bool), jax_ond.disk(radius, bool))


def _label_inputs():
    classes = synthetic_label_plane(seed=3, shape=(96, 128))  # few values: scipy per value
    rng = np.random.default_rng(4)
    dsq = np.round(ndi.distance_transform_edt(rng.random((64, 80)) < 0.9) ** 2)  # > 16 values
    noise = rng.integers(0, 3, (40, 50))
    return {"classes": classes, "edt2": dsq, "noise": noise}


@pytest.mark.parametrize("background", [0, 1, -1])
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", ["classes", "edt2", "noise"])
def test_label(case, connectivity, background):
    img = _label_inputs()[case]
    got, n = ond.label(img, background=background, connectivity=connectivity, return_num=True)
    want, wn = jax_ond.label(img, background=background, connectivity=connectivity,
                             return_num=True)
    _equal(got, want)
    assert n == wn and n > 1


@pytest.mark.parametrize("case", ["classes", "noise"])
def test_regionprops(case):
    lab = ond.label(_label_inputs()[case])
    lab[lab == 3] = 0  # an absent id, which both skip
    got, want = ond.regionprops(lab), jax_ond.regionprops(lab)
    assert len(got) == len(want) > 1 and isinstance(got[0], ond.Region)
    for g, w in zip(got, want):
        assert (g.label, g.area, g.centroid, g.bbox) == (w.label, w.area, w.centroid, w.bbox)
        assert g["area"] == w["area"] and repr(g) == repr(w)
        _equal(g.coords, w.coords)
    assert ond.regionprops(np.zeros((4, 4), np.int64)) == []


@pytest.mark.parametrize("radius", [1, 3])
def test_binary_dilation_and_erosion(radius):
    m = np.random.default_rng(5).random((70, 90)) < 0.2
    fp = ond.disk(radius)
    _equal(ond.binary_dilation(m, fp), jax_ond.binary_dilation(m, fp))
    _equal(ond.binary_erosion(~m, fp), jax_ond.binary_erosion(~m, fp))


@pytest.mark.parametrize("connectivity", [1, 2])
def test_local_maxima(connectivity):
    m = ond.binary_dilation(np.random.default_rng(6).random((96, 96)) < 0.02, ond.disk(4))
    d = ndi.distance_transform_edt(m)
    _equal(ond.local_maxima(d, connectivity), jax_ond.local_maxima(d, connectivity))
    flat = np.zeros((8, 8))
    _equal(ond.local_maxima(flat, connectivity), jax_ond.local_maxima(flat, connectivity))


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_watershed(masked, connectivity):
    rng = np.random.default_rng(7)
    img = np.round(rng.random((64, 72)) * 7) / 7  # plateaus: the FIFO ties decide
    mk = np.zeros((64, 72), np.int64)
    for i, (y, x) in enumerate(rng.integers(0, 64, (12, 2))):
        mk[y, x] = i + 1
    mask = (rng.random((64, 72)) < 0.85) if masked else None
    got = ond.watershed(img, mk, mask=mask, connectivity=connectivity)
    _equal(got, jax_ond.watershed(img, mk, mask=mask, connectivity=connectivity))
    assert len(np.unique(got)) > 10


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.5])
def test_imgaussfilt(sigma):
    img = np.random.default_rng(8).random((50, 61)) * 4096
    _equal(ond.imgaussfilt(img, sigma), jax_ond.imgaussfilt(img, sigma))


def test_bwboundaries_pixels():
    m = ond.binary_dilation(np.random.default_rng(9).random((60, 60)) < 0.01, ond.disk(6))
    m[0, :10] = True  # touching the border
    _equal(ond.bwboundaries_pixels(m), jax_ond.bwboundaries_pixels(m))


def _labelings():
    a = ond.label(synthetic_label_plane(seed=1, shape=(80, 96)))
    b = np.roll(a, 1, axis=1)
    return a, b


def test_label_boundaries_and_masks_equal():
    a, b = _labelings()
    _equal(metrics.label_boundaries(a), jax_metrics.label_boundaries(a))
    assert metrics.masks_equal(a, a) is jax_metrics.masks_equal(a, a) is True
    assert metrics.masks_equal(a, b) is jax_metrics.masks_equal(a, b) is False


@pytest.mark.parametrize("tolerance_px", [0, 1, 2])
def test_boundary_iou(tolerance_px):
    a, b = _labelings()
    got = metrics.boundary_iou(a, b, tolerance_px)
    assert got == jax_metrics.boundary_iou(a, b, tolerance_px) and 0 < got < 1
    flat = np.zeros((5, 5), np.int32)
    assert metrics.boundary_iou(flat, flat, tolerance_px) == 1.0
