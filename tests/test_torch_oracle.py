"""Parity: the port's own copies of the oracle (``oracle/ndimage.py``) and
the parity metrics (``utils/metrics.py``) against the JAX package's.

Both are NumPy/SciPy code; each function gets the same seeded inputs in
both packages, and every result must be equal: arrays exactly, floats
bit for bit (tolerance 0).
"""

import inspect

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


# ---- the reference pipeline (oracle/reference_pipeline.py) -----------------

from particle_col_image_segmentation_tpu.config import AnalysisConfig as JaxConfig  # noqa: E402
from particle_col_image_segmentation_tpu.config import BASE_TYPE_MAP  # noqa: E402
from particle_col_image_segmentation_tpu.oracle import reference_pipeline as jax_rp  # noqa: E402
from particle_col_image_segmentation_tpu_torch.config import config_from_fields  # noqa: E402
from particle_col_image_segmentation_tpu_torch.oracle import parity  # noqa: E402
from particle_col_image_segmentation_tpu_torch.oracle import reference_pipeline as rp  # noqa: E402

SINGLE = {1: "3D05", 2: "Particle", 3: "Background"}
TWO = {1: "3D05", 2: "C3M10", 3: "Particle", 4: "Background"}
RP_FUNCTIONS = ("denoise", "get_type", "get_cell_positions_and_areas",
                "get_cell_clusters_from_distances", "get_merged_regions", "fill_particle_area",
                "recreate_particle_area", "combine_cell_positions_and_clusters",
                "get_rfp_base_arr", "combine_channels")


def _configs(strict: bool):
    jcfg = JaxConfig(max_regions=4096, strict_reference_errors=strict)
    return jcfg, config_from_fields(jcfg)


def _rp_planes():
    """(name, plane, cell types): one strain, two strains, and a strain whose
    regions are all clusters (no singles: the mean single area is NaN)."""
    return {
        "1strain": (synthetic_label_plane(seed=0, cell_types=SINGLE, shape=(160, 160)), SINGLE),
        "2strain": (synthetic_label_plane(seed=3, cell_types=TWO, shape=(160, 160)), TWO),
        "clusters_only": (synthetic_label_plane(seed=5, cell_types=SINGLE, shape=(160, 160),
                                                n_cells_per_strain=0), SINGLE),
    }


def _same_region_dicts(got, want, cells: bool = True):
    assert list(got) == list(want)
    for k in want:
        parity.assert_regions_equal(got[k], want[k], k)
        assert [r.label for r in got[k]] == [r.label for r in want[k]]
        if cells:
            assert [getattr(r, "cells", None) for r in got[k]] == [
                getattr(r, "cells", None) for r in want[k]]


def _same_groups(got, want):
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k])
        for ga, gb in zip(got[k], want[k]):
            assert ga["area"] == gb["area"] and ga["bbox"] == gb["bbox"]
            assert ga["centroid"].tolist() == gb["centroid"].tolist()  # bit for bit
            parity.assert_regions_equal(ga["regions"], gb["regions"])


def test_the_reference_pipeline_holds_every_jax_function():
    for name in RP_FUNCTIONS + ("normalize_ds_arr", "get_cell_counts_and_densities"):
        f, jf = getattr(rp, name), getattr(jax_rp, name)
        assert f.__module__ == rp.__name__, name
        assert list(inspect.signature(f).parameters) == list(inspect.signature(jf).parameters)


@pytest.mark.parametrize("strict", [False, True], ids=["fixed", "strict"])
@pytest.mark.parametrize("case", list(_rp_planes()))
def test_positions_clusters_and_merges_equal_jax(case, strict):
    img, ct = _rp_planes()[case]
    jcfg, tcfg = _configs(strict)
    den = rp.denoise(img, tcfg)
    _equal(den, jax_rp.denoise(img, jcfg))
    regions = ond.regionprops(ond.label(den))
    assert [rp.get_type(r, den) for r in regions] == [jax_rp.get_type(r, den) for r in regions]
    if case == "clusters_only" and strict:  # the reference's int(area // nan)
        with pytest.raises(ValueError, match="NaN") as got:
            rp.get_cell_positions_and_areas(den, ct, True, tcfg)
        with pytest.raises(ValueError) as want:
            jax_rp.get_cell_positions_and_areas(den, ct, True, jcfg)
        assert str(got.value) == str(want.value)
        return
    for merged in (False, True):
        got = rp.get_cell_positions_and_areas(den, ct, merged, tcfg)
        want = jax_rp.get_cell_positions_and_areas(den, ct, merged, jcfg)
        _same_region_dicts(got[0], want[0], cells=False)
        _same_region_dicts(got[1], want[1])
        assert got[2] == want[2] and got[2] > 0
        _same_groups(got[3], want[3])
    pos, clusters = got[0], got[1]
    if case == "clusters_only":
        assert not pos["3D05"] and clusters["3D05"]
        assert all(c.cells == 0 for c in clusters["3D05"])
    # the merge on its own: CELL_TYPES order whatever the dicts' order, and
    # the merged images
    shuffled_pos = dict(reversed(list(pos.items())))
    m_got, img_got = rp.get_cell_clusters_from_distances(den, shuffled_pos, clusters, ct, tcfg)
    m_want, img_want = jax_rp.get_cell_clusters_from_distances(den, shuffled_pos, clusters, ct,
                                                               jcfg)
    _same_groups(m_got, m_want)
    assert list(m_got) == [k for k in ("3D05", "6B07", "C3M10") if k in pos] + ["combined"]
    assert list(img_got) == list(img_want)
    for k in img_want:
        _equal(img_got[k], img_want[k])
    strain = next(k for k in pos if pos[k] or clusters[k])
    regions = pos[strain] + clusters[strain]
    val = next(v for v, n in ct.items() if n == strain)
    g, gi = rp.get_merged_regions(den == val, regions, tcfg)
    w, wi = jax_rp.get_merged_regions(den == val, regions, jcfg)
    _same_groups({"x": g}, {"x": w})
    _equal(gi, wi)
    cnt = rp.get_cell_counts_and_densities(pos, clusters, got[2], tcfg)
    assert cnt == jax_rp.get_cell_counts_and_densities(pos, clusters, got[2], jcfg)


@pytest.mark.parametrize("case", ["1strain", "2strain"])
def test_fill_and_recreate_particle_area_equal_jax(case):
    img, ct = _rp_planes()[case]
    jcfg, tcfg = _configs(False)
    den = rp.denoise(img, tcfg)
    particle = next(v for v, n in ct.items() if n == "Particle")
    for cell in (v for v, n in ct.items() if n in ("3D05", "C3M10")):
        got = rp.fill_particle_area(den, particle, cell, particle, tcfg)
        want = jax_rp.fill_particle_area(den, particle, cell, particle, jcfg)
        _equal(got[0], want[0])
        assert got[1] == want[1] > 0
    area = int((den == particle).sum())
    got = rp.recreate_particle_area(den.copy(), ct, area, tcfg)
    want = jax_rp.recreate_particle_area(den.copy(), ct, area, jcfg)
    _equal(got[0], want[0])
    assert got[1] == want[1] > area


@pytest.mark.parametrize("with_cells", [True, False])
def test_dapi_dedup_equals_jax(with_cells):
    dapi = synthetic_label_plane(seed=8, cell_types={1: "6B07", 2: "Particle", 3: "Background"},
                                 shape=(160, 160))
    other = synthetic_label_plane(seed=9, cell_types={1: "C3M10", 2: "Particle",
                                                      3: "Background"}, shape=(160, 160))
    other[:, :80] = np.roll(dapi, 3, axis=1)[:, :80]  # DAPI cells seen again, shifted
    if not with_cells:
        dapi = np.where(dapi == 1, 3, dapi).astype(dapi.dtype)
    for threshold in (0.1, 0.5):
        jcfg = JaxConfig(dapi_overlap_threshold=threshold)
        got = rp.combine_cell_positions_and_clusters(dapi, other, config_from_fields(jcfg))
        want = jax_rp.combine_cell_positions_and_clusters(dapi, other, jcfg)
        _equal(got, want)
        assert ((got == 2) & (dapi == 1)).any() == with_cells


@pytest.mark.parametrize("strains", [["3D05", "6B07"], ["6B07"], ["6B07", "C3M10"],
                                     ["3D05", "6B07", "C3M10"]])
def test_rfp_base_and_combine_channels_equal_jax_on_a_fused_tree(strains):
    """A fused tree's channels: the RFP plane remapped into BASE_TYPE space
    (in place, both branches), then each other strain's cells stamped."""
    six_b07 = strains in (["6B07"], ["6B07", "C3M10"])
    rfp_map = ({1: "Particle", 2: "Background"} if six_b07
               else {1: "3D05", 2: "Particle", 3: "Background"})
    if six_b07:
        rfp = np.where(synthetic_label_plane(seed=20, shape=(128, 128)) == 1, 2,
                       synthetic_label_plane(seed=20, shape=(128, 128)) - 1).astype(np.uint8)
        rfp[rfp == 0] = 1
    else:
        rfp = synthetic_label_plane(seed=20, cell_types=rfp_map, shape=(128, 128))
    channels = {
        "DAPI": synthetic_label_plane(seed=21, cell_types={1: "6B07", 2: "Particle",
                                                           3: "Background"}, shape=(128, 128)),
        "GFP": synthetic_label_plane(seed=22, cell_types={1: "C3M10", 2: "Particle",
                                                          3: "Background"}, shape=(128, 128)),
    }
    a, b = rfp.copy(), rfp.copy()
    base = rp.get_rfp_base_arr(a, list(strains))
    want = jax_rp.get_rfp_base_arr(b, list(strains))
    assert base is a and want is b  # in place, as the reference
    _equal(base, want)
    assert set(np.unique(base)) <= set(BASE_TYPE_MAP)
    got = rp.combine_channels(base.copy(), channels, list(strains))
    fused = jax_rp.combine_channels(want.copy(), channels, list(strains))
    _equal(got, fused)
    assert set(np.unique(got)) - {4, 5} == {v for v, n in BASE_TYPE_MAP.items() if n in strains}
