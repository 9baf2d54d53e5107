"""Parity: the PyTorch port's NanoSIMS analysis (config #4, ``pcis
nanosims``) and its antialiased cubic resize against the JAX package on the
CPU.

Inputs are made with numpy from a seed (the fixtures are copies of the JAX
package's ``tests/test_refine_nanosims.py``) and handed to both packages.

Tolerances:
- ROI counts, labels and ROI order, host helpers, display images, CSV
  class and index columns: exact.
- Resize weights: bit for bit with ``jax.image.resize`` of an identity for
  every axis longer than 32 px.  On shorter axes XLA folds the weights at
  compile time in an order the port does not reproduce: within 4.8e-7
  (4 units in the last place at 1.0).
- Resized one-hot masks: within 3.6e-7 absolute (the largest difference
  on config #4's 700x650 painting is 2.98e-7,
  ``test_config4_resize_for_both_axis_orders``); solid masks (value ≥ 1)
  equal except on pixels whose JAX value lies within 2.4e-7 of 1.0.
- Sums rtol 2e-5, atol 1e-3 and positions atol 0.05 px: the JAX package's
  own tolerances between its batched and sequential paths
  (``test_batched_roi_path_matches_sequential``).  Distances in µm
  0.05·19/512.  A small ROI whose interior sits on the solid threshold can
  move by more than 0.05 px when borderline pixels flip (XLA's CPU matmul
  sometimes sums a row of taps in two interleaved chains, which the port
  does not reproduce; 10-px squares resized 130×106 → 96 move up to 0.3
  px).  Such a ROI is held instead to: every flip borderline, and its
  position the centroid of the port's own solid mask.  Values read back from a CSV (5 significant digits) may
  differ by one more unit in the last printed digit.
"""

import os
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import savemat

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu import config as jax_config
from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.models import nanosims as jax_ns
from particle_col_image_segmentation_tpu.report import csvio as jax_csvio
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import NanoSIMSConfig, config_from_fields
from particle_col_image_segmentation_tpu_torch.models import nanosims as ns
from particle_col_image_segmentation_tpu_torch.ops.resize import (
    axis_order,
    resize_cubic,
    weight_matrix,
)
from particle_col_image_segmentation_tpu_torch.report import csvio as port_csvio

from chip_smoke import config4_painting

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
MASK_ATOL = 3.6e-7  # resized values
BORDER = 2.4e-7  # a solid pixel may flip only this close to 1.0
SUM_RTOL, SUM_ATOL, POS_ATOL = 2e-5, 1e-3, 0.05
DIST_ATOL = 0.05 * 19.0 / 512.0


def _painted_rois(size=96):
    """White canvas with red and green painted ROI disks."""
    rgb = np.full((size, size, 3), 255, np.uint8)
    yy, xx = np.mgrid[:size, :size]

    def paint(cy, cx, r, color):
        rgb[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = color

    paint(20, 20, 5, (255, 0, 0))
    paint(60, 60, 6, (255, 0, 0))
    paint(30, 70, 5, (0, 255, 0))
    return rgb


def _isotopes(n=98, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.random((n - 2, n - 2)) * 100 for k in jax_ns.ISOTOPES}


def _squares(h: int, w: int, size: int, pitch: int, limit: int = 40) -> np.ndarray:
    """Painted squares on white, odd ids red and even ids green (config #4's
    recipe, cut down)."""
    rgb = np.full((h, w, 3), 255, np.uint8)
    k = 1
    for gy in range(0, h - size - 8, pitch):
        for gx in range(0, w - size - 8, pitch):
            if k <= limit:
                rgb[gy + 4:gy + 4 + size, gx + 4:gx + 4 + size] = (
                    (255, 0, 0) if k % 2 else (0, 255, 0))
                k += 1
    return rgb


# ---- the resize ----

SIZES = [(96, 64), (768, 512), (600, 512), (701, 512), (512, 512), (300, 512)]


def _jax_weights(n_in, n_out):
    eye = jnp.eye(n_in, dtype=jnp.float32)
    return np.asarray(jax.image.resize(eye, (n_out, n_in), method="cubic", antialias=True)).T


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_resize_weights_are_jax_bit_for_bit(n_in, n_out):
    got = weight_matrix(n_in, n_out)
    want = _jax_weights(n_in, n_out)
    assert got.dtype == np.float32 and got.shape == (n_in, n_out)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_in,n_out", [(5, 3), (3, 7), (32, 20)])
def test_resize_weights_of_short_axes_within_two_ulps(n_in, n_out):
    """Axes of 32 px or less: XLA folds the weight sums at compile time."""
    np.testing.assert_allclose(weight_matrix(n_in, n_out), _jax_weights(n_in, n_out),
                               rtol=0, atol=2 * BORDER)


def _one_hot(labels: np.ndarray, n: int) -> np.ndarray:
    return (labels[None] == np.arange(1, n + 1)[:, None, None]).astype(np.float32)


def _compare_masks(got: np.ndarray, want: np.ndarray, case: str) -> int:
    """Values within MASK_ATOL; solid flips only on borderline pixels.
    Returns the number of borderline flips."""
    assert got.shape == want.shape, case
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_ATOL, err_msg=case)
    flips = np.argwhere((got >= 1) != (want >= 1))
    borderline = np.abs(want[tuple(flips.T)] - 1.0) <= BORDER
    assert borderline.all(), (
        f"{case}: solid pixels flip away from the threshold: "
        f"{[tuple(f) for f in flips[~borderline][:10]]}")
    return len(flips)


def _resize_cases():
    lab96 = ns.roi_labels(ns.class_masks(_painted_rois())[0], 64, CPU)[0].numpy()
    sq = _squares(192, 176, 20, 36)
    lab_sq = ns.roi_labels(ns.class_masks(ns.crop_to_content(sq))[0], 64, CPU)[0].numpy()
    big = np.zeros((768, 768), np.int32)
    big[100:136, 200:236] = 1
    big[400:436, 600:636] = 2
    rois = ns.crop_to_content(config4_painting(700, 650, 33, 30, 60, 56)[0])
    config4 = ns.roi_labels(ns.class_masks(rois)[0], 1024, CPU)[0].numpy()
    return {"painted disks 96->64": (lab96, 64), "squares 176x160->96": (lab_sq, 96),
            "painted disks 96->140": (lab96, 140), "squares 768->512": (big, 512),
            "config #4 700x650 painting, red, 633x590->512": (config4, 512)}


@pytest.mark.parametrize("case", list(_resize_cases()))
def test_resized_one_hot_masks_match_jax(case):
    labels, acq = _resize_cases()[case]
    masks = _one_hot(labels, int(labels.max()))
    want = np.asarray(jax.vmap(lambda m: jax_ns._resize_acq(m, acq))(jnp.asarray(masks)))
    got = resize_cubic(torch.from_numpy(masks), acq).numpy()
    flips = _compare_masks(got, want, case)
    print(f"{case}: {flips} borderline solid flips of {int((want >= 1).sum())}")


@pytest.mark.parametrize("painting", ["768x768", "700x650"])
def test_config4_resize_for_both_axis_orders(painting):
    """Every ROI of smoke phase 11's paintings (``config4_painting``),
    labelled as ``run_nanosims`` labels them, resized to 512² by JAX and by
    the port with rows first and with columns first.  The order the port
    chooses (the einsum's) holds the mask tolerances and flips fewer solid
    pixels.  Prints, per order, the pixels whose value differs, the solid
    flips, how many lie within 2.4e-7 of 1.0, and the largest difference
    (``pytest -s``; PERF.md cites these)."""
    import json

    h, w, sy, sx, py, px = (768, 768, 36, 36, 66, 66) if painting == "768x768" else (
        700, 650, 33, 30, 60, 56)
    rois = ns.crop_to_content(config4_painting(h, w, sy, sx, py, px)[0])
    jax_resize = jax.jit(jax.vmap(lambda m: jax_ns._resize_acq(m, 512)))
    masks, want = [], []
    for mask in ns.class_masks(rois):
        labels, n = ns.roi_labels(mask, 1024, CPU)
        for c0 in range(0, n, 16):
            ids = np.arange(c0 + 1, min(n, c0 + 16) + 1)
            masks.append((labels.numpy()[None] == ids[:, None, None]).astype(np.float32))
            want.append(np.asarray(jax_resize(jnp.asarray(masks[-1]))))
    want = np.concatenate(want)
    flips = {}
    for axes in ((-2, -1), (-1, -2)):
        got = np.concatenate([resize_cubic(torch.from_numpy(m), 512, axes).numpy()
                              for m in masks])
        flip = (got >= 1) != (want >= 1)
        flips[axes] = int(flip.sum())
        print(json.dumps({
            "painting": painting, "cropped": list(rois.shape[:2]), "rois": len(want),
            "axes": "rows first" if axes == (-2, -1) else "columns first",
            "chosen": axes == axis_order(*rois.shape[:2], 512),
            "pixels_differing": int((got != want).sum()), "solid_pixels": int((want >= 1).sum()),
            "solid_flips": flips[axes],
            "flips_within_2.4e-7_of_1": int((flip & (np.abs(want - 1) <= BORDER)).sum()),
            "max_abs_diff": float(np.abs(got - want).max())}))
        if axes == axis_order(*rois.shape[:2], 512):
            _compare_masks(got, want, f"{painting} {axes}")
    chosen = axis_order(*rois.shape[:2], 512)
    assert flips[chosen] == min(flips.values()) and flips[chosen] < 0.01 * (want >= 1).sum()


def test_resize_axis_order_is_the_einsums():
    assert axis_order(768, 768, 512) == (-2, -1)
    assert axis_order(700, 650, 512) == (-2, -1)
    assert axis_order(650, 700, 512) == (-1, -2)
    assert axis_order(512, 700, 512) == (-2, -1)
    with pytest.raises(ValueError, match="float32"):
        resize_cubic(torch.zeros((4, 4), dtype=torch.float64), 2)


# ---- host helpers ----


def test_host_helpers_match_jax_exactly():
    raw = np.full((10, 12), 7.0)
    np.testing.assert_array_equal(ns.crop_frame(raw), jax_ns.crop_frame(raw))
    rgb = np.full((40, 50, 3), 255, np.uint8)
    rgb[10:20, 15:30] = (255, 0, 0)
    edge = np.full((40, 50, 3), 255, np.uint8)
    edge[30:40, 35:50] = (255, 0, 0)
    for img in (rgb, edge, _painted_rois(), np.full((8, 8, 3), 255, np.uint8)):
        for rect in (False, True):
            np.testing.assert_array_equal(ns.crop_to_content(img, imcrop_rect=rect),
                                          jax_ns.crop_to_content(img, imcrop_rect=rect))
    rng = np.random.default_rng(4)
    noise = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    for img in (_painted_rois(), noise):
        for a, b in zip(ns.class_masks(img), jax_ns.class_masks(img)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ns.boundary_class_mask(img),
                                      jax_ns.boundary_class_mask(img))
    vals = np.array([[1.0, 510.0, np.nan, 0.0, 254.5, -3.0]])
    for raw in (vals, rng.random((20, 30)) * 1e4, np.zeros((3, 3)), np.zeros((0, 4))):
        np.testing.assert_array_equal(ns.to_uint8_display(raw), jax_ns.to_uint8_display(raw))
    assert ns.to_uint8_display(np.array([[1.0, 510.0]]))[0, 0] == 1  # MATLAB's half away
    num, den = np.array([[0.0, 5.0, 3.0]]), np.array([[0.0, 5.0, 0.0]])
    np.testing.assert_array_equal(ns.ratio_image(num, den), jax_ns.ratio_image(num, den))


def test_display_images_match_jax_exactly():
    iso = _isotopes()
    got = ns.display_images(iso, device=CPU)
    want = jax_ns.display_images(iso)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.uint8, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---- the ROI analysis ----


def _roi_masks():
    m_id = np.zeros((96, 96), bool)  # painted size = acquisition size
    m_id[10:20, 10:20] = True
    m_id[50:60, 50:64] = True
    m_down = np.zeros((96, 96), bool)  # 3x downscale: one ROI dissolves
    m_down[10:40, 10:40] = True
    m_down[80:82, 80:82] = True
    m_order = np.zeros((96, 96), bool)  # raster-first is not column-first
    m_order[0:6, 50:56] = True
    m_order[40:46, 3:9] = True
    m_big = np.zeros((140, 120), bool)  # upscale, not square
    m_big[8:30, 10:40] = True
    m_big[60:100, 70:95] = True
    m_big[110:130, 5:20] = True
    return {"identity": (m_id, 96), "dissolved": (m_down, 32), "column-major": (m_order, 96),
            "upscale 140x120->160": (m_big, 160), "empty": (np.zeros((40, 40), bool), 32)}


def _compare_positions(got, want, acq: int, case: str) -> None:
    """Positions within POS_ATOL (NaN where JAX has NaN); a ROI past that
    must owe it to borderline flips, and sit at its solid mask's centroid."""
    far = ~np.isclose(got.positions, want.positions, rtol=0, atol=POS_ATOL, equal_nan=True)
    for r in np.nonzero(far.any(axis=1))[0]:
        mask = (got.labels == r + 1).astype(np.float32)
        mine = resize_cubic(torch.from_numpy(mask), acq).numpy()
        flips = _compare_masks(mine, np.asarray(jax_ns._resize_acq(jnp.asarray(mask), acq)),
                               f"{case} ROI {r + 1}")
        assert flips > 0, f"{case} ROI {r + 1}: moved {got.positions[r] - want.positions[r]}"
        ys, xs = np.nonzero(mine >= 1)
        np.testing.assert_allclose(got.positions[r], [xs.mean() + 1, ys.mean() + 1], rtol=1e-6)
        print(f"{case} ROI {r + 1}: {flips} borderline flips move it by "
              f"{got.positions[r] - want.positions[r]}")


def _compare_class(got, want, case: str, acq: int) -> None:
    assert got.num_rois == want.num_rois, case
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels), err_msg=case)
    np.testing.assert_allclose(got.sums, want.sums, rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=case)
    np.testing.assert_allclose(got.activities, want.activities, rtol=SUM_RTOL, atol=SUM_ATOL,
                               err_msg=case)
    _compare_positions(got, want, acq, case)
    assert sorted(got.activity_images) == sorted(want.activity_images)
    for k in want.activity_images:
        np.testing.assert_allclose(got.activity_images[k], want.activity_images[k],
                                   rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=f"{case} {k}")
    for name in ("h_sums", "d_activity"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), case
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, atol=SUM_ATOL, err_msg=case)


@pytest.mark.parametrize("case", list(_roi_masks()))
def test_analyze_roi_class_matches_jax(case):
    mask, acq = _roi_masks()[case]
    rng = np.random.default_rng(5)
    iso = {k: rng.random((acq, acq)).astype(np.float32) * 50 for k in jax_ns.ISOTOPES}
    got = ns.analyze_roi_class(mask, iso, device=CPU)
    want = jax_ns.analyze_roi_class(mask, iso)
    _compare_class(got, want, case, acq)
    if case == "dissolved":
        assert got.num_rois == 2 and np.isfinite(got.positions[0]).all()
        assert np.isnan(got.positions[1]).all()
    if case == "column-major":  # MATLAB numbering: ROI 1 is the column-3 one
        assert got.positions[0][0] < got.positions[1][0]


def test_roi_sums_and_centroids_match_the_batched_jax_path():
    """The per-ROI reduction alone against ``_roi_batched`` on one label
    image, with the painted size larger than the acquisition's."""
    rng = np.random.default_rng(5)
    mask = np.zeros((96, 96), bool)
    mask[8:24, 10:30] = True
    mask[40:60, 50:70] = True
    mask[70:90, 12:28] = True
    labels, n = ns.roi_labels(mask, 64, CPU)
    iso = rng.random((7, 64, 64)).astype(np.float32)
    sums, cents = ns.roi_sums_and_centroids(labels, torch.from_numpy(iso), n, 64)
    want_s, want_c = jax_ns._roi_batched(jnp.asarray(labels.numpy()), jnp.asarray(iso), 16, 64)
    assert n == 3 and sums.dtype == torch.float64 and cents.dtype == torch.float32
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_s)[:n], rtol=SUM_RTOL,
                               atol=SUM_ATOL)
    np.testing.assert_allclose(cents.numpy(), np.asarray(want_c)[:n], rtol=0, atol=POS_ATOL)


def test_roi_centroids_equal_jax_until_coordinate_sums_pass_2_24():
    """The centroid sums alone (the resize an identity: painted size =
    acquisition size, so every solid mask is the ROI itself): ROIs whose
    column and row sums stay below 2^24 get JAX's float32 positions bit for
    bit.  XLA contracts no multiply-add here (a float32 sum, a division, an
    add).  Past 2^24 the JAX package's float32 sums round in XLA's order,
    while the port sums exactly in int64 and rounds the sum once to float32:
    a disc of radius 250 centred at (501, 401) in a 768² acquisition lands
    at JAX's (501.0001, 400.99988) and the port's (500.99997, 401.0), both
    within 1.3e-4 px of the true centre and far inside ``POS_ATOL``."""
    size = 768
    yy, xx = np.mgrid[:size, :size]
    labels = np.zeros((size, size), np.int32)
    labels[(yy - 400) ** 2 + (xx - 500) ** 2 <= 250 ** 2] = 1
    labels[(yy - 20) ** 2 + (xx - 20) ** 2 <= 81] = 2
    labels[200:250, 10:60] = 3
    labels[700:760, 600:767] = 4
    iso = np.random.default_rng(8).random((1, size, size)).astype(np.float32)
    _, got = ns.roi_sums_and_centroids(torch.from_numpy(labels), torch.from_numpy(iso), 4, size)
    got = got.numpy()
    want = np.asarray(jax_ns._roi_batched(jnp.asarray(labels), jnp.asarray(iso), 16, size)[1])[:4]
    past = [max((xx * (labels == k)).sum(), (yy * (labels == k)).sum()) >= 2**24
            for k in range(1, 5)]
    assert past == [True, False, False, False]
    np.testing.assert_array_equal(got[1:].view(np.int32), want[1:].view(np.int32))
    assert not np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[0], [501.0, 401.0], rtol=0, atol=1.3e-4)
    np.testing.assert_allclose(want[0], [501.0, 401.0], rtol=0, atol=1.3e-4)


@pytest.mark.parametrize("flags", [{}, {"compat_green_o_bug": True},
                                   {"compat_imcrop_rect": True}])
def test_analyze_nanosims_and_compat_flags_match_jax(flags):
    iso = _isotopes()
    rgb = _painted_rois()
    got = ns.analyze_nanosims(iso, rgb, NanoSIMSConfig(**flags), device=CPU)
    want = jax_ns.analyze_nanosims(iso, rgb, jax_config.NanoSIMSConfig(**flags))
    _compare_class(got.red, want.red, "red", 96)
    _compare_class(got.green, want.green, "green", 96)
    np.testing.assert_array_equal(got.all_data[:, :2], want.all_data[:, :2])
    np.testing.assert_allclose(got.all_data, want.all_data, rtol=SUM_RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(got.data_xy[:, 17:], want.data_xy[:, 17:], rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(got.nearest, want.nearest, rtol=0, atol=DIST_ATOL)
    np.testing.assert_array_equal(got.rois_cropped, want.rois_cropped)
    for k in want.activity_images:
        np.testing.assert_allclose(got.activity_images[k], want.activity_images[k],
                                   rtol=SUM_RTOL, atol=SUM_ATOL)
    if flags.get("compat_green_o_bug"):
        assert (got.green.activity_images["O17"] == 0).all()
    if flags.get("compat_imcrop_rect"):  # MATLAB's crop: one more row and column
        tight = ns.crop_to_content(rgb).shape
        assert got.red.labels.shape == (tight[0] + 1, tight[1] + 1)


def test_max_rois_overflow_raises_in_both_packages():
    rgb = _squares(120, 120, 8, 20, limit=40)
    iso = _isotopes(n=34)
    with pytest.raises(ValueError, match="max_rois=4"):
        ns.analyze_nanosims(iso, rgb, NanoSIMSConfig(max_rois=4), device=CPU)
    with pytest.raises(ValueError, match="max_rois=4"):
        jax_ns.analyze_nanosims(iso, rgb, jax_config.NanoSIMSConfig(max_rois=4))


# ---- end to end ----

MAT_NAMES = ("12C", "13C", "14N12C", "15N12C", "16O", "17O", "18O", "Esi")


def _acquisition(root: pathlib.Path, n: int = 98, painted=None, deuterium: bool = False,
                 seed: int = 1) -> pathlib.Path:
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for name in MAT_NAMES + (("1H", "2H") if deuterium else ()):
        savemat(str(root / f"{name}.mat"), {"IM": rng.random((n, n)) * 50})
    Image.fromarray(_painted_rois(n - 2) if painted is None else painted).save(
        str(root / "rois.png"))
    h, w = (n - 2, n - 2) if painted is None else painted.shape[:2]
    bound = np.full((h, w, 3), 255, np.uint8)
    bound[h // 2 - 5:h // 2 + 5, 10:w - 16] = (255, 0, 0)
    Image.fromarray(bound).save(str(root / "bound.png"))
    return root


def _read_csvs(folder: pathlib.Path) -> dict:
    return {f: np.loadtxt(folder / f, delimiter=",", ndmin=2)
            for f in sorted(os.listdir(folder)) if f.endswith(".csv")}


def _digit(x: np.ndarray) -> np.ndarray:
    """One unit in the 5th significant digit of each value."""
    mag = np.where(np.isfinite(x) & (x != 0), np.abs(x), 1.0)
    return 10.0 ** (np.floor(np.log10(mag)) - 4)


def _compare_csvs(got: dict, want: dict, moved=None, shift_px: float = 0.0) -> None:
    """Every file of ``want`` in ``got`` with its shape and values; the
    positions of rows ``moved`` are not compared, and distances may move by
    ``shift_px`` more."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name == "data_deuterium.csv":
            np.testing.assert_array_equal(g[:, :2], w[:, :2])
            tol = SUM_ATOL + SUM_RTOL * np.abs(w) + _digit(w)
            assert (np.abs(g - w) <= tol).all(), name
            continue
        np.testing.assert_array_equal(g[:, :2], w[:, :2], err_msg=name)  # class, index
        tol = np.where(np.arange(w.shape[1]) < 17, SUM_ATOL + SUM_RTOL * np.abs(w), 0.0)
        if name == "data_xy.csv":
            tol[:, 17:] = POS_ATOL
        elif w.shape[1] > 17:
            tol[:, 17:] = DIST_ATOL + shift_px * 19.0 / 512.0
        tol = tol + _digit(w)
        if moved is not None and name == "data_xy.csv":
            tol[moved, 17:] = np.inf
        same_nan = np.isnan(g) == np.isnan(w)
        ok = same_nan & (np.isnan(w) | (np.abs(g - w) <= tol))
        assert ok.all(), f"{name}: {np.argwhere(~ok)[:5]}"


@pytest.mark.parametrize("case", ["default", "deuterium", "squares 140x120"])
def test_run_nanosims_writes_the_jax_files(tmp_path, case):
    painted = _squares(140, 120, 10, 24) if case == "squares 140x120" else None
    acq = _acquisition(tmp_path / "acq", painted=painted, deuterium=case == "deuterium")
    outs, res = {}, {}
    for tag in ("port", "jax"):
        out = tmp_path / tag
        out.mkdir()
        args = (str(acq), str(acq / "rois.png"), str(acq / "bound.png"), str(out))
        if tag == "port":
            res[tag] = ns.run_nanosims(*args, make_figures=False, device=CPU)
        else:
            res[tag] = jax_ns.run_nanosims(*args, make_figures=False)
        outs[tag] = _read_csvs(out)
    assert len(outs["jax"]) == (5 if case == "deuterium" else 4)
    for cls in ("red", "green"):
        _compare_class(getattr(res["port"], cls), getattr(res["jax"], cls), f"{case} {cls}", 96)
    # ROIs that borderline flips moved are held above; a distance moves by
    # at most the largest such move (the triangle inequality)
    shift = np.nan_to_num(np.abs(res["port"].data_xy[:, 17:] - res["jax"].data_xy[:, 17:]))
    moved = (shift > POS_ATOL).any(axis=1)
    if case != "squares 140x120":
        assert not moved.any()
    _compare_csvs(outs["port"], outs["jax"], moved, float(np.hypot(*shift.T).max()))


def test_nanosims_verb_matches_the_jax_cli(tmp_path, capsys):
    acq = _acquisition(tmp_path / "acq")
    lines = {}
    for tag, cli, extra in (("port", torch_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        out = tmp_path / tag
        out.mkdir()
        rc = cli(["nanosims", str(acq), str(acq / "rois.png"), "--bound-png",
                  str(acq / "bound.png"), "--out-dir", str(out), "--no-figures",
                  "--compat-green-o-bug"] + extra)
        assert rc in (0, None)
        lines[tag] = capsys.readouterr().out.strip().splitlines()[-1].replace(str(out), "OUT")
    assert lines["port"] == lines["jax"] == "red ROIs: 2, green ROIs: 1; CSVs written to OUT"
    _compare_csvs(_read_csvs(tmp_path / "port"), _read_csvs(tmp_path / "jax"))


def test_cuda_is_the_default_and_raises_without_it(tmp_path):
    import inspect

    for fn in (ns.run_nanosims, ns.analyze_nanosims, ns.analyze_roi_class, ns.roi_labels,
               ns.display_images, ns.boundary_distances):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    acq = _acquisition(tmp_path / "acq")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ns.run_nanosims(str(acq), str(acq / "rois.png"), out_dir=str(tmp_path),
                        make_figures=False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_cli(["nanosims", str(acq), str(acq / "rois.png"), "--out-dir",
                       str(tmp_path), "--no-figures"] + argv)
    assert not any(f.endswith(".csv") for f in os.listdir(tmp_path))


def test_save_all_writes_the_figures(tmp_path):
    from particle_col_image_segmentation_tpu_torch.viz.nanosims_figures import save_all

    iso = _isotopes()
    rgb = _painted_rois()
    res = ns.analyze_nanosims(iso, rgb, device=CPU)
    bound = np.zeros(rgb.shape[:2], bool)
    bound[40:50, 10:80] = True
    save_all(res, rgb, ns.to_uint8_display(iso["N14C12"]), str(tmp_path), bound_mask=bound,
             bound_rgb=rgb)
    for f in ("rois_clear.png", "annotations.png", "cell position.png", "agg_boundary.png"):
        assert os.path.getsize(tmp_path / f) > 5000, f
    assert (tmp_path / "rois_clear.svg").exists() and (tmp_path / "bound_paint_clear.png").exists()


def test_nanosims_config_and_matrix_csv_equal_the_jax_package(tmp_path):
    assert NanoSIMSConfig() == config_from_fields(jax_config.NanoSIMSConfig())
    cfg = jax_config.NanoSIMSConfig(max_rois=7, compat_green_o_bug=True, raster_um=12.5)
    assert config_from_fields(cfg) == NanoSIMSConfig(max_rois=7, compat_green_o_bug=True,
                                                     raster_um=12.5)
    m = np.array([[1.0, 2.5e-7, np.nan, 123456.789, -0.0, np.inf]])
    for mod, tag in ((port_csvio, "port"), (jax_csvio, "jax")):
        mod.write_matrix_csv(str(tmp_path / f"{tag}.csv"), m)
        mod.write_matrix_csv(str(tmp_path / f"{tag}_empty.csv"), np.zeros((0, 17)))
    for s in ("", "_empty"):
        assert (tmp_path / f"port{s}.csv").read_bytes() == (tmp_path / f"jax{s}.csv").read_bytes()
    assert ns.ISOTOPES == jax_ns.ISOTOPES and ns._SUM_ORDER == jax_ns._SUM_ORDER


def test_nanosims_modules_import_no_jax(tmp_path):
    """Import the slice in a fresh interpreter, run an acquisition on the
    CPU, and check that neither jax nor the JAX package was loaded."""
    acq = _acquisition(tmp_path / "acq")
    code = (
        "import importlib, sys\n"
        "for m in ('models.nanosims', 'ops.resize', 'ops.morphology', 'ops.edt',\n"
        "          'viz.nanosims_figures', 'report.csvio', 'cli'):\n"
        "    importlib.import_module('particle_col_image_segmentation_tpu_torch.' + m)\n"
        "from particle_col_image_segmentation_tpu_torch.models.nanosims import run_nanosims\n"
        f"res = run_nanosims({str(acq)!r}, {str(acq / 'rois.png')!r}, out_dir={str(tmp_path)!r},\n"
        "                   make_figures=False, device='cpu')\n"
        "assert (res.red.num_rois, res.green.num_rois) == (2, 1)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'particle_col_image_segmentation_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
