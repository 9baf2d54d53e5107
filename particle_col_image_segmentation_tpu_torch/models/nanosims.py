"""NanoSIMS 5-isotope ROI activity/distance analysis (config #4).

Counterpart of ``particle_col_image_segmentation_tpu/models/nanosims.py``,
the port of HCN_nanosims_rois_activity_distance_5iso_YG.m (line references
below are into that script):

  1. load per-species count images from .mat, crop a 1-px frame (:6-28);
  2. display / ratio images with Gaussian blur (:30-69);
  3. painted-PNG ROI ingestion: red/green classes (:82-102);
  4. per-ROI isotope sums and activities (:104-234): each painted class is
     labelled on the device (K2 and K3 on the card), then chunks of ROI
     one-hot masks are resized to the acquisition's size in one call
     (``ops.resize``) and reduce to isotope sums, solid masks and centroids
     (``roi_sums_and_centroids``);
  5. data.csv / data_xy.csv (:237, :252-256);
  6. nearest-neighbour distances between classes (:259-268);
  7. distance to the painted aggregate boundary (:270-309).

The isotope stack, the labels and the reductions live on the device; PNG
and .mat parsing, the activity maps and the CSVs stay on the host.  Sums are
float64 (each float32 product exact, summed in float64), so the card and
the CPU agree to far below the CSVs' 5 digits; the JAX package sums in
float32, within rtol 2e-5.  Deliberate deviations of the JAX package from
the script are kept, with its compat flags (``NanoSIMSConfig``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from particle_col_image_segmentation_tpu_torch.config import NanoSIMSConfig
from particle_col_image_segmentation_tpu_torch.ops.ccl import (
    compact_labels_auto,
    connected_components_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.filters import gaussian_blur
from particle_col_image_segmentation_tpu_torch.ops.morphology import boundary_mask
from particle_col_image_segmentation_tpu_torch.ops.pairwise import min_dist_to_set
from particle_col_image_segmentation_tpu_torch.ops.resize import resize_cubic

ISOTOPES = ("C12", "C13", "N14C12", "N15C12", "O16", "O17", "O18", "ESI")
# data row column order (ref :154): class, i, C12, C13, N14, N15, O16, O17, O18
_SUM_ORDER = ("C12", "C13", "N14C12", "N15C12", "O16", "O17", "O18")
_MAT_FILES = {
    "N14C12": "14N12C.mat",
    "N15C12": "15N12C.mat",
    "C12": "12C.mat",
    "C13": "13C.mat",
    "O16": "16O.mat",
    "O17": "17O.mat",
    "O18": "18O.mat",
    "ESI": "Esi.mat",
}
# device memory a chunk of ROIs may take in the per-ROI reduction
_CHUNK_BYTES = 1 << 29


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available here")
    return device


def crop_frame(arr: np.ndarray) -> np.ndarray:
    """Crop the 1-px acquisition frame: IM(2:n-1, 2:n-1) (ref :19-28)."""
    return np.asarray(arr)[1:-1, 1:-1]


def load_isotope_mats(folder: str) -> Dict[str, np.ndarray]:
    """Load the ``{name}.mat`` files, each holding matrix ``IM`` (ref
    :6-16), as float64 with the frame cropped: 12C, 13C, 14N12C, 15N12C,
    16O, 17O, 18O and Esi, and 1H/2H where the acquisition has them (the
    script's commented-out deuterium variant, :13-14/:26-27)."""
    from scipy.io import loadmat

    out = {key: crop_frame(loadmat(os.path.join(folder, fname))["IM"].astype(np.float64))
           for key, fname in _MAT_FILES.items()}
    for key, fname in (("H1", "1H.mat"), ("H2", "2H.mat")):
        path = os.path.join(folder, fname)
        if os.path.exists(path):
            out[key] = crop_frame(loadmat(path)["IM"].astype(np.float64))
    return out


def to_uint8_display(raw: np.ndarray) -> np.ndarray:
    """uint8(raw * 255/max) with MATLAB rounding and saturation (ref
    :30-39): uint8() rounds half away from zero, max() ignores NaN, and
    uint8(NaN) = 0."""
    raw = np.asarray(raw, np.float64)
    m = float(np.nanmax(raw)) if raw.size else 0.0
    scaled = raw * (255.0 / m) if m > 0 else np.zeros_like(raw)
    out = np.clip(np.floor(scaled + 0.5), 0, 255)
    return np.where(np.isnan(out), 0, out).astype(np.uint8)


def ratio_image(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """uint8(num/den * 255/max(num/den)) (ref :45-69); 0/0 and x/0 pixels
    display as 0, as MATLAB's uint8() defines them."""
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.asarray(num, np.float64) / np.asarray(den, np.float64)
    return to_uint8_display(ratio)


def display_images(iso: Dict[str, np.ndarray], cfg: NanoSIMSConfig = NanoSIMSConfig(),
                   device="cuda") -> Dict[str, np.ndarray]:
    """All display and ratio images of ref :30-69 (blurred and unblurred);
    the blurs are float32 ``gaussian_blur`` on ``device``."""
    dev = _device(device)

    def g(a, s):
        x = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return gaussian_blur(x, s).cpu().numpy()

    n15g = g(iso["N15C12"], cfg.sigma_display)
    n14g = g(iso["N14C12"], cfg.sigma_display)
    c12g = g(iso["C12"], cfg.sigma_ratio)
    c13g = g(iso["C13"], cfg.sigma_ratio)
    o16g = g(iso["O16"], cfg.sigma_display)
    o17g = g(iso["O17"], cfg.sigma_display)
    o18g = g(iso["O18"], cfg.sigma_display)
    esig = g(iso["ESI"], cfg.sigma_ratio)
    out = {name: to_uint8_display(iso[name]) for name in _SUM_ORDER}
    out.update(
        N15ratioimg=ratio_image(n15g, n15g + n14g),
        N14C12C12ratio=ratio_image(n14g, c12g),
        C13ratioimg=ratio_image(c13g, c13g + c12g),
        O17ratioimg=ratio_image(o17g, o18g + o17g + o16g),
        O18ratioimg=ratio_image(o18g, o18g + o17g + o16g),
        # ref :63-64 computes the blurred ESI ratio, then overwrites it with
        # the raw one; both are exposed
        N14C12ESIratio_blur=ratio_image(n14g, esig),
        N14C12ESIratio=ratio_image(iso["N14C12"], iso["ESI"]),
        N15ratimg=ratio_image(iso["N15C12"], iso["N15C12"] + iso["N14C12"]),
        C13ratimg=ratio_image(iso["C13"], iso["C13"] + iso["C12"]),
        O17ratimg=ratio_image(iso["O17"], iso["O18"] + iso["O17"] + iso["O16"]),
        O18ratimg=ratio_image(iso["O18"], iso["O18"] + iso["O17"] + iso["O16"]),
    )
    return out


# ---------------------------------------------------------------------------
# painted-ROI ingestion (ref :82-102)
# ---------------------------------------------------------------------------


def crop_to_content(rgb: np.ndarray, blue_thresh: int = 200,
                    imcrop_rect: bool = False) -> np.ndarray:
    """Crop a painted PNG to the bounding box of its content (blue < thresh)
    (ref :83-85).  ``imcrop_rect=True`` keeps MATLAB imcrop's one extra row
    and column past the content (clamped at the image edge)."""
    mask = rgb[..., 2] < blue_thresh
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return rgb
    extra = 1 if imcrop_rect else 0
    return rgb[
        ys.min(): min(ys.max() + 1 + extra, rgb.shape[0]),
        xs.min(): min(xs.max() + 1 + extra, rgb.shape[1]),
    ]


def class_masks(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """red = (R−B)==255, green = (G−B)==255 with uint8 saturating
    subtraction (ref :91-99)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return np.clip(r - b, 0, 255) == 255, np.clip(g - b, 0, 255) == 255


def boundary_class_mask(rgb: np.ndarray, thresh: int = 175) -> np.ndarray:
    """bound.png red mask: (R−B) > thresh (ref :279-281)."""
    r = rgb[..., 0].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return np.clip(r - b, 0, 255) > thresh


# ---------------------------------------------------------------------------
# per-ROI reductions (ref :104-234)
# ---------------------------------------------------------------------------


def roi_labels(mask: np.ndarray, max_rois: int, device="cuda") -> Tuple[torch.Tensor, int]:
    """ROI ids of one painted class's mask on ``device``: 8-connected
    components numbered in COLUMN-major order of their first pixel (MATLAB
    bwconncomp's, which fixes the script's loop index and every CSV's row
    order), so the transposed mask is labelled (K2, then K3 on the card).
    Raises past ``max_rois``."""
    dev = _device(device)
    maskT = torch.as_tensor(np.ascontiguousarray(np.asarray(mask).T), device=dev)
    rawT = connected_components_auto(maskT.to(torch.uint8), background=0, connectivity=8,
                                     num_classes=2)
    labelsT, num = compact_labels_auto(rawT, max_rois)
    n = int(num)
    if n > max_rois:
        raise ValueError(f"{n} ROIs > max_rois={max_rois}")
    return labelsT.T.contiguous(), n


def roi_sums_and_centroids(labels: torch.Tensor, isotopes: torch.Tensor, num_rois: int,
                           out_size: int):
    """Isotope sums and solid-mask centroids of ROIs 1..num_rois.

    Counterpart of the JAX package's ``_roi_batched``: a chunk of ROI one-hot
    masks ([C, Hp, Wp], C sized by ``_CHUNK_BYTES``) is resized to the
    acquisition's [out_size²] (``ops.resize.resize_cubic``), each resized
    mask is summed against every isotope plane of ``isotopes`` [K, out_size,
    out_size] (float32 products, summed in float64), and its solid mask
    (pixels whose resized value floors to 1, ref .m:164-165) gives the
    1-based (x, y) centroid, NaN for a ROI the downscale dissolved.

    Returns (sums float64 [num_rois, K], centroids float32 [num_rois, 2]) on
    the labels' device."""
    dev = labels.device
    Hp, Wp = labels.shape
    K = isotopes.shape[0]
    per_roi = 4 * (Hp * Wp + 3 * out_size * Wp + 3 * out_size * out_size) + 8 * out_size ** 2
    chunk = max(1, _CHUNK_BYTES // per_roi)
    iso64 = isotopes.reshape(K, -1).to(torch.float64).T  # [P, K]
    cols = torch.arange(out_size, device=dev, dtype=torch.int64)
    sums = torch.empty((num_rois, K), dtype=torch.float64, device=dev)
    sx = torch.empty(num_rois, dtype=torch.int64, device=dev)
    sy = torch.empty_like(sx)
    cnt = torch.empty_like(sx)
    for c0 in range(0, num_rois, chunk):
        c1 = min(num_rois, c0 + chunk)
        ids = torch.arange(c0 + 1, c1 + 1, device=dev, dtype=labels.dtype)
        masks = (labels[None] == ids[:, None, None]).to(torch.float32)
        resized = resize_cubic(masks, out_size)
        sums[c0:c1] = resized.reshape(c1 - c0, -1).to(torch.float64) @ iso64
        solid = resized >= 1  # floor(v) >= 1
        cnt[c0:c1] = solid.sum(dim=(1, 2))
        sx[c0:c1] = (solid.sum(dim=1) * cols).sum(dim=1)
        sy[c0:c1] = (solid.sum(dim=2) * cols).sum(dim=1)
    safe = cnt.clamp(min=1).to(torch.float32)
    nan = torch.tensor(float("nan"), device=dev)
    cx = torch.where(cnt > 0, sx.to(torch.float32) / safe + 1.0, nan)
    cy = torch.where(cnt > 0, sy.to(torch.float32) / safe + 1.0, nan)
    return sums, torch.stack([cx, cy], dim=-1)


@dataclasses.dataclass
class RoiClassResult:
    num_rois: int
    sums: np.ndarray  # [R, 7] per _SUM_ORDER
    activities: np.ndarray  # [R, 4]: C13act, N15act, O17act, O18act
    positions: np.ndarray  # [R, 2] (x, y), acquisition space, 1-based
    labels: np.ndarray  # painted-space ROI label image
    activity_images: Dict[str, np.ndarray]  # painted-space act maps (N/C/O17/O18)
    # deuterium variant (only when 1H/2H images are present): [R, 2] H sums
    # and [R] D activity = 2H/(1H+2H)
    h_sums: Optional[np.ndarray] = None
    d_activity: Optional[np.ndarray] = None


def analyze_roi_class(mask: np.ndarray, isotopes: Dict[str, np.ndarray],
                      cfg: NanoSIMSConfig = NanoSIMSConfig(), device="cuda") -> RoiClassResult:
    """Per-ROI sums, activities, positions and activity maps of one painted
    class (the body of ref loops :122-170 / :186-234), on ``device``."""
    labels, n = roi_labels(mask, cfg.max_rois, device)
    return roi_class_result(labels, n, isotopes)


def roi_class_result(labels: torch.Tensor, n: int,
                     isotopes: Dict[str, np.ndarray]) -> RoiClassResult:
    """``analyze_roi_class`` from the class's ROI ids (``roi_labels``): the
    per-ROI reduction on the labels' device, then activities and activity
    maps on the host."""
    acq = next(iter(isotopes.values())).shape[0]
    with_h = "H1" in isotopes and "H2" in isotopes
    lab_np = labels.cpu().numpy()
    if n == 0:
        return RoiClassResult(
            0, np.zeros((0, 7)), np.zeros((0, 4)), np.zeros((0, 2)), lab_np,
            {k: np.zeros(lab_np.shape) for k in ("N", "C", "O17", "O18")},
            h_sums=np.zeros((0, 2)) if with_h else None,
            d_activity=np.zeros((0,)) if with_h else None,
        )
    keys = _SUM_ORDER + (("H1", "H2") if with_h else ())
    iso_stack = torch.as_tensor(np.stack([isotopes[k] for k in keys]).astype(np.float32),
                                device=labels.device)
    sums_t, cents_t = roi_sums_and_centroids(labels, iso_stack, n, acq)
    sums = sums_t.cpu().numpy()
    h_sums = d_activity = None
    if with_h:
        h_sums = sums[:, 7:9]
        with np.errstate(invalid="ignore", divide="ignore"):
            d_activity = h_sums[:, 1] / (h_sums[:, 0] + h_sums[:, 1])
        sums = sums[:, :7]
    c12, c13, n14, n15, o16, o17, o18 = (sums[:, i] for i in range(7))
    with np.errstate(invalid="ignore", divide="ignore"):
        acts = np.stack([c13 / (c13 + c12), n15 / (n14 + n15), o17 / (o18 + o17 + o16),
                         o18 / (o18 + o17 + o16)], axis=1)
    act_imgs = {}
    for name, col in zip(("C", "N", "O17", "O18"), range(4)):
        per_roi = np.concatenate([[0.0], acts[:, col]])
        act_imgs[name] = per_roi[np.clip(lab_np, 0, n)]
    return RoiClassResult(
        num_rois=n, sums=sums, activities=acts,
        positions=cents_t.cpu().numpy().astype(np.float64), labels=lab_np,
        activity_images=act_imgs, h_sums=h_sums, d_activity=d_activity,
    )


@dataclasses.dataclass
class NanoSIMSResult:
    red: RoiClassResult
    green: RoiClassResult
    all_data: np.ndarray  # [R_red+R_green, 17] (ref :154/:218 row layout)
    data_xy: np.ndarray  # all_data + (x, y)
    nearest: Optional[np.ndarray]  # µm-converted nearest-other-class distance
    activity_images: Dict[str, np.ndarray]  # combined red+green act maps
    # the content-cropped painted ROI image the analysis ran on (ref .m:83-85
    # imcrop), reused by the figures so the crop happens once
    rois_cropped: Optional[np.ndarray] = None


def _data_rows(cls_id: int, res: RoiClassResult) -> np.ndarray:
    n = res.num_rois
    if n == 0:
        return np.zeros((0, 17))
    idx = np.arange(1, n + 1, dtype=np.float64)
    return np.column_stack([np.full(n, cls_id, np.float64), idx, res.sums, res.activities,
                            res.activities * 100.0])


def _min_dists(a: np.ndarray, b: np.ndarray, dev: torch.device) -> np.ndarray:
    """Each row of ``a`` [N, 2]'s least float32 distance to a row of ``b``."""
    at = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    bt = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    valid = torch.ones(bt.shape[0], dtype=torch.bool, device=dev)
    return min_dist_to_set(at, bt, valid).cpu().numpy()


def analyze_nanosims(isotopes: Dict[str, np.ndarray], rois_rgb: np.ndarray,
                     cfg: NanoSIMSConfig = NanoSIMSConfig(), device="cuda") -> NanoSIMSResult:
    """The ROI workflow of ref :82-268 (figures aside) on ``device``."""
    dev = _device(device)
    rois = crop_to_content(rois_rgb, imcrop_rect=cfg.compat_imcrop_rect)
    red_mask, green_mask = class_masks(rois)
    red = analyze_roi_class(red_mask, isotopes, cfg, dev)
    green = analyze_roi_class(green_mask, isotopes, cfg, dev)
    return combine_classes(red, green, rois, cfg, dev)


def combine_classes(red: RoiClassResult, green: RoiClassResult, rois: np.ndarray,
                    cfg: NanoSIMSConfig = NanoSIMSConfig(), device="cuda") -> NanoSIMSResult:
    """The data rows of both classes, the nearest-other-class distances (on
    ``device``) and the combined activity maps."""
    dev = _device(device)
    all_data = np.vstack([_data_rows(1, red), _data_rows(2, green)])
    xy = np.vstack([red.positions, green.positions])
    data_xy = np.column_stack([all_data, xy]) if len(all_data) else np.zeros((0, 19))

    nearest = None
    if red.num_rois and green.num_rois:
        # ref :265-268: the µm conversion hardcodes 512 px whatever the size
        nearest = np.concatenate([_min_dists(red.positions, green.positions, dev),
                                  _min_dists(green.positions, red.positions, dev)]) / (
            cfg.distance_size_px / cfg.raster_um)
    elif red.num_rois or green.num_rois:
        # one painted class only: no other-class neighbour, NaN per ROI keeps
        # data_dist_nearest.csv written and the bound CSV at 19 columns
        nearest = np.full((red.num_rois + green.num_rois,), np.nan)

    if cfg.compat_green_o_bug:
        # ref :210-213: the green loop accumulates its O17/O18 maps into the
        # RED images; the combined maps are unchanged
        for name in ("O17", "O18"):
            red.activity_images[name] = red.activity_images[name] + green.activity_images[name]
            green.activity_images[name] = np.zeros_like(green.activity_images[name])
    act_imgs = {name: red.activity_images[name] + green.activity_images[name]
                for name in ("N", "C", "O17", "O18")}
    return NanoSIMSResult(red=red, green=green, all_data=all_data, data_xy=data_xy,
                          nearest=nearest, activity_images=act_imgs, rois_cropped=rois)


def boundary_distances(result: NanoSIMSResult, bound_rgb_cropped: np.ndarray,
                       acquisition_size: int, cfg: NanoSIMSConfig = NanoSIMSConfig(),
                       bound_mask: Optional[np.ndarray] = None, device="cuda") -> np.ndarray:
    """Least distance from each ROI to the painted aggregate boundary, µm
    (ref :270-309).

    The script compares acquisition-space (x, y) centroids with
    painted-space (row, col) boundary pixels; like the JAX package, this
    maps the boundary pixels into acquisition space with imresize's
    half-pixel scaling and compares (x, y) with (x, y).  ``bound_rgb_cropped``
    is the boundary image already cropped by ``crop_to_content``;
    ``acquisition_size`` the side of the cropped isotope planes."""
    dev = _device(device)
    red = bound_mask if bound_mask is not None else boundary_class_mask(bound_rgb_cropped)
    bd = boundary_mask(torch.as_tensor(np.asarray(red), device=dev)).cpu().numpy()
    ys, xs = np.nonzero(bd)
    if len(ys) == 0:
        return np.full((result.red.num_rois + result.green.num_rois,), np.inf)
    hp, wp = red.shape
    # half-pixel-centre mapping into acquisition space, 1-based like the
    # ROI centroids
    x_acq = (xs + 0.5) * (acquisition_size / wp) - 0.5 + 1.0
    y_acq = (ys + 0.5) * (acquisition_size / hp) - 0.5 + 1.0
    all_pos = np.vstack([result.red.positions, result.green.positions])
    dmin = _min_dists(all_pos, np.stack([x_acq, y_acq], axis=1), dev)
    return dmin / (cfg.distance_size_px / cfg.raster_um)


def write_csvs(result: NanoSIMSResult, out_dir: str,
               bound_dist: Optional[np.ndarray] = None) -> None:
    """data.csv, data_xy.csv, data_deuterium.csv (a deuterium acquisition:
    class, i, 1H, 2H, Dact, Dact·100, an extra file so data.csv keeps its
    layout), data_dist_nearest.csv and, given the boundary distances,
    data_dist_nearest_bound.csv (ref :237,:256,:268,:309)."""
    from particle_col_image_segmentation_tpu_torch.report.csvio import write_matrix_csv

    write_matrix_csv(os.path.join(out_dir, "data.csv"), result.all_data)
    write_matrix_csv(os.path.join(out_dir, "data_xy.csv"), result.data_xy)
    if result.red.h_sums is not None:
        rows = [[cls_id, i + 1, res.h_sums[i, 0], res.h_sums[i, 1], res.d_activity[i],
                 res.d_activity[i] * 100.0]
                for cls_id, res in ((1, result.red), (2, result.green))
                for i in range(res.num_rois)]
        write_matrix_csv(os.path.join(out_dir, "data_deuterium.csv"),
                         np.asarray(rows, np.float64).reshape(-1, 6))
    base = result.all_data
    if result.nearest is not None:
        base = np.column_stack([result.all_data, result.nearest])
        write_matrix_csv(os.path.join(out_dir, "data_dist_nearest.csv"), base)
    if bound_dist is not None:
        write_matrix_csv(os.path.join(out_dir, "data_dist_nearest_bound.csv"),
                         np.column_stack([base, bound_dist]))


def run_nanosims(mat_folder: str, rois_png: str, bound_png: Optional[str] = None,
                 out_dir: str = ".", cfg: NanoSIMSConfig = NanoSIMSConfig(),
                 make_figures: bool = True, device="cuda") -> NanoSIMSResult:
    """End-to-end NanoSIMS driver on ``device`` (default the card, ``cuda``;
    ``"cpu"`` runs the plain versions): load the .mat images and painted
    PNGs, write the CSVs (``write_csvs``) and, with ``make_figures``, the
    reference's figures (which need matplotlib)."""
    from PIL import Image

    dev = _device(device)
    isotopes = load_isotope_mats(mat_folder)
    rois_rgb = np.asarray(Image.open(rois_png).convert("RGB"))
    result = analyze_nanosims(isotopes, rois_rgb, cfg, dev)
    bound_mask_img = bound_rgb_cropped = bd = None
    if bound_png is not None:
        bound_rgb = np.asarray(Image.open(bound_png).convert("RGB"))
        acq = next(iter(isotopes.values())).shape[0]
        bound_rgb_cropped = crop_to_content(bound_rgb, imcrop_rect=cfg.compat_imcrop_rect)
        # one mask for the distances and the figure
        bound_mask_img = boundary_class_mask(bound_rgb_cropped)
        bd = boundary_distances(result, bound_rgb_cropped, acq, cfg, bound_mask=bound_mask_img,
                                device=dev)
    write_csvs(result, out_dir, bd)
    if make_figures:
        from particle_col_image_segmentation_tpu_torch.viz.nanosims_figures import save_all

        save_all(result, result.rois_cropped, to_uint8_display(isotopes["N14C12"]), out_dir,
                 bound_mask=bound_mask_img, bound_rgb=bound_rgb_cropped)
    return result
