"""NanoSIMS figures (reference .m export_fig outputs), host-side matplotlib.

The port's copy of ``particle_col_image_segmentation_tpu/viz/
nanosims_figures.py``; the aggregate boundary comes from the port's
``ops.boundary_mask``.

Counterparts: rois_clear.png + rois_clear.svg (:87-89), annotations.png
(:236 — ROI indices drawn at centroids), "cell position.png" (:246-250 —
red/green centroid scatter over the N14C12 display image),
bound_paint_clear.png (:277 — the cropped painted boundary image),
agg_boundary.png (:294-297 — aggregate boundary overlay).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def save_rois_figure(rois_rgb: np.ndarray, out_path: str) -> plt.Figure:
    """The cropped painted-ROI image, exported as PNG and (when out_path
    ends in .png) the reference's sibling SVG too (reference :87-89)."""
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(rois_rgb)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=300)
    if out_path.endswith(".png"):
        fig.savefig(out_path[:-4] + ".svg", bbox_inches="tight")
    plt.close(fig)
    return fig


def save_bound_paint_figure(bound_rgb: np.ndarray, out_path: str) -> plt.Figure:
    """The cropped painted boundary image (reference :271-277)."""
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(bound_rgb)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return fig


def save_annotations_figure(result, rois_rgb: np.ndarray, out_path: str) -> plt.Figure:
    """Painted ROIs with per-ROI indices at painted-space centroids
    (reference :167-169, :231-233, :236)."""
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(rois_rgb)
    for cls in (result.red, result.green):
        lab = np.asarray(cls.labels).ravel()
        n = cls.num_rois
        if n == 0:
            continue
        # one bincount pass for all centroids (a per-ROI nonzero scan is
        # O(R·H·W) — hundreds of full-image passes just to place text)
        H, W = np.asarray(cls.labels).shape
        cnt = np.bincount(lab, minlength=n + 1)
        ys = np.bincount(lab, weights=np.repeat(np.arange(H), W), minlength=n + 1)
        xs = np.bincount(lab, weights=np.tile(np.arange(W), H), minlength=n + 1)
        for i in range(1, n + 1):
            if cnt[i]:
                ax.text(xs[i] / cnt[i], ys[i] / cnt[i], str(i), fontsize=6,
                        color="w")
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return fig


def save_cell_position_figure(
    result, n14c12_img: np.ndarray, out_path: str
) -> plt.Figure:
    """Red/green ROI centroids over the N14C12 display image
    (reference :246-250)."""
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(n14c12_img, cmap="gray")
    if result.red.num_rois:
        ax.scatter(
            result.red.positions[:, 0] - 1, result.red.positions[:, 1] - 1,
            marker=".", c="r",
        )
    if result.green.num_rois:
        ax.scatter(
            result.green.positions[:, 0] - 1, result.green.positions[:, 1] - 1,
            marker=".", c="g",
        )
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return fig


def save_boundary_figure(
    bound_mask: np.ndarray, n14c12_img: np.ndarray, out_path: str
) -> plt.Figure:
    """Aggregate boundary over the N14C12 display image (reference :294-297)."""
    import torch

    from particle_col_image_segmentation_tpu_torch.ops.morphology import boundary_mask

    bd = boundary_mask(torch.from_numpy(np.asarray(bound_mask))).numpy()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(n14c12_img, cmap="gray")
    ys, xs = np.nonzero(bd)
    hp, wp = bound_mask.shape
    hi, wi = n14c12_img.shape
    ax.scatter(xs * (wi / wp), ys * (hi / hp), s=0.5, c="r")
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return fig


def save_all(
    result,
    rois_rgb: np.ndarray,
    n14c12_img: np.ndarray,
    out_dir: str,
    bound_mask: Optional[np.ndarray] = None,
    bound_rgb: Optional[np.ndarray] = None,
) -> None:
    save_rois_figure(rois_rgb, os.path.join(out_dir, "rois_clear.png"))
    save_annotations_figure(result, rois_rgb, os.path.join(out_dir, "annotations.png"))
    save_cell_position_figure(
        result, n14c12_img, os.path.join(out_dir, "cell position.png")
    )
    if bound_rgb is not None:
        save_bound_paint_figure(
            bound_rgb, os.path.join(out_dir, "bound_paint_clear.png")
        )
    if bound_mask is not None:
        save_boundary_figure(
            bound_mask, n14c12_img, os.path.join(out_dir, "agg_boundary.png")
        )
