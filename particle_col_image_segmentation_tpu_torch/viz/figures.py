"""Parity figures (host-side matplotlib, PNG dpi=300).

Reference counterparts: tiff_analysis.py:346-522 (channel/single/fused
plots), :290-343 (DAPI overlap), :885-928 (original vs merged).  Layouts,
titles, marker styles, legends, and output naming match; the reference's
in-place mutation of its input in visualize_dapi_overlap_results (:321,
SURVEY §2.6) is not reproduced — we overlay on a copy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import colors  # noqa: E402
from matplotlib.patches import Rectangle  # noqa: E402

from particle_col_image_segmentation_tpu_torch.config import CMAP  # noqa: E402


def get_color_map(cell_type_map: Dict[int, str]):
    """ListedColormap + BoundaryNorm with bounds at class value ± 0.5
    (reference :715-724)."""
    cell_colors = [CMAP[name] for name in cell_type_map.values()]
    bounds = [num - 0.5 for num in cell_type_map]
    bounds.append(len(cell_type_map) + 0.5)
    cmap = colors.ListedColormap(cell_colors)
    norm = colors.BoundaryNorm(bounds, cmap.N)
    return cmap, norm


def _legend_elements(include_markers: bool = True):
    elements = [
        plt.Rectangle((0, 0), 1, 1, facecolor=color, label=cell_type)
        for cell_type, color in CMAP.items()
        if cell_type != "Background"
    ]
    if include_markers:
        for label, face in (("single cells", "white"), ("aggregates", "red")):
            elements.append(
                plt.Line2D(
                    [0], [0], marker=".", color="w", markerfacecolor=face,
                    markeredgecolor="black", label=label, markersize=10,
                )
            )
    return elements


def _scatter_regions(ax, cell_positions, cell_clusters):
    if cell_positions and any(cell_positions.values()):
        pts = np.array(
            [p.centroid for regions in cell_positions.values() for p in regions]
        )
        if len(pts):
            ax.scatter(pts[:, 1], pts[:, 0], s=3, c="white", marker=".")
    if cell_clusters and any(cell_clusters.values()):
        pts = np.array(
            [p.centroid for regions in cell_clusters.values() for p in regions]
        )
        if len(pts):
            ax.scatter(pts[:, 1], pts[:, 0], s=10, c="red", marker=".")


def _quad_figure(
    raw_arr, cmap, norm, base_name, output_name, denoised_arr, overlap_arr,
    cell_positions, cell_clusters, three_panel_when_no_overlap: bool,
):
    fig = plt.figure(figsize=(16, 16))
    if overlap_arr is None and three_panel_when_no_overlap:
        gs = plt.GridSpec(2, 2, height_ratios=[1, 1])
        ax00 = fig.add_subplot(gs[0, 0])
        ax01 = fig.add_subplot(gs[0, 1])
        ax10 = fig.add_subplot(gs[1, :])
        ax11 = None
    else:
        axes = fig.subplots(2, 2)
        (ax00, ax01), (ax10, ax11) = axes
    fig.suptitle(base_name, fontsize=20, y=0.98)
    plt.subplots_adjust(top=0.9)

    ax00.imshow(raw_arr, cmap=cmap, norm=norm)
    ax00.set_title("Raw segmentation")
    ax01.imshow(denoised_arr, cmap=cmap, norm=norm)
    ax01.set_title("Denoised image")
    ax10.imshow(denoised_arr, cmap=cmap, norm=norm)
    ax10.set_title("Cell positions")
    _scatter_regions(ax10, cell_positions, cell_clusters)
    if overlap_arr is not None and ax11 is not None:
        ax11.imshow(overlap_arr, cmap=cmap, norm=norm)
        ax11.set_title("Particle Area")

    fig.legend(
        handles=_legend_elements(), loc="center", bbox_to_anchor=(0.5, 0.02),
        ncol=len(_legend_elements()), frameon=False,
    )
    plt.tight_layout()
    plt.subplots_adjust(top=0.95, bottom=0.05)
    plt.savefig(f"{output_name}_plots.png", dpi=300)
    # close only OUR figure: close("all") would tear down figures a batch
    # caller is still composing in the same process
    plt.close(fig)
    return fig


def create_channel_plots(
    raw_arr, strain, cmap, norm, base_name, output_name, denoised_arr,
    overlap_arr=None, cell_positions=None, cell_clusters=None,
):
    """Per-channel 2×2 (or 3-panel) figure (reference :346-462).

    ``strain`` is accepted for reference signature parity but is
    behaviorally dead there too: the reference computes min_cell_area from
    it (:381) only for titles that are commented out (:384-401).
    """
    del strain
    return _quad_figure(
        raw_arr, cmap, norm, base_name, output_name, denoised_arr, overlap_arr,
        cell_positions, cell_clusters, three_panel_when_no_overlap=True,
    )


def create_single_plots(
    raw_arr, cmap, norm, base_name, output_name, denoised_arr, overlap_arr,
    cell_positions=None, cell_clusters=None,
):
    """Single-file 2×2 figure, always with the particle panel (reference :525-616)."""
    return _quad_figure(
        raw_arr, cmap, norm, base_name, output_name, denoised_arr, overlap_arr,
        cell_positions, cell_clusters, three_panel_when_no_overlap=False,
    )


def create_plot(
    ds_arr, cmap, norm, file_name, cell_positions=None, cell_clusters=None, title=None
):
    """Single-axis fused-image figure (reference :464-522)."""
    fig, ax = plt.subplots(figsize=(20, 20))
    ax.imshow(ds_arr, cmap=cmap, norm=norm, interpolation="None")
    if title is not None:
        ax.set_title(title, fontsize=20, pad=20)
    _scatter_regions(ax, cell_positions, cell_clusters)
    fig.legend(
        handles=_legend_elements(), loc="center", bbox_to_anchor=(0.5, 0.08),
        ncol=len(_legend_elements()), frameon=False,
    )
    fig.savefig(file_name, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return fig


def visualize_dapi_overlap_results(
    original_dapi, original_other, updated_dapi, cmap, norm, dapi_cmap, dapi_norm,
    base_name, output_name, other_channel_name,
):
    """2×2 DAPI-overlap figure (reference :290-343) — input arrays are NOT
    mutated (the reference overwrites original_rfp in place at :321)."""
    fig, axes = plt.subplots(2, 2, figsize=(20, 20))
    fig.suptitle(
        f"{base_name} DAPI-{other_channel_name} Overlap", fontsize=20, y=0.98
    )
    plt.subplots_adjust(top=0.8)

    axes[0, 0].imshow(original_dapi, cmap=dapi_cmap, norm=dapi_norm)
    axes[0, 0].set_title("Original DAPI")
    axes[0, 1].imshow(original_other, cmap=cmap, norm=norm)
    axes[0, 1].set_title(f"Original {other_channel_name}")

    overlay = np.array(original_other, copy=True)
    overlay[np.asarray(original_dapi) == 1] = 2
    axes[1, 0].imshow(overlay, cmap=cmap, norm=norm)
    axes[1, 0].set_title(f"DAPI overlaid with {other_channel_name}")
    axes[1, 1].imshow(updated_dapi, cmap=dapi_cmap, norm=dapi_norm)
    axes[1, 1].set_title("Updated DAPI")

    handles = _legend_elements(include_markers=False)
    fig.legend(
        handles=handles, loc="center", bbox_to_anchor=(0.5, 0.02),
        ncol=len(handles), frameon=False,
    )
    plt.tight_layout()
    plt.subplots_adjust(top=0.95, bottom=0.05)
    plt.savefig(f"{output_name}_dapi_{other_channel_name}_overlap.png", dpi=300)
    plt.close(fig)
    return fig


def plot_original_vs_merged(
    original_image,
    merged_regions: Dict[str, List[dict]],
    cell_clusters,
    cell_types: Dict[int, str],
    title_name: str,
    base_name: str,
):
    """Per-strain + combined panels with cluster (orange) and multi-region
    merged-group (green) bboxes (reference :885-928)."""
    n = len(merged_regions)
    rows = 2 if n > 2 else 1
    if n <= 2:
        fig, axes = plt.subplots(1, max(n, 1), figsize=(16, 16))
        axes = np.atleast_1d(axes)
    elif n == 3:
        fig = plt.figure(figsize=(16, 16))
        gs = plt.GridSpec(2, 2, height_ratios=[1, 1])
        axes = np.array(
            [
                [fig.add_subplot(gs[0, 0]), fig.add_subplot(gs[0, 1])],
                [fig.add_subplot(gs[1, :]), None],
            ]
        )
    else:
        fig, axes = plt.subplots(2, 2, figsize=(16, 16))
    fig.suptitle(f"{title_name} Merged Cell Positions", fontsize=20, y=0.98)

    cmap, norm = get_color_map(cell_types)
    for i, (cell_type, regions) in enumerate(merged_regions.items()):
        ax = axes[i // 2, i % 2] if rows > 1 else axes[i]
        ax.imshow(original_image, cmap=cmap, norm=norm)
        ax.set_title(cell_type.title())
        for cluster in (cell_clusters or {}).get(cell_type, []):
            minr, minc, maxr, maxc = cluster.bbox
            ax.add_patch(
                Rectangle((minc, minr), maxc - minc, maxr - minr,
                          fill=False, edgecolor="orange", linewidth=0.5)
            )
        for region in regions:
            if len(region["regions"]) == 1:
                continue
            minr, minc, maxr, maxc = region["bbox"]
            ax.add_patch(
                Rectangle((minc, minr), maxc - minc, maxr - minr,
                          fill=False, edgecolor="green", linewidth=1)
            )
    plt.tight_layout()
    plt.subplots_adjust(top=0.95, bottom=0.05)
    plt.savefig(f"{base_name}_cell_cluster_pos.png", dpi=300)
    plt.close(fig)
    return fig
