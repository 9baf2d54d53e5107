"""CSV writers with the reference's exact output contract.

Schemas, rounding, and row ordering match tiff_analysis.py:1047-1107
byte-for-byte (including the quirk that single-cell areas are rounded to 5 dp
while cluster areas are written unrounded, :1057 vs :1063); the NanoSIMS
matrices are MATLAB csvwrite's (``write_matrix_csv``).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig, DEFAULT_CONFIG


def write_cell_position_info(
    cell_positions: Dict[str, list],
    cell_clusters: Dict[str, list],
    csv_output_file: str,
    particle_area: float,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
) -> None:
    """Per-cell / per-cluster positions (reference :1047-1063).

    Header: strain, cell_type, x_pos, y_pos, cell_area, cell_area_ratio,
    cell_count.  x = centroid col, y = centroid row (2 dp); areas µm²
    (cells 5 dp, clusters unrounded); ratio 8 dp; count 1 for cells,
    estimated ``cells`` for clusters.
    """
    conv = cfg.px_to_um**2
    particle_area = particle_area / conv
    with open(csv_output_file, "w") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["strain", "cell_type", "x_pos", "y_pos", "cell_area", "cell_area_ratio", "cell_count"]
        )
        for strain_type, pos in cell_positions.items():
            for p in pos:
                c = p.centroid
                area = p.area / conv
                writer.writerow(
                    [
                        strain_type,
                        "cell",
                        round(c[1], 2),
                        round(c[0], 2),
                        round(area, 5),
                        round(area / particle_area, 8),
                        1,
                    ]
                )
        for strain_type, cluster in cell_clusters.items():
            for c in cluster:
                pos_c = c.centroid
                area = c.area / conv
                writer.writerow(
                    [
                        strain_type,
                        "cluster",
                        round(pos_c[1], 2),
                        round(pos_c[0], 2),
                        area,
                        round(area / particle_area, 8),
                        c.cells,
                    ]
                )


def write_merged_cell_position_info(
    merged_clusters: Dict[str, List[dict]],
    csv_output_file: str,
    particle_area: float,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
) -> None:
    """Merged-group positions (reference :1065-1075).

    Header: strain_type, x_pos, y_pos, cell_area, cell_area_ratio, cell_num;
    one row per merged group, cell_num = number of member regions.
    """
    conv = cfg.px_to_um**2
    particle_area = particle_area / conv
    with open(csv_output_file, "w") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["strain_type", "x_pos", "y_pos", "cell_area", "cell_area_ratio", "cell_num"]
        )
        for strain_type, groups in merged_clusters.items():
            for p in groups:
                c = p["centroid"]
                area = p["area"] / conv
                writer.writerow(
                    [
                        strain_type,
                        round(c[1], 2),
                        round(c[0], 2),
                        round(area, 5),
                        round(area / particle_area, 8),
                        len(p["regions"]),
                    ]
                )


def write_matrix_csv(csv_output_file: str, matrix, precision: str = "%.5g") -> None:
    """MATLAB csvwrite/dlmwrite parity: headerless comma-separated matrix,
    default 5 significant digits (reference .m:237,256,268,309)."""
    import numpy as np

    with open(csv_output_file, "w") as f:
        for row in np.atleast_2d(np.asarray(matrix)):
            f.write(",".join(precision % v for v in row))
            f.write("\n")


def write_density_info(
    csv_output_file: str,
    h5_folder: str,
    cell_density: Dict[str, float],
    cell_area_ratio: Dict[str, float],
    cell_count: Dict[str, int],
) -> None:
    """Append-style density bookkeeping with read-modify-rewrite dedup by
    folder (reference :1078-1107): re-processing a folder replaces its rows
    instead of duplicating them — the reference's only resume-adjacent
    behavior (SURVEY.md §5)."""
    header = ["folder", "strain", "cell_density", "cell_area_ratio", "cell_count"]
    existing_data = []
    if os.path.exists(csv_output_file):
        with open(csv_output_file, "r") as f:
            reader = csv.reader(f)
            next(reader, None)
            existing_data = [
                row for row in reader if row and row[0] != h5_folder
            ]
    # one atomic replace: the old rewrite-then-append left a window where a
    # crash had already deleted the folder's previous rows but not yet
    # written the new ones
    tmp = csv_output_file + ".tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(existing_data)
        for strain in cell_density:
            writer.writerow(
                [h5_folder, strain, cell_density[strain], cell_area_ratio[strain], cell_count[strain]]
            )
    os.replace(tmp, csv_output_file)
