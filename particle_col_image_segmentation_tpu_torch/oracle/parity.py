"""The field-by-field check of one analyzed plane against the oracle.

The port's counterpart of the JAX package's ``tests/parity.py``
(``assert_regions_equal``, ``assert_plane_parity``): one check body for the
CPU tests (``tests/test_torch_analysis.py``) and the card
(``chip_smoke.py``), so the two never drift apart in what they compare.
It takes the ``PlaneAnalysis`` already computed, on whichever device, and
runs the port's reference pipeline (``oracle.reference_pipeline``) on the
host.
"""

from __future__ import annotations

import numpy as np

from particle_col_image_segmentation_tpu_torch.oracle import reference_pipeline as rp


def assert_regions_equal(ours, ref, what: str = "regions") -> None:
    """Same regions in the same order: area, centroid (atol 1e-9), bbox."""
    if len(ours) != len(ref):
        raise AssertionError(f"{what}: {len(ours)} regions, the oracle {len(ref)}")
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a.area != b.area or a.bbox != b.bbox:
            raise AssertionError(f"{what}[{i}]: area {a.area} bbox {a.bbox}, the oracle "
                                 f"area {b.area} bbox {b.bbox}")
        np.testing.assert_allclose(a.centroid, b.centroid, rtol=0, atol=1e-9,
                                   err_msg=f"{what}[{i}] centroid")


def assert_plane_parity(ours, img, cell_types, cfg) -> dict:
    """Hold ``ours`` (``analyze_plane(img, cell_types, cfg, merged=True)``)
    equal to the oracle: denoise, positions and clusters (area, centroid,
    bbox of each region), ``cluster.cells``, the merged groups with their
    member regions, the particle fill, and counts and densities.  Returns
    what was compared: {"regions": …, "groups": …, "counts": …}."""
    den = rp.denoise(img, cfg)
    np.testing.assert_array_equal(ours.denoised, den, err_msg="denoise")
    pos, clusters, particle_area, merged = rp.get_cell_positions_and_areas(
        den, cell_types, merged=True, cfg=cfg
    )
    if ours.particle_area != particle_area:
        raise AssertionError(f"particle area {ours.particle_area}, the oracle {particle_area}")
    if list(ours.cell_pos) != list(pos):
        raise AssertionError(f"strains {list(ours.cell_pos)}, the oracle {list(pos)}")
    n_regions = 0
    for k in pos:
        assert_regions_equal(ours.cell_pos[k], pos[k], f"cell_pos[{k}]")
        assert_regions_equal(ours.cell_clusters[k], clusters[k], f"cell_clusters[{k}]")
        cells = [c.cells for c in ours.cell_clusters[k]]
        if cells != [c.cells for c in clusters[k]]:
            raise AssertionError(f"cell_clusters[{k}] cells {cells} differ from the oracle's")
        n_regions += len(pos[k]) + len(clusters[k])

    if list(ours.merged_clusters) != list(merged):
        raise AssertionError(f"merge contexts {list(ours.merged_clusters)}, the oracle "
                             f"{list(merged)}")
    n_groups = 0
    for k in merged:
        if len(ours.merged_clusters[k]) != len(merged[k]):
            raise AssertionError(f"merged[{k}]: {len(ours.merged_clusters[k])} groups, the "
                                 f"oracle {len(merged[k])}")
        for i, (ga, gb) in enumerate(zip(ours.merged_clusters[k], merged[k])):
            if ga["area"] != gb["area"] or ga["bbox"] != gb["bbox"]:
                raise AssertionError(f"merged[{k}][{i}]: area {ga['area']} bbox {ga['bbox']}, "
                                     f"the oracle area {gb['area']} bbox {gb['bbox']}")
            np.testing.assert_allclose(ga["centroid"], gb["centroid"], atol=1e-9,
                                       err_msg=f"merged[{k}][{i}] centroid")
            assert_regions_equal(ga["regions"], gb["regions"], f"merged[{k}][{i}] regions")
        n_groups += len(merged[k])

    filled_ref, filled_area_ref = rp.recreate_particle_area(
        den.copy(), cell_types, particle_area, cfg
    )
    np.testing.assert_array_equal(ours.filled, filled_ref, err_msg="filled")
    if ours.filled_particle_area != filled_area_ref:
        raise AssertionError(f"filled particle area {ours.filled_particle_area}, the oracle "
                             f"{filled_area_ref}")

    ours_cnt = rp.get_cell_counts_and_densities(
        ours.cell_pos, ours.cell_clusters, particle_area, cfg
    )
    ref_cnt = rp.get_cell_counts_and_densities(pos, clusters, particle_area, cfg)
    if ours_cnt != ref_cnt:
        raise AssertionError(f"counts and densities {ours_cnt}, the oracle {ref_cnt}")
    return {"regions": n_regions, "groups": n_groups, "counts": ref_cnt[0]}
