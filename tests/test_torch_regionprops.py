"""Parity: the PyTorch port's region tables (the plain version behind K4)
against the JAX scatter path and the MXU Pallas kernel.

Inputs are made with numpy from a seed and handed to both packages; tables
are integers, so the tolerance is exact equality.  One known difference:
rows with ``area == 0`` hold class 0 in the port and in ``region_counts_mxu``
but INT32_MIN (segment_max's identity) on the JAX scatter path, so class
tables are compared against the scatter path only where ``area > 0``, and in
full against the MXU kernel (interpret mode, ``rows_per_chunk=8`` as in
``test_ops_core.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.regionprops import (
    region_counts as jax_region_counts,
)
from particle_col_image_segmentation_tpu.ops.regionprops_tiles import (
    region_counts_mxu,
)
from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_counts
from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (
    region_counts_auto,
    region_counts_cuda,
)

I32_MAX, I32_MIN = 2**31 - 1, -(2**31)


def _case(lo_val, hi_val, seed):
    """Ids in [-3, R+9) — negative and past-capacity ids included — over a
    64×256 plane, values homogeneous per id (as every CCL component is)."""
    rng = np.random.default_rng(seed)
    R = 700
    seg = rng.integers(-3, R + 9, (64, 256)).astype(np.int32)
    cls_of = rng.integers(lo_val, hi_val, R + 16).astype(np.int32)
    img = cls_of[np.clip(seg, 0, None)]
    return seg, img, R - 1


@pytest.mark.parametrize("val_bound", [None, 7])
def test_region_counts_matches_jax_and_mxu(val_bound):
    if val_bound is None:  # signed values over the MXU path's full range
        seg, img, max_regions = _case(-16384, 16384, seed=5)
    else:
        seg, img, max_regions = _case(0, 8, seed=6)
    area, cls = region_counts(torch.from_numpy(seg), torch.from_numpy(img), max_regions)
    area, cls = area.numpy(), cls.numpy()
    assert area.shape == cls.shape == (max_regions + 1,)
    assert area.dtype == cls.dtype == np.int32
    a0, c0 = jax_region_counts(jnp.asarray(seg), jnp.asarray(img), max_regions)
    np.testing.assert_array_equal(area, np.asarray(a0))
    valid = area > 0
    np.testing.assert_array_equal(cls[valid], np.asarray(c0)[valid])
    a1, c1 = region_counts_mxu(
        jnp.asarray(seg), jnp.asarray(img), max_regions, rows_per_chunk=8,
        interpret=True, val_bound=val_bound,
    )
    np.testing.assert_array_equal(area, np.asarray(a1))
    np.testing.assert_array_equal(cls, np.asarray(c1))
    assert (cls[~valid] == 0).all()


def test_region_counts_batched_matches_mxu():
    seg, img, max_regions = _case(0, 8, seed=7)
    seg2, img2 = np.stack([seg, seg[::-1]]), np.stack([img, img[::-1] // 2])
    area, cls = region_counts(torch.from_numpy(seg2), torch.from_numpy(img2), max_regions)
    assert area.shape == (2, max_regions + 1)
    a1, c1 = region_counts_mxu(
        jnp.asarray(seg2), jnp.asarray(img2), max_regions, rows_per_chunk=8,
        interpret=True,
    )
    np.testing.assert_array_equal(area.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(c1))


def test_saturating_sum_matches_mxu():
    """One 320×512 region of 16383 sums to 5.4e9 and of -16384 to -5.4e9:
    both saturate to the int32 range before the division, as in the TPU
    kernel's _recombine_saturating."""
    seg = np.zeros((2, 320, 512), np.int32)
    seg[:, :, 500:] = 1
    img = np.full((2, 320, 512), 16383, np.int32)
    img[1] = -16384
    area, cls = region_counts(torch.from_numpy(seg), torch.from_numpy(img), 4)
    a1, c1 = region_counts_mxu(
        jnp.asarray(seg), jnp.asarray(img), 4, rows_per_chunk=64, interpret=True,
    )
    np.testing.assert_array_equal(area.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(c1))
    n0 = 320 * 500
    assert cls[0, 0] == I32_MAX // n0 and cls[1, 0] == I32_MIN // n0
    assert cls[0, 1] == 16383 and cls[1, 1] == -16384


@pytest.mark.parametrize("wrapper", ["counts", "sums"])
def test_one_hot_bin_matches_mxu(wrapper):
    """K4's hot bin: one id over whole uint8 planes at 255 (and one plane of
    id 0 at 0), through both plain wrappers against the MXU kernel."""
    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import region_sums_mxu

    from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_sums

    seg = np.ones((2, 256, 384), np.int32)
    seg[1] = 0
    img = np.full(seg.shape, 255, np.uint8)
    img[1] = 0
    plain, mxu = ((region_counts, region_counts_mxu) if wrapper == "counts"
                  else (region_sums, region_sums_mxu))
    area, col = plain(torch.from_numpy(seg), torch.from_numpy(img), 8)
    a1, c1 = mxu(jnp.asarray(seg), jnp.asarray(img), 8, rows_per_chunk=64, interpret=True)
    np.testing.assert_array_equal(area.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(col.numpy(), np.asarray(c1))
    assert area[0, 1] == area[1, 0] == 256 * 384
    assert col[0, 1] == (255 if wrapper == "counts" else 255 * 256 * 384)


def test_saturating_region_sums_match_mxu():
    """region_sums saturates Σvals to the int32 range, as region_sums_mxu's
    _recombine_saturating does: 16383 and -16384 over 160000 px."""
    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import region_sums_mxu

    from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_sums

    seg = np.zeros((2, 320, 512), np.int32)
    seg[:, :, 500:] = 1
    vals = np.full((2, 320, 512), 16383, np.int32)
    vals[1] = -16384
    area, vsum = region_sums(torch.from_numpy(seg), torch.from_numpy(vals), 4)
    a1, v1 = region_sums_mxu(jnp.asarray(seg), jnp.asarray(vals), 4, rows_per_chunk=64,
                             interpret=True)
    np.testing.assert_array_equal(area.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(vsum.numpy(), np.asarray(v1))
    assert vsum[0, 0] == I32_MAX and vsum[1, 0] == I32_MIN
    assert vsum[0, 1] == 16383 * 320 * 12 and vsum[1, 1] == -16384 * 320 * 12


def test_auto_takes_plain_on_cpu_and_wrapper_refuses_cpu():
    seg, img, max_regions = _case(0, 8, seed=8)
    seg_t, img_t = torch.from_numpy(seg), torch.from_numpy(img.astype(np.uint8))
    before = region_counts_cuda.launches
    got = region_counts_auto(seg_t, img_t, max_regions, val_bound=7)
    want = region_counts(seg_t, img_t, max_regions)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert region_counts_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        region_counts_cuda(seg_t, img_t, max_regions)


# ---- the full RegionTable (K5's plain version), sums and lookup (K6) ----


def _components(shape, seed, max_regions):
    """Compact ids and the class plane of synthetic label planes, labelled by
    the JAX package's scatter path (so both packages see the same ids)."""
    from particle_col_image_segmentation_tpu.ops.ccl import label_image

    from fixtures import synthetic_label_plane

    B = int(np.prod(shape[:-2]))
    img = np.stack([
        synthetic_label_plane(seed=seed + b, shape=(192, 192))[: shape[-2], : shape[-1]]
        for b in range(B)
    ]).reshape(shape).astype(np.uint8)
    seg = np.stack([
        np.asarray(label_image(jnp.asarray(p), max_regions=max_regions)[0])
        for p in img.reshape((B,) + shape[-2:])
    ]).reshape(shape).astype(np.int32)
    return seg, img


def _assert_tables_equal(got, want, masked_by_valid=True):
    """Columns as numpy; ``area`` on every row, the rest on valid rows (the
    JAX scatter path holds segment-max identities on empty rows)."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name == "area" or not masked_by_valid:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_array_equal(g[valid], w[valid], err_msg=name)


@pytest.mark.parametrize("shape,max_regions", [((96, 128), 512), ((2, 64, 160), 4096)])
def test_region_props_matches_jax_scatter_and_mxu(shape, max_regions):
    from particle_col_image_segmentation_tpu.ops.regionprops import (
        region_props as jax_region_props,
    )
    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import (
        region_table_mxu,
    )

    from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_props

    seg, img = _components(shape, seed=9, max_regions=max_regions)
    got = region_props(torch.from_numpy(seg), torch.from_numpy(img), max_regions)
    assert got.area.shape == shape[:-2] + (max_regions + 1,)
    assert got.bbox.shape == shape[:-2] + (max_regions + 1, 4)
    assert all(t.dtype == torch.int32 for t in got[:-1]) and got.valid.dtype == torch.bool
    segs, imgs = seg.reshape((-1,) + shape[-2:]), img.reshape((-1,) + shape[-2:])
    for b in range(segs.shape[0]):
        want = jax_region_props(jnp.asarray(segs[b]), jnp.asarray(imgs[b]), max_regions)
        plane = type(got)(*(t.reshape((-1,) + t.shape[len(shape) - 2:])[b] for t in got))
        _assert_tables_equal(plane, want)
    mxu = region_table_mxu(jnp.asarray(seg), jnp.asarray(img), max_regions,
                           rows_per_chunk=8, interpret=True)
    _assert_tables_equal(got, mxu)
    # empty rows: zeros in every column, bbox included
    empty = ~got.valid.numpy()
    assert (got.bbox.numpy()[empty] == 0).all() and (got.sr_lo.numpy()[empty] == 0).all()


def test_region_props_digit_sums_are_not_a_split_of_the_total():
    """One region over rows 0..255 of a 256x1 plane: Σ(r % 128) = 2·8128,
    far past 127 — the digits are summed on their own, as in the JAX table."""
    from particle_col_image_segmentation_tpu.ops.regionprops import (
        region_props as jax_region_props,
    )

    from particle_col_image_segmentation_tpu_torch.ops.regionprops import (
        HILO_BASE,
        centroids_int,
        region_props,
    )

    seg = np.ones((256, 1), np.int32)
    got = region_props(torch.from_numpy(seg), torch.from_numpy(seg), 4)
    want = jax_region_props(jnp.asarray(seg), jnp.asarray(seg), 4)
    _assert_tables_equal(got, want)
    assert int(got.sr_hi[1]) == 128 and int(got.sr_lo[1]) == 2 * 8128
    assert HILO_BASE * int(got.sr_hi[1]) + int(got.sr_lo[1]) == sum(range(256))
    icy, icx = centroids_int(got)
    assert int(icy[1]) == 127 and int(icx[1]) == 0


def test_centroids_match_jax():
    from particle_col_image_segmentation_tpu.ops.regionprops import (
        centroids_f64 as jax_centroids_f64,
        centroids_int as jax_centroids_int,
        region_props as jax_region_props,
    )

    from particle_col_image_segmentation_tpu_torch.ops.regionprops import (
        centroids_f64,
        centroids_int,
        region_props,
    )

    seg, img = _components((128, 96), seed=12, max_regions=1024)
    got = region_props(torch.from_numpy(seg), torch.from_numpy(img), 1024)
    want = jax_region_props(jnp.asarray(seg), jnp.asarray(img), 1024)
    for g, w in zip(centroids_int(got), jax_centroids_int(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    host = type(got)(*(t.numpy() for t in got))
    for g, w in zip(centroids_f64(host), jax_centroids_f64(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("val_bound", [None, 1])
def test_region_sums_matches_mxu(val_bound):
    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import region_sums_mxu

    from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_sums

    rng = np.random.default_rng(13)
    seg = rng.integers(-2, 300, (2, 64, 128)).astype(np.int32)
    hi = 2 if val_bound == 1 else 16384
    vals = rng.integers(0 if val_bound == 1 else -16384, hi, seg.shape).astype(np.int32)
    area, vsum = region_sums(torch.from_numpy(seg), torch.from_numpy(vals), 255)
    a1, v1 = region_sums_mxu(jnp.asarray(seg), jnp.asarray(vals), 255,
                             rows_per_chunk=8, interpret=True, val_bound=val_bound)
    np.testing.assert_array_equal(area.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(vsum.numpy(), np.asarray(v1))
    assert vsum.dtype == torch.int32


@pytest.mark.parametrize("batched_table", [False, True])
def test_table_lookup_matches_mxu_and_auto(batched_table):
    """Ids -1, 0, R-1, R and 2R; table values 0 and 255; [R] and [B,R]."""
    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import (
        table_lookup_auto as jax_lookup_auto,
        table_lookup_mxu,
    )

    from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (
        table_lookup,
        table_lookup_auto,
        table_lookup_cuda,
    )

    rng = np.random.default_rng(14)
    R = 600
    seg = rng.integers(-1, R + 5, (2, 32, 128)).astype(np.int32)
    seg[:, 0, :5] = [-1, 0, R - 1, R, 2 * R]
    shape = (2, R) if batched_table else (R,)
    tab = rng.integers(0, 256, shape).astype(np.int32)
    tab[..., 0], tab[..., R - 1] = 255, 0
    before = table_lookup_cuda.launches
    got = table_lookup_auto(torch.from_numpy(seg), torch.from_numpy(tab))
    assert table_lookup_cuda.launches == before
    assert got.dtype == torch.int32
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(table_lookup_mxu(jnp.asarray(seg), jnp.asarray(tab),
                                         rows_per_chunk=8, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_lookup_auto(jnp.asarray(seg), jnp.asarray(tab))))
    row0 = tab[0] if batched_table else tab
    assert got[0, 0, :5].tolist() == [0, 255, 0, 0, 0] and got[0, 0, 2] == row0[R - 1]
    if not batched_table:
        np.testing.assert_array_equal(
            table_lookup(torch.from_numpy(seg[0]), torch.from_numpy(tab)).numpy(), got[0])
    with pytest.raises(ValueError, match="table"):
        table_lookup(torch.from_numpy(seg[0]), torch.from_numpy(np.zeros((2, R), np.int32)))


def test_table_lookup_edges_match_jax():
    """The plain K6 on chip_smoke.k6_inputs (ids and table values at INT32_MIN
    and INT32_MAX, R = 1 to 40000, [R] and [B,R] tables, H*W not a multiple
    of 4, B = 64) equals the JAX gather path; the card holds K6 to it on the
    same inputs."""
    from chip_smoke import k6_inputs

    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import (
        table_lookup_auto as jax_lookup_auto,
    )
    from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import table_lookup

    for case, seg, tab, _ in k6_inputs():
        got = table_lookup(torch.from_numpy(seg), torch.from_numpy(tab))
        assert got.dtype == torch.int32, case
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_lookup_auto(jnp.asarray(seg), jnp.asarray(tab))),
            err_msg=case)


def test_table_auto_takes_plain_on_cpu_and_wrappers_refuse_cpu():
    from particle_col_image_segmentation_tpu_torch.ops.regionprops import (
        region_props,
        region_sums,
    )
    from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (
        region_props_auto,
        region_sums_auto,
        region_sums_cuda,
        region_table_cuda,
        table_lookup_cuda,
    )

    seg, img, max_regions = _case(0, 8, seed=15)
    seg_t, img_t = torch.from_numpy(seg), torch.from_numpy(img.astype(np.uint8))
    before = (region_table_cuda.launches, region_sums_cuda.launches)
    got = region_props_auto(seg_t, img_t, max_regions)
    want = region_props(seg_t, img_t, max_regions)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = region_sums_auto(seg_t, img_t, max_regions)
    assert all(torch.equal(g, w) for g, w in zip(got, region_sums(seg_t, img_t, max_regions)))
    assert (region_table_cuda.launches, region_sums_cuda.launches) == before
    for fn in (region_table_cuda, region_sums_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(seg_t, img_t, max_regions)
    with pytest.raises(ValueError, match="CUDA"):
        table_lookup_cuda(seg_t, torch.zeros(4, dtype=torch.int32))


# ---- the centroid table (K7's plain version) ----


@pytest.mark.parametrize("shape", [(64, 256), (3, 64, 128)], ids=["plane", "batch"])
def test_centroid_sums_matches_jax_scatter_and_mxu(shape):
    """Ids in [-3, R+9), negative and past-capacity ids included (dropped
    by every path); the five columns compared by name, exactly."""
    import jax

    from particle_col_image_segmentation_tpu.ops.regionprops import (
        centroid_sums as jax_centroid_sums,
    )
    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import centroid_sums_mxu
    from particle_col_image_segmentation_tpu_torch.ops.regionprops import centroid_sums

    max_regions = 699
    seg = np.random.default_rng(9).integers(-3, max_regions + 10, shape).astype(np.int32)
    seg[..., :8, :] = 0  # a hot background bin
    got = centroid_sums(torch.from_numpy(seg), max_regions)
    if len(shape) == 3:
        scatter = jax.vmap(lambda s: jax_centroid_sums(s, max_regions))(jnp.asarray(seg))
    else:
        scatter = jax_centroid_sums(jnp.asarray(seg), max_regions)
    mxu = centroid_sums_mxu(jnp.asarray(seg), max_regions, rows_per_chunk=8, interpret=True)
    for name in got._fields:
        col = getattr(got, name)
        assert col.dtype == torch.int32 and col.shape == shape[:-2] + (max_regions + 1,)
        np.testing.assert_array_equal(col.numpy(), np.asarray(getattr(scatter, name)), name)
        np.testing.assert_array_equal(col.numpy(), np.asarray(getattr(mxu, name)), name)
    assert int(got.area.sum()) == int(((seg >= 0) & (seg <= max_regions)).sum())


def test_centroid_auto_takes_plain_on_cpu_and_wrapper_refuses_cpu():
    from particle_col_image_segmentation_tpu_torch.ops.regionprops import centroid_sums
    from particle_col_image_segmentation_tpu_torch.ops.regionprops_tiles import (
        centroid_sums_auto,
        centroid_sums_cuda,
    )

    seg = torch.from_numpy(np.random.default_rng(10).integers(0, 50, (3, 97, 130)).astype(np.int32))
    before = centroid_sums_cuda.launches
    got, want = centroid_sums_auto(seg, 63), centroid_sums(seg, 63)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert centroid_sums_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        centroid_sums_cuda(seg, 63)


# ---- K5's edge inputs: runs that meet row ends, an id a pixel ----


def _assert_tables_equal_where_used(got, want, values_homogeneous=True):
    """Every column on the rows where ``valid`` or ``area > 0`` (row 0 of a
    plane included): the empty rows differ by backend (zeros here and on the
    MXU path, segment identities on the scatter path)."""
    area = np.asarray(want.area)
    used = np.asarray(want.valid) | (area > 0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.area.numpy(), area)
    for name in want._fields:
        if name == "class_id" and not values_homogeneous:
            continue
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g[used], w[used], err_msg=name)


def _edge_ids(H, W, seed):
    """[2, H, W] ids whose runs meet row ends: plane 0 one id over row bands
    of 3 (a band spans whole rows, so a 16-px group crosses rows inside one
    id) with 4-wide blocks in every other band, plane 1 an id a pixel; the
    class plane a function of the id (value-homogeneous, as CCL output is),
    so the JAX scatter table's class (a segment max) is comparable."""
    yy, xx = np.mgrid[:H, :W]
    band = yy // 3
    seg0 = np.where(band % 2 == 0, band + 1, 1000 + band * 64 + xx // 4)
    seg1 = 1 + yy * W + xx
    seg = np.stack([seg0, seg1]).astype(np.int32)
    lut = np.random.default_rng(seed).integers(-16384, 16384, seg.max() + 1).astype(np.int32)
    return seg, lut[seg]


@pytest.mark.parametrize("H,W,chunk", [(16, 1, 1), (30, 15, 15), (34, 17, 17), (26, 130, 26)])
def test_region_props_runs_meeting_row_ends_match_jax_scatter_and_mxu(H, W, chunk):
    """Widths 1, 15, 17 and 130 (W % 16 != 0, so K5's flat 16-px groups
    cross rows) and an id a pixel, against the JAX scatter table (plane by
    plane) and the MXU kernel (interpret mode; ``rows_per_chunk`` divides H
    and W, since its second pass runs over the transposed plane)."""
    from particle_col_image_segmentation_tpu.ops.regionprops import (
        region_props as jax_region_props,
    )
    from particle_col_image_segmentation_tpu.ops.regionprops_tiles import region_table_mxu

    from particle_col_image_segmentation_tpu_torch.ops.regionprops import region_props

    seg, img = _edge_ids(H, W, seed=W)
    max_regions = int(seg.max())
    got = region_props(torch.from_numpy(seg), torch.from_numpy(img), max_regions)
    for b in range(2):
        want = jax_region_props(jnp.asarray(seg[b]), jnp.asarray(img[b]), max_regions)
        plane = type(got)(*(t[b] for t in got))
        _assert_tables_equal_where_used(plane, want)
    mxu = region_table_mxu(jnp.asarray(seg), jnp.asarray(img), max_regions,
                           rows_per_chunk=chunk, interpret=True)
    _assert_tables_equal_where_used(got, mxu)
    # plane 1: every pixel its own region, its bbox the pixel itself
    n = H * W
    area1, bbox1 = got.area[1].numpy(), got.bbox[1].numpy()
    assert (area1[1 : n + 1] == 1).all() and area1[0] == 0 and not area1[n + 1 :].any()
    r, c = np.divmod(np.arange(n), W)
    np.testing.assert_array_equal(bbox1[1 : n + 1], np.stack([r, c, r + 1, c + 1], axis=1))
