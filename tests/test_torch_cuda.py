"""The hand-written CUDA kernels K1-K12, the blur kernel and the plateau
maxima pair against their plain PyTorch versions, on the card.  Every test
here needs a Hopper card and skips where there is none; on one, run them with

    python -m pytest tests/test_torch_cuda.py -q

Outputs are integers, so the tolerance is exact equality.  Inputs are made
with numpy from a seed.  The float32 values that the port rounds as XLA's
fused multiply-adds (``ops.rounding.fma_f32``: the nearest distances, the
Otsu centres) are held to the CPU run's bit patterns, and the blur
kernel's float32 output to its plain version's, in both forms.
"""

import math

import numpy as np
import pytest
import torch

from particle_col_image_segmentation_tpu_torch.ops import (
    MAX_HALF,
    bin_histogram_cuda,
    ccl_cuda,
    compact_labels,
    compact_labels_cuda,
    connected_components,
    edt_sq,
    edt_sq_cuda,
    gaussian_blur_cuda,
    median_label_filter,
    median_label_filter_cuda,
    particle_fill_step,
    particle_fill_step_cuda,
    region_counts,
    region_counts_cuda,
    region_props,
    region_sums,
    region_sums_cuda,
    region_table_cuda,
    table_lookup,
    table_lookup_cuda,
)

from particle_col_image_segmentation_tpu_torch.ops import (
    centroid_sums,
    centroid_sums_auto,
    centroid_sums_cuda,
    edt_sq_exact,
    edt_sq_exact_auto,
    local_maxima,
    local_maxima_auto,
    max_fused_cap,
    max_tile_cap,
    watershed,
    watershed_auto,
    watershed_cuda,
)
from particle_col_image_segmentation_tpu_torch.ops.watershed import claim_labels, minimax_costs
from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
    claim_labels_cuda,
    claim_labels_tunnel_cuda,
    minimax_costs_cuda,
    tunnel_init_cuda,
    watershed_cost_pass_cuda,
    watershed_label_pass_cuda,
)

from chip_smoke import (
    BLUR_SIGMAS,
    blur_inputs,
    blur_route,
    config1_plane,
    config4_painting,
    config2_stack,
    config2_stacks,
    fma_f32_np,
    fma_specials,
    fma_triples,
    midpoint_triples,
    pairwise_inputs,
    same_f32,
    hist_bins_inputs,
    hist_edge_inputs,
    hist_inputs,
    hist_nonfinite_inputs,
    k3_inputs,
    k3_raw,
    k4_inputs,
    k5_inputs,
    k6_inputs,
    k7_inputs,
    k8_inputs,
    k9_inputs,
    off16,
    plain_blur,
    plain_threshold,
    plain_morphology,
    plain_threshold_batch,
    refine_relief,
    scipy_min_index,
    serpentine,
    stack_stats,
    write_acquisition,
    ws_budgets,
    ws_corridor,
    ws_mixed,
    write_tiff_pages,
)
from fixtures import random_class_plane, synthetic_label_plane

pytestmark = pytest.mark.cuda

SHAPES = [(64, 128), (2, 37, 53), (3, 97, 130), (1, 3, 5)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    planes = [synthetic_label_plane(seed=seed + b, shape=(192, 192))[:shape[-2], :shape[-1]]
              for b in range(int(np.prod(shape[:-2])))]
    img = np.stack(planes).reshape(shape).copy()
    img[rng.random(shape) < 0.05] = 1  # salt
    return img


def _equal(got, want, case=""):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, case
        assert torch.equal(g, w), case


@pytest.mark.parametrize("size", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", SHAPES)
def test_median_kernel(dev, shape, size):
    x = torch.from_numpy(_planes(shape, seed=1)).to(dev)
    before = median_label_filter_cuda.launches
    _equal([median_label_filter_cuda(x, size, 8)], [median_label_filter(x, size, 8)])
    assert median_label_filter_cuda.launches == before + 1
    wide = torch.from_numpy(np.random.default_rng(2).integers(0, 12, shape).astype(np.uint8)).to(dev)
    _equal([median_label_filter_cuda(wide, size, 5)], [median_label_filter(wide, size, 5)])


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("background", [None, 0, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_ccl_and_compact_kernels(dev, shape, background, connectivity):
    x = torch.from_numpy(_planes(shape, seed=3)).to(dev)
    before = (ccl_cuda.launches, compact_labels_cuda.launches)
    raw = ccl_cuda(x, background=background, connectivity=connectivity)
    want, conv = connected_components(
        x, background=background, connectivity=connectivity, max_iters=4096,
        with_flag=True,
    )
    assert bool(conv.all())
    _equal([raw], [want])
    _equal(compact_labels_cuda(raw, 16383), compact_labels(raw, 16383))
    assert (ccl_cuda.launches, compact_labels_cuda.launches) == (before[0] + 1, before[1] + 1)


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
CCL_CASES = ["single", "serpentine", "checker", "checker2", "stripes_h", "stripes_v",
             "noise_bg0", "noise", "int32_extremes", "majority"]
ODD_WIDTHS = [1, 31, 33, 63, 65, 129]


def ccl_plane(case, H, W, seed=0):
    """An adversarial K2 input and its background: one value everywhere; a
    serpentine of 1-px rows joined at alternate ends (crosses every tile);
    checkerboards of 1-px and 2-px squares (diagonal-only links); 1-px
    stripes either way; 50 % binary noise with background 0 or None; int32
    values at the extremes with background INT32_MIN; a majority class
    spanning the plane with noise in it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    if case == "single":
        return np.full((H, W), 3, np.uint8), None
    if case == "serpentine":
        img = np.zeros((H, W), np.uint8)
        img[::2] = 1
        for i in range(1, H, 2):
            img[i, W - 1 if (i // 2) % 2 == 0 else 0] = 1
        return img, 0
    if case == "checker":
        return ((yy + xx) % 2).astype(np.uint8), None
    if case == "checker2":
        return ((yy // 2 + xx // 2) % 2).astype(np.uint8), 0
    if case == "stripes_h":
        return (yy % 2).astype(np.uint8), None
    if case == "stripes_v":
        return (xx % 2).astype(np.uint8), 0
    if case in ("noise_bg0", "noise"):
        return (rng.random((H, W)) < 0.5).astype(np.uint8), 0 if case == "noise_bg0" else None
    if case == "int32_extremes":
        vals = np.array([INT32_MIN, INT32_MAX, -1, 0, 7], np.int64)
        img = vals[rng.choice(5, (H, W), p=[0.2, 0.4, 0.1, 0.2, 0.1])]
        return img.astype(np.int32), INT32_MIN
    if case == "majority":
        return np.where(rng.random((H, W)) < 0.7, 1, rng.integers(0, 3, (H, W))).astype(np.uint8), None
    raise ValueError(case)


def _check_ccl(dev, img, background, connectivity):
    """K2 against the scipy-derived labels, and against the plain fixpoint
    where that converges."""
    x = torch.from_numpy(img).to(dev)
    got = ccl_cuda(x, background=background, connectivity=connectivity)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), scipy_min_index(img, background, connectivity))
    want, conv = connected_components(x, background=background, connectivity=connectivity,
                                      max_iters=4096, num_classes=8, with_flag=True)
    if img.dtype == np.uint8 and bool(conv.all()):
        _equal([got], [want])


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("case", CCL_CASES)
def test_ccl_kernel_adversarial(dev, case, connectivity):
    img, background = ccl_plane(case, 150, 161, seed=len(case))
    _check_ccl(dev, img, background, connectivity)
    _check_ccl(dev, np.stack([img, img[::-1, ::-1].copy()]), background, connectivity)


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("W", ODD_WIDTHS)
def test_ccl_kernel_odd_widths(dev, W, connectivity):
    for case in ("majority", "serpentine", "noise_bg0"):
        img, background = ccl_plane(case, 130, W, seed=W)
        _check_ccl(dev, img, background, connectivity)
        _check_ccl(dev, np.ascontiguousarray(img.T), background, connectivity)


MEDIAN_SHAPES = [(3, 2, 5), (2, 63, 31), (2, 64, 32), (65, 33), (2, 129, 48), (2, 150, 112),
                 (1, 70, 65), (1, 200, 1)]


@pytest.mark.parametrize("size", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", MEDIAN_SHAPES)
def test_median_kernel_tile_edges(dev, shape, size):
    """Planes around the 32 x 64 tile and narrower than the halo; values past
    num_classes; a view off a 16-byte boundary (the reflecting path)."""
    img = np.random.default_rng(size).integers(0, 10, shape).astype(np.uint8)
    x = torch.from_numpy(img).to(dev)
    for k in (8, 3, 1):
        _equal([median_label_filter_cuda(x, size, k)], [median_label_filter(x, size, k)])
    buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
    off = buf[1:].view(shape)
    off.copy_(x)
    _equal([median_label_filter_cuda(off, size, 8)], [median_label_filter(x, size, 8)])


def test_ccl_kernel_int32_values_and_spiral(dev):
    vals = torch.from_numpy(random_class_plane((3, 70, 90), 6, seed=4).astype(np.int32)).to(dev)
    _equal([ccl_cuda(vals)], [connected_components(vals, max_iters=4096)])
    H = W = 96  # one snake winding through the whole plane
    snake = np.zeros((H, W), np.uint8)
    for i in range(0, H, 2):
        snake[i, :] = 1
        snake[i + 1, W - 1 if (i // 2) % 2 == 0 else 0] = 1
    s = torch.from_numpy(snake).to(dev)
    _equal([ccl_cuda(s, background=0)],
           [connected_components(s, background=0, max_iters=4096)])


@pytest.mark.parametrize("max_regions", [16383, 20000, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_region_counts_kernel(dev, shape, max_regions):
    x = torch.from_numpy(_planes(shape, seed=5)).to(dev)
    seg, _ = compact_labels(connected_components(x, max_iters=4096), max_regions)
    before = region_counts_cuda.launches
    _equal(region_counts_cuda(seg, x, max_regions), region_counts(seg, x, max_regions))
    assert region_counts_cuda.launches == before + 1


def test_region_counts_kernel_drops_and_saturates(dev):
    rng = np.random.default_rng(6)
    seg = torch.from_numpy(rng.integers(-3, 40, (2, 64, 256)).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(-16384, 16384, (2, 64, 256)).astype(np.int32)).to(dev)
    _equal(region_counts_cuda(seg, vals, 30), region_counts(seg, vals, 30))
    big = torch.zeros((2, 512, 512), dtype=torch.int32, device=dev)
    big_vals = torch.full((2, 512, 512), 16383, dtype=torch.int32, device=dev)
    big_vals[1] = -16384
    _equal(region_counts_cuda(big, big_vals, 4), region_counts(big, big_vals, 4))


def test_compact_kernel_edges(dev):
    """K3 on chip_smoke.k3_inputs: raw that is not CCL output (forward
    references, non-root targets, values past the plane, int32 extremes),
    odd shapes, a view off a 16-byte boundary, and B = 64; each 3-D case
    also as its first plane alone."""
    for case, raw, sliced in k3_inputs():
        x = torch.from_numpy(raw).to(dev)
        if sliced:
            x = x[1:]
            assert x.data_ptr() % 16, case
        _equal(compact_labels_cuda(x, 16383), compact_labels(x, 16383), case)
        _equal(compact_labels_cuda(x[0], 16383), compact_labels(x[0], 16383), case)


def test_compact_kernel_every_width(dev):
    for w in range(1, 130):
        x = torch.from_numpy(k3_raw((2, 37, w), seed=w)).to(dev)
        _equal(compact_labels_cuda(x, 16383), compact_labels(x, 16383), f"width {w}")


def test_counts_kernel_edges(dev):
    """Both K4 wrappers on chip_smoke.k4_inputs: the hot bin, distinct ids,
    dropped ids, several id tiles, saturating int32 sums, odd plane sizes
    and views off a 16-byte boundary."""
    for case, seg, vals, max_regions, shifted in k4_inputs():
        s, v = torch.from_numpy(seg).to(dev), torch.from_numpy(vals).to(dev)
        if shifted:
            s, v = off16(s), off16(v)
            assert s.data_ptr() % 16 and v.data_ptr() % 16, case
        _equal(region_counts_cuda(s, v, max_regions), region_counts(s, v, max_regions), case)
        _equal(region_sums_cuda(s, v, max_regions), region_sums(s, v, max_regions), case)


def test_wrappers_check_their_inputs(dev):
    x = torch.zeros((2, 16, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        median_label_filter_cuda(x.to(torch.int32))
    with pytest.raises(ValueError, match="num_classes"):
        median_label_filter_cuda(x, 5, 9)
    with pytest.raises(ValueError, match="size"):
        median_label_filter_cuda(x, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ccl_cuda(x.transpose(1, 2))
    with pytest.raises(ValueError, match="int32"):
        compact_labels_cuda(x, 8)
    with pytest.raises(ValueError, match="shapes"):
        region_counts_cuda(x.to(torch.int32), x[:1], 8)


def _labelled(shape, seed, max_regions):
    x = torch.from_numpy(_planes(shape, seed=seed))
    seg, _ = compact_labels(connected_components(x, max_iters=4096), max_regions)
    return seg, x


@pytest.mark.parametrize("max_regions", [16384, 20000, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_region_table_kernel(dev, shape, max_regions):
    seg, x = (t.to(dev) for t in _labelled(shape, 7, max_regions))
    before = region_table_cuda.launches
    _equal(region_table_cuda(seg, x, max_regions), region_props(seg, x, max_regions))
    assert region_table_cuda.launches == before + 1
    vals = x.to(torch.int32) * 4099 - 16384  # signed values, one per class
    _equal(region_table_cuda(seg, vals, max_regions), region_props(seg, vals, max_regions))


def test_region_table_kernel_drops_ids_and_saturates(dev):
    rng = np.random.default_rng(8)
    seg = torch.from_numpy(rng.integers(-3, 40, (2, 64, 256)).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(-16384, 16384, (2, 64, 256)).astype(np.int32)).to(dev)
    _equal(region_table_cuda(seg, vals, 30), region_props(seg, vals, 30))
    big = torch.zeros((2, 512, 512), dtype=torch.int32, device=dev)
    big_vals = torch.full((2, 512, 512), 16383, dtype=torch.int32, device=dev)
    big_vals[1] = -16384
    _equal(region_table_cuda(big, big_vals, 4), region_props(big, big_vals, 4))


@pytest.mark.parametrize("shape", SHAPES)
def test_region_sums_kernel(dev, shape):
    seg, x = (t.to(dev) for t in _labelled(shape, 9, 4096))
    other = (x == 1).to(torch.int32)
    before = (region_sums_cuda.launches, region_counts_cuda.launches)
    _equal(region_sums_cuda(seg, other, 4096), region_sums(seg, other, 4096))
    assert (region_sums_cuda.launches, region_counts_cuda.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("R", [1, 600, 16385, 40000])
@pytest.mark.parametrize("shape", SHAPES)
def test_table_lookup_kernel(dev, shape, R):
    rng = np.random.default_rng(10)
    seg = rng.integers(-1, R + 3, shape).astype(np.int32)
    flat = seg.reshape(-1)
    flat[: min(5, flat.size)] = [-1, 0, R - 1, R, 2 * R][: min(5, flat.size)]
    seg = torch.from_numpy(seg).to(dev)
    B = shape[0] if len(shape) == 3 else 1
    for tshape in [(R,)] + ([(B, R)] if len(shape) == 3 else []):
        tab = torch.from_numpy(rng.integers(0, 256, tshape).astype(np.int32)).to(dev)
        tab[..., 0] = 255
        tab[..., -1] = 0
        before = table_lookup_cuda.launches
        _equal([table_lookup_cuda(seg, tab)], [table_lookup(seg, tab)])
        assert table_lookup_cuda.launches == before + 1


def test_table_lookup_kernel_edges(dev):
    """K6 on chip_smoke.k6_inputs: ids and table values at INT32_MIN and
    INT32_MAX, R = 1 to 40000, [R] and [B,R] tables, H*W not a multiple of 4
    (a vector straddles two planes), B = 64, views off a 16-byte boundary;
    each 3-D case with an [R] table also as its first plane alone."""
    for case, seg, tab, shifted in k6_inputs():
        s, t = torch.from_numpy(seg).to(dev), torch.from_numpy(tab).to(dev)
        if shifted:
            s, t = off16(s), off16(t)
            assert s.data_ptr() % 16 and t.data_ptr() % 16, case
        before = table_lookup_cuda.launches
        _equal([table_lookup_cuda(s, t)], [table_lookup(s, t)], case)
        assert table_lookup_cuda.launches == before + 1
        if s.ndim == 3 and t.ndim == 1:
            _equal([table_lookup_cuda(s[0], t)], [table_lookup(s[0], t)], case)


@pytest.mark.parametrize("cap", [0, 2, 5, 8, 9, 20, 32])
@pytest.mark.parametrize("shape", SHAPES)
def test_edt_kernel(dev, shape, cap):
    rng = np.random.default_rng(cap)
    for density in (0.02, 0.0, 1.0):
        m = torch.from_numpy(rng.random(shape) < density).to(dev)
        before = edt_sq_cuda.launches
        _equal([edt_sq_cuda(m, cap)], [edt_sq(m, cap)])
        _equal([edt_sq_cuda(m.to(torch.uint8), cap)], [edt_sq(m, cap)])
        assert edt_sq_cuda.launches == before + 2


def test_edt_kernel_long_rows_and_cap_past_the_plane(dev):
    rng = np.random.default_rng(11)
    m = torch.from_numpy(rng.random((2, 40, 3000)) < 0.001).to(dev)
    for cap in (3, 100, 1000):
        _equal([edt_sq_cuda(m, cap)], [edt_sq(m, cap)])


@pytest.mark.parametrize("params", [(2, 1, 20, 4, 400), (2, 1, 5, 9, 4), (4, 2, 2, 4, 4)])
@pytest.mark.parametrize("shape", SHAPES)
def test_fill_kernel(dev, shape, params):
    x = torch.from_numpy(_planes(shape, seed=12)).to(dev)
    before = particle_fill_step_cuda.launches
    _equal(particle_fill_step_cuda(x, *params), particle_fill_step(x, *params))
    assert particle_fill_step_cuda.launches == before + 1
    none = torch.where(x == params[0], 3, x)  # no particle pixel at all
    _equal(particle_fill_step_cuda(none, *params), particle_fill_step(none, *params))


def test_region_table_kernel_edges(dev):
    """K5 on chip_smoke.k5_inputs: K4's edge inputs, runs meeting row and
    plane ends at widths 1-130, B = 1 and 64, an id a pixel over 2048² (every
    block's shared table overflows) and ids sharing their low 12 bits."""
    for case, seg, vals, max_regions, shifted in k5_inputs():
        s, v = torch.from_numpy(seg).to(dev), torch.from_numpy(vals).to(dev)
        if shifted:
            s, v = off16(s), off16(v)
        _equal(region_table_cuda(s, v, max_regions), region_props(s, v, max_regions), case)


def test_edt_kernel_both_routes_and_flag(dev):
    """K9 on chip_smoke.k9_inputs: caps 0-3, 8, 9, 31-33, the largest cap of
    the one-kernel route and the one past it (the two-kernel route),
    features at cap and cap + 1 from tile edges, cap > H, odd shapes, a view
    off a 16-byte boundary; the route follows the cap, and the flag is set
    exactly where some d² > cap²."""
    top = max_tile_cap()
    routes = {}
    for case, m, cap, shifted in k9_inputs(top):
        mt = torch.from_numpy(m).to(dev)
        mt = off16(mt) if shifted else mt
        got, flag = edt_sq_cuda(mt, cap, with_flag=True)
        want = edt_sq(mt, cap)
        _equal([got], [want], case)
        assert bool(flag) == bool((want > cap * cap).any()), case
        routes[cap] = edt_sq_cuda.last_route
    assert routes == {c: "tile" if c <= top else "two-kernel" for c in routes}
    assert top + 1 in routes and top >= 32


def test_fill_kernel_both_routes(dev):
    """K8 on chip_smoke.k8_inputs: caps 0-20, the largest cap of the
    one-kernel route and the one past it (the two-kernel route), particles
    at cap and cap + 1 from tile edges, dt2 past (cap + 1)², no cell pixel,
    odd shapes; the route follows the cap."""
    top = max_fused_cap()
    routes = {}
    for case, x, params in k8_inputs(top):
        xt = torch.from_numpy(x).to(dev)
        _equal(particle_fill_step_cuda(xt, *params), particle_fill_step(xt, *params),
               f"{case} {params}")
        routes[params[2]] = particle_fill_step_cuda.last_route
    assert routes == {c: "fused" if c <= top else "two-kernel" for c in routes}
    assert top + 1 in routes and top >= 20


def test_new_wrappers_check_their_inputs(dev):
    x = torch.zeros((2, 16, 16), dtype=torch.uint8, device=dev)
    i = x.to(torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        region_table_cuda(i, x[:1], 8)
    with pytest.raises(ValueError, match="int32"):
        table_lookup_cuda(i, torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="table"):
        table_lookup_cuda(i[0], torch.zeros((2, 4), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="cap"):
        edt_sq_cuda(x, -1)
    with pytest.raises(ValueError, match="bool or uint8"):
        edt_sq_cuda(i, 2)
    with pytest.raises(ValueError, match="uint8"):
        particle_fill_step_cuda(i, 2, 1, 20, 4, 400)
    with pytest.raises(ValueError, match="class values"):
        particle_fill_step_cuda(x, 300, 1, 20, 4, 400)
    with pytest.raises(ValueError, match="int32"):
        particle_fill_step_cuda(x, 2, 1, 20, 2**31, 400)


# ---- K7, K10/K11 and K2's plateau use (the refine slice) ----


@pytest.mark.parametrize("max_regions", [4095, 30000, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_centroid_kernel(dev, shape, max_regions):
    seg = np.random.default_rng(3).integers(-3, 5000, shape).astype(np.int32)
    seg[..., : shape[-2] // 2, :] = 0  # a hot background bin
    x = torch.from_numpy(seg).to(dev)
    before = centroid_sums_cuda.launches
    _equal(centroid_sums_cuda(x, max_regions), centroid_sums(x, max_regions))
    assert centroid_sums_cuda.launches == before + 1
    _equal(centroid_sums_auto(x, max_regions), centroid_sums(x, max_regions))


def test_centroid_kernel_edges(dev):
    """K7 on chip_smoke.k7_inputs: one id over 2048², runs crossing rows and
    planes, ids past R, a 2-D plane, R+1 = 4096 and 4097 with ids sharing
    their shared-table slot, R+1 = 30001, an id a pixel, B = 64, a view off
    a 16-byte boundary."""
    for case, seg, max_regions, shifted in k7_inputs():
        s = torch.from_numpy(seg).to(dev)
        s = off16(s) if shifted else s
        _equal(centroid_sums_cuda(s, max_regions), centroid_sums(s, max_regions), case)


def _relief(n, pairs, seed):
    """The bench's touching-cell relief (as ``test_torch_watershed``, which
    this file does not import: it needs no JAX)."""
    from scipy import ndimage as ndi

    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), bool)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(pairs):
        cy, cx = rng.integers(40, n - 40, 2)
        r2 = int(rng.integers(150, 400))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        m |= (yy - cy) ** 2 + (xx - cx - int(1.5 * np.sqrt(r2))) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def _relief_case(n, quantized, seed=0):
    """(relief, markers, mask): markers are the labelled 3×3 maxima of the
    mask's EDT, the 16-level quantization is the bench's."""
    from scipy import ndimage as ndi

    prob = _relief(n, max(1, n * n // 8192), seed)
    mask = prob < 0.5
    d = ndi.distance_transform_edt(mask)
    mk = ndi.label((d == ndi.maximum_filter(d, 3)) & mask)[0].astype(np.int32)
    if quantized:
        prob = (np.round(prob * 15.0) / 15.0).astype(np.float32)
    return prob, mk, mask


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("quantized", [False, True])
def test_watershed_kernels(dev, quantized, connectivity):
    """Each phase launches one kernel a pass it enqueues: the counted passes
    and the idle tail of the last chunk (``PhaseLog.launches``), so the
    launches are at least the passes; the host syncs once a chunk."""
    planes = [_relief_case(256, quantized, seed) for seed in (0, 1)]
    img, mk, mask = (torch.from_numpy(np.stack(t)).to(dev) for t in zip(*planes))
    k10, k11 = watershed_cost_pass_cuda.launches, watershed_label_pass_cuda.launches
    got, gconv = watershed_cuda(img, mk, mask, connectivity=connectivity, with_flag=True)
    log1, log2 = watershed_cuda.last_logs
    assert watershed_cuda.last_passes == (log1.passes, log2.passes)
    assert watershed_cost_pass_cuda.launches == k10 + log1.launches
    assert watershed_label_pass_cuda.launches == k11 + log2.launches
    for log in (log1, log2):
        assert log.launches >= log.passes >= 1 and len(log.tiles) == log.launches
        assert 1 <= log.syncs <= -(-log.launches // 4)  # one a chunk of >= 4 passes
    want, wconv = watershed(img, mk, mask, connectivity=connectivity, with_flag=True)
    assert gconv.all() and wconv.all()
    _equal([got], [want])
    _equal([watershed_auto(img, mk, mask, connectivity=connectivity)], [want])


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", ["corridor", "mixed"])
def test_watershed_kernels_corridor_mixed_passes_and_budgets(dev, case, connectivity):
    """The serpentine corridor (tiles go quiet and wake again) and a batch
    whose planes need a few and many passes (the per-plane early exit):
    each phase equal to plain, then the budgets 1, 2, need − 1 and need."""
    arrays = ws_mixed() if case == "mixed" else [a[None] for a in ws_corridor()]
    img, mk, mask = (torch.from_numpy(a).to(dev) for a in arrays)
    seeded = (mk > 0) & mask
    cost_k, busy_k, log1 = minimax_costs_cuda(img, mask, seeded, connectivity)
    cost_p, busy_p = minimax_costs(img, mask, seeded, connectivity, max_iters=1 << 14)
    assert not busy_k.any() and not busy_p.any() and log1.passes > 12
    _equal([cost_k], [cost_p])
    lab_k, busy_k, log2 = claim_labels_cuda(cost_k, img, mk, mask, seeded, connectivity)
    lab_p, busy_p = claim_labels(cost_p, img, mk, mask, seeded, connectivity,
                                 max_iters=1 << 14)
    assert not busy_k.any() and not busy_p.any()
    _equal([lab_k], [lab_p])
    if case == "mixed":  # the seeded plane idles through most of the passes
        assert min(log1.tiles[-4:]) <= log1.tiles[0] // 2
    records = ws_budgets(img, mk, mask, connectivity, lab_p)
    assert [b for b, *_ in records][:2] == [1, 2]


def test_watershed_kernels_odd_shape_unreachable_mask_and_budget(dev):
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.random((3, 97, 130)).astype(np.float32)).to(dev)
    mk = torch.zeros((3, 97, 130), dtype=torch.int32, device=dev)
    mk[:, 5, 5], mk[:, 90, 120], mk[1, 50, 2] = 1, 2, 3
    mask = torch.ones((3, 97, 130), dtype=torch.bool, device=dev)
    mask[:, :, 60:63] = False
    mask[2, 40:60, 80:100] = False
    mask[2, 45:55, 85:95] = True  # unreachable
    for connectivity in (1, 2):
        got, gconv = watershed_cuda(img, mk, mask, connectivity=connectivity, with_flag=True)
        want, wconv = watershed(img, mk, mask, connectivity=connectivity, with_flag=True)
        assert gconv.all() and wconv.all()
        _equal([got], [want])
        assert int(got[2, 45:55, 85:95].abs().sum()) == 0
    _, short = watershed_cuda(img, mk, mask, max_iters=1, with_flag=True)
    assert not short.any()  # every plane needs more than one pass


@pytest.mark.parametrize("connectivity", [1, 2])
def test_tunnelled_watershed_on_the_card(dev, connectivity):
    """watershed_auto(tunnel_basins=True) on the card (K10, K2 on the basins,
    K12's steps; no K11) against the plain run on the card, on a batch of
    16-level reliefs and on the sparse-seed regime; K12 launches once to set
    up and three times a step; the card's basins against scipy's."""
    from chip_smoke import basins_vs_scipy, sparse_seeds

    planes = [_relief_case(256, True, seed) for seed in (0, 1)]
    q, smk = sparse_seeds()
    cases = [[torch.from_numpy(np.stack(t)).to(dev) for t in zip(*planes)],
             [torch.from_numpy(q[None]).to(dev), torch.from_numpy(smk[None]).to(dev),
              torch.ones((1, 128, 128), dtype=torch.bool, device=dev)]]
    for img, mk, mask in cases:
        before = (ccl_cuda.launches, watershed_cost_pass_cuda.launches,
                  watershed_label_pass_cuda.launches, tunnel_init_cuda.launches,
                  claim_labels_tunnel_cuda.launches)
        got, gconv = watershed_auto(img, mk, mask, connectivity=connectivity, max_iters=4096,
                                    with_flag=True, tunnel_basins=True)
        assert ccl_cuda.launches == before[0] + 1 and watershed_cost_pass_cuda.launches > before[1]
        assert watershed_label_pass_cuda.launches == before[2]
        steps = claim_labels.last_steps
        assert steps > 1 and tunnel_init_cuda.launches == before[3] + 1
        assert claim_labels_tunnel_cuda.launches == before[4] + 3 * steps
        want, wconv = watershed(img, mk, mask, connectivity=connectivity, max_iters=4096,
                                with_flag=True, tunnel_basins=True)
        assert gconv.all() and wconv.all()
        _equal([got], [want])
        largest = basins_vs_scipy(img, mk, mask, connectivity)[2]
    assert largest > 1  # the sparse-seed relief's basins span several pixels


def _tunnel_cases():
    """(name, img, markers, mask) numpy batches for K12: 16-level noise
    reliefs of three sizes with sparse seeds (basins of thousands of pixels;
    planes that converge at different steps), the bench's 16-level relief,
    claims that tie in (d, e) and (d, e, s) so the marker id decides, +0.0
    beside -0.0, and the sparse-seed regime's large basins."""
    from chip_smoke import sparse_seeds

    noise = [sparse_seeds(n, 16) for n in (128, 112, 96)]
    levels = (np.stack([np.pad(q, ((0, 128 - len(q)),) * 2, constant_values=1.0)
                        for q, _ in noise]),
              np.stack([np.pad(mk, ((0, 128 - len(mk)),) * 2) for _, mk in noise]),
              np.stack([np.pad(np.ones(q.shape, bool), ((0, 128 - len(q)),) * 2)
                        for q, _ in noise]))
    bench = [np.stack(t) for t in zip(*(_relief_case(256, True, seed) for seed in (0, 1)))]
    # a plateau at 0.5 with a pit at 0.25, reached from both sides at once by
    # markers 3 and 2: every claim on the pit ties in (d, e, s), and the least
    # marker id wins; plane 1 adds markers 5 and 4 at mirrored corners, whose
    # claims tie on the plateau
    tie = np.full((2, 60, 80), 0.5, np.float32)
    tie[:, 20:40, 30:50] = 0.25
    tie_mk = np.zeros(tie.shape, np.int32)
    tie_mk[:, 30, 5], tie_mk[:, 30, 74] = 3, 2
    tie_mk[1, 2, 2], tie_mk[1, 57, 77] = 5, 4
    # the same with the plateau at 0.0 written as +0.0 and -0.0, the pit at -0.25
    zero = np.where(np.indices(tie.shape[1:]).sum(0) % 3 == 0, np.float32(-0.0),
                    np.float32(0.0))[None].repeat(2, 0)
    zero[:, 20:40, 30:50] = -0.25
    zero[:, 25:30, 35:40] = -0.0  # an island at the plateau's level inside the pit
    q, smk = sparse_seeds()
    return [("16-level", *levels), ("bench relief", *bench),
            ("ties", tie, tie_mk, np.ones(tie.shape, bool)),
            ("signed zeros", zero, tie_mk, np.ones(tie.shape, bool)),
            ("sparse seeds", q[None], smk[None], np.ones((1,) + q.shape, bool))]


@pytest.mark.parametrize("connectivity", [1, 2])
def test_tunnel_claim_kernel_step_for_step(dev, connectivity):
    """K12 (``claim_labels_tunnel_cuda``) against the plain
    ``claim_labels(basins=…)`` on the card, from the same costs and basins:
    labels, per-plane flags and steps equal at max_iters 1, 2, 7 and to
    convergence, on ``_tunnel_cases``."""
    from particle_col_image_segmentation_tpu_torch.ops.watershed import basin_segments

    for name, *arrays in _tunnel_cases():
        img, mk, mask = (torch.from_numpy(a).to(dev) for a in arrays)
        seeded = (mk > 0) & mask
        cost, busy, _ = minimax_costs_cuda(img, mask, seeded, connectivity)
        seg, inc, conv = basin_segments(cost, img, mask, seeded, connectivity)
        assert not busy.any() and conv.all(), name
        in_basins = int((seg != torch.arange(seg.numel(), device=dev).reshape(seg.shape)).sum())
        assert in_basins > 0 or name == "bench relief", name
        if name == "16-level":  # the planes alone run different numbers of steps
            alone = []
            for b in range(img.shape[0]):
                claim_labels(cost[b:b + 1], img[b:b + 1], mk[b:b + 1], mask[b:b + 1],
                             seeded[b:b + 1], connectivity, 4096,
                             basins=basin_segments(cost[b:b + 1], img[b:b + 1], mask[b:b + 1],
                                                   seeded[b:b + 1], connectivity)[:2])
                alone.append(claim_labels.last_steps)
            assert len(set(alone)) > 1, alone
        for budget in (1, 2, 7, 4096):
            want, w_busy = claim_labels(cost, img, mk, mask, seeded, connectivity, budget,
                                        basins=(seg, inc))
            w_steps = claim_labels.last_steps
            got, g_busy, g_steps = claim_labels_tunnel_cuda(cost, img, mk, mask, seeded, seg,
                                                            inc, connectivity, budget)
            case = f"{name} connectivity={connectivity} max_iters={budget}"
            assert g_steps == w_steps, case
            _equal([got, g_busy], [want, w_busy], case)
        assert not g_busy.any() and w_steps < 4096, name
        if name in ("ties", "signed zeros"):  # the pit went to the least marker
            assert bool((got[:, 30, 40] == 2).all()), name


def test_local_maxima_and_exact_edt_kernels(dev):
    prob = torch.from_numpy(np.stack([_relief(256, 8, s) for s in (0, 1)])).to(dev)
    feature = prob >= 0.5
    dsq = edt_sq_exact_auto(feature)
    _equal([dsq], [edt_sq_exact(feature)])
    for connectivity in (1, 2):
        before = ccl_cuda.launches
        got, conv = local_maxima_auto(dsq, connectivity, with_flag=True)
        assert ccl_cuda.launches == before + 1 and conv.all()
        _equal([got], [local_maxima(dsq, connectivity)])
        u8 = dsq.clamp(max=255).to(torch.uint8)
        _equal([local_maxima_auto(u8, connectivity)], [local_maxima(u8, connectivity)])
    deep = torch.zeros((1, 300, 200), dtype=torch.bool, device=dev)
    deep[0, 5, 7] = True  # the exact fallback
    _equal([edt_sq_exact_auto(deep)], [edt_sq_exact(deep)])
    with pytest.raises(ValueError, match="uint8 or int32"):
        local_maxima_auto(dsq.to(torch.float32))


def _snake(h, w, pitch=4):
    """(path, beside): a one-pixel path from (1, 1) winding down an [h, w]
    plane, rows ``pitch`` apart, and the pixel just past its far end."""
    path = np.zeros((h, w), bool)
    rows = list(range(1, h - 1, pitch))
    for k, r in enumerate(rows):
        path[r, 1:w - 1] = True
        if k + 1 < len(rows):
            c = w - 2 if k % 2 == 0 else 1
            path[r:rows[k + 1] + 1, c] = True
    # the last row is entered where the row before it turned down
    last = len(rows) - 1
    entry = 1 if last == 0 else (w - 2 if (last - 1) % 2 == 0 else 1)
    return path, (rows[-1], w - 1 if entry == 1 else 0)


def _blocky(rng, shape, values, k=3, salt=0.02):
    """Plateaus: k x k blocks of values drawn from ``values``, with salt."""
    B, H, W = shape
    idx = rng.integers(0, len(values), (B, H // k + 1, W // k + 1))
    idx = np.repeat(np.repeat(idx, k, 1), k, 2)[:, :H, :W]
    salted = rng.random(shape) < salt
    idx[salted] = rng.integers(0, len(values), int(salted.sum()))
    return np.asarray(values)[idx]


def _maxima_inputs(dtype, seed=83):
    """(case, [B, H, W] values) for the plateau maxima pair: a flat stack, a
    winding plateau whose one higher neighbour sits past its far end (and
    the same without it), three planes whose plateaus share one root index
    with only the middle one marked, thin and odd shapes, a 2048² plane, and
    the dtype's extreme values (INT32_MIN and INT32_MAX, negatives)."""
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        extremes = [0, 1, 127, 254, 255]
    else:
        extremes = [-2**31, -2**31 + 1, -7, -1, 0, 2**31 - 2, 2**31 - 1]
    cases = [("flat [3,33,65]", np.full((3, 33, 65), 7, dtype)),
             ("flat [1,64,128]", np.zeros((1, 64, 128), dtype))]
    path, beside = _snake(201, 300)
    for far in (True, False):
        img = np.where(path, 5, 1).astype(dtype)
        if far:
            img[beside] = 9
        cases.append((f"winding plateau, higher past its far end {far}", img[None]))
    shared = np.ones((3, 40, 40), dtype)
    shared[:, 10:20, 10:20] = 5  # one root index, 10 * 40 + 10, in every plane
    shared[1, 15, 20] = 9  # only the middle plane's plateau has a higher neighbour
    cases.append(("[3,40,40] plateaus sharing a root index", shared))
    for shape in ((1, 1, 1000), (1, 1000, 1), (2, 33, 65), (1, 2048, 2048)):
        cases.append((f"blocks {list(shape)}", _blocky(rng, shape, [0, 1, 2, 3]).astype(dtype)))
    cases.append(("extremes [2,97,130]", _blocky(rng, (2, 97, 130), extremes).astype(dtype)))
    cases.append(("extremes [1,256,256] 1 px", _blocky(rng, (1, 256, 256), extremes, k=1)
                  .astype(dtype)))
    return cases


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_plateau_maxima_pair(dev, dtype, connectivity):
    """``local_maxima_auto`` (K2, then the maxima pair) against the plain
    fixpoint ``local_maxima`` exactly on ``_maxima_inputs``, with one K2
    launch and two of the pair a call and no synchronising call; the pair
    alone on copies 4 bytes past a 16-byte boundary (the scalar route)."""
    from particle_col_image_segmentation_tpu_torch.ops import plateau_maxima_cuda

    conn = 8 if connectivity == 2 else 4
    for case, x_np in _maxima_inputs(dtype):
        x = torch.from_numpy(x_np).to(dev)
        want, conv = local_maxima(x, connectivity, max_iters=4096, with_flag=True)
        assert conv.all(), case
        torch.cuda.synchronize()
        before = (ccl_cuda.launches, plateau_maxima_cuda.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = local_maxima_auto(x, connectivity)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert (ccl_cuda.launches, plateau_maxima_cuda.launches) == (
            before[0] + 1, before[1] + 2), case
        _equal([got], [want], case)
        root = ccl_cuda(x, connectivity=conn)
        _equal([plateau_maxima_cuda(off16(x), off16(root), conn)], [want], case)
        if case.startswith("[3,40,40]"):  # the plateau is a maximum but in the middle plane
            assert got[[0, 2], 12, 12].all() and not got[1, 12, 12], case


# ---- the threshold path: K4 as the Otsu histogram, configs #1 and #2 ----


def test_histogram_kernel(dev):
    """K4's fused histogram kernel against its plain version (bin ids, one
    bincount) on chip_smoke.hist_inputs, hist_edge_inputs and
    hist_bins_inputs (1 to 40000 bins: fewer warp tables a block past 1024
    bins, a launch a 16384-bin slice past that), also off a 16-byte
    boundary, with exactly one K4 launch a call and none of the table
    kernel; ``_histogram_batch`` and ``histogram`` on the card equal to the
    plain CPU run; on the non-finite planes against the table route (bin
    ids, K4's table kernel on uint8 zeros)."""
    from particle_col_image_segmentation_tpu_torch.ops import histogram
    from particle_col_image_segmentation_tpu_torch.ops.filters import as_float32
    from particle_col_image_segmentation_tpu_torch.ops.histogram_tiles import (
        _bin_index,
        bin_histogram,
        bin_histogram_cuda,
    )
    from particle_col_image_segmentation_tpu_torch.ops.threshold import (
        _histogram_batch,
        _value_range,
    )

    cases = [*((c, 256, xs) for c, xs in (*hist_inputs(), *hist_edge_inputs())),
             *hist_bins_inputs()]
    for case, bins, xs in cases:
        x = as_float32(torch.from_numpy(xs).to(dev))
        lo, span = _value_range(x)
        want = bin_histogram(x, lo, span, bins)
        for view in (x, off16(x)):
            before = (bin_histogram_cuda.launches, region_counts_cuda.launches)
            got = bin_histogram_cuda(view, lo, span, bins)
            assert (bin_histogram_cuda.launches, region_counts_cuda.launches) == (
                before[0] + 1, before[1]), case
            _equal([got], [want], case)
        before = bin_histogram_cuda.launches
        counts, centers = _histogram_batch(x, bins)
        assert bin_histogram_cuda.launches == before + 1, case
        _equal([counts], [want], case)
        cpu = x.cpu()
        _equal([counts.cpu(), centers.cpu()], list(_histogram_batch(cpu, bins)), case)
        _equal([t.cpu() for t in histogram(x[-1], bins)], list(histogram(cpu[-1], bins)), case)
    for case, xs in hist_nonfinite_inputs():
        x = torch.from_numpy(xs).to(dev)
        lo, span = _value_range(x)
        idx = _bin_index(x, lo, span, 256)
        zeros = torch.zeros(idx.shape, dtype=torch.uint8, device=dev)
        want = region_counts_cuda(idx, zeros, 255)[0]
        _equal([bin_histogram_cuda(x, lo, span, 256)], [want], case)
    x = torch.zeros((2, 8, 8), device=dev)
    lo, span = _value_range(x)
    with pytest.raises(ValueError, match="bins"):
        bin_histogram_cuda(x, lo, span, 0)
    with pytest.raises(ValueError, match="float32"):
        bin_histogram_cuda(x.to(torch.float16), lo, span, 256)


def _launches():
    """Launches of K2, K3, K4's table kernel and K4's histogram kernel."""
    return (ccl_cuda.launches, compact_labels_cuda.launches, region_counts_cuda.launches,
            bin_histogram_cuda.launches)


def _threshold_cases():
    c1 = config1_plane(256, discs=20)
    yield "config #1 single [256,256]", c1
    yield "config #1 batch [4,256,256]", np.stack([np.roll(c1, 7 * b, axis=1) for b in range(4)])
    yield "config #2 stack_stats [3,256,256]", config2_stack(3, 256, discs=8)


@pytest.mark.parametrize("case", [c for c, _ in _threshold_cases()])
def test_threshold_functions_through_the_kernels(dev, case):
    """threshold_and_count, threshold_and_count_batch and config #2's
    stack_stats on the card: K2 and K3 once a call and K4 twice (the fused
    histogram and the table), outputs on the card and equal to the plain
    versions on the card, thresholds bit for bit.  The single-plane
    ``histogram`` and ``otsu_threshold`` of the first plane launch K4's
    histogram once each and equal the plain CPU histogram and the call's
    threshold."""
    from particle_col_image_segmentation_tpu_torch.ops import (
        gaussian_blur,
        histogram,
        otsu_threshold,
        otsu_threshold_batch,
        threshold_and_count,
        threshold_and_count_batch,
    )

    img = dict(_threshold_cases())[case]
    x = torch.from_numpy(img).to(dev)
    before = _launches()
    if "single" in case:
        got = threshold_and_count(x, max_regions=4095)
        t, conv, want = plain_threshold(x, 4095)
    elif "batch" in case:
        got = threshold_and_count_batch(x, max_regions=4095)
        t, want = plain_threshold_batch(x.to(torch.float32), 4095)
        conv = want[5].all()
    else:
        blurs = gaussian_blur_cuda.launches
        den, got = stack_stats(x)
        assert gaussian_blur_cuda.launches == blurs + 1, case
        # config #2 rounds as bench.py's jitted graph: the contracted form
        _equal([den], [gaussian_blur(x.cpu(), 1.0, fma=True).to(dev)], case)
        t, want = plain_threshold_batch(den, 4095)
        conv = want[5].all()
    after = _launches()
    assert after == tuple(n + 1 for n in before), case
    assert all(g.device == x.device for g in got), case
    assert bool(conv), case
    _equal(got, want, case)
    if "single" not in case:
        src = x.to(torch.float32) if "batch" in case else den
        _equal([otsu_threshold_batch(src).view(torch.int32)], [t.view(torch.int32)], case)
    plane = x if "single" in case else src[0]
    before = _launches()
    counts, centers = histogram(plane)
    t0 = otsu_threshold(plane)
    assert _launches() == (*before[:3], before[3] + 2), case
    want_counts, want_centers = histogram(plane.cpu())
    _equal([counts, centers.view(torch.int32), t0.view(torch.int32)],
           [want_counts.to(dev), want_centers.to(dev).view(torch.int32),
            t.reshape(-1)[0].view(torch.int32)], case)


def test_the_otsu_graph_replays_the_eager_reduction(dev):
    """``_otsu_graphed``, the shared body's Otsu reduction replayed as one
    CUDA graph, on new counts and ranges of a captured shape at each call:
    cuts equal to the eager ``_otsu_from_range`` on the card and on the CPU
    bit for bit, at two plane counts and two bin counts, on a second
    stream (a graph of its own), and a cut handed back is not overwritten
    by a later replay."""
    from particle_col_image_segmentation_tpu_torch.ops import threshold as th

    gen = np.random.default_rng(29)
    for planes, bins in ((3, 256), (5, 256), (3, 1000)):
        cuts = []
        for _ in range(3):
            a, b = gen.normal(gen.uniform(-50, 50, 2)[:, None, None, None],
                              gen.uniform(1, 900, 2)[:, None, None, None], (2, planes, 64, 96))
            x = np.where(gen.random((planes, 64, 96)) < gen.uniform(0.1, 0.9), a, b)
            x = torch.from_numpy(x.astype(np.float32)).to(dev)
            lo, span = th._value_range(x)
            counts = bin_histogram_cuda(x, lo, span, bins)
            args = (counts, lo[..., 0], span[..., 0], bins)
            got = th._otsu_graphed(*args)
            want = th._otsu_from_range(*args)
            cpu = th._otsu_from_range(*(t.cpu() for t in args[:3]), bins)
            case = f"[{planes},64,96] at {bins} bins"
            _equal([got.view(torch.int32), got.cpu().view(torch.int32)],
                   [want.view(torch.int32), cpu.view(torch.int32)], case)
            cuts.append((got, want, case))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            cuts.append((th._otsu_graphed(*args), th._otsu_from_range(*args), case + " on a stream"))
        torch.cuda.current_stream(dev).wait_stream(side)
        for got, want, case in cuts:
            _equal([got.view(torch.int32)], [want.view(torch.int32)], case)


def test_config2_tiff_decode_to_card_stack_stats(dev, tmp_path):
    """Config #2's [24,512,512] stack written as a multi-page uint16 TIFF goes
    decode (the port's native codec) -> card -> stack_stats, equal to the
    plain CPU run of the same decoded stack, with K2, K3 and K4 (table and
    histogram) launched once each."""
    from particle_col_image_segmentation_tpu_torch.io import native
    from particle_col_image_segmentation_tpu_torch.io.tiff import read_tiff_stack

    stack = config2_stacks(1)[0]
    path = str(tmp_path / "stack_zstack.tif")
    write_tiff_pages(path, stack)
    assert native.available() and native.read_tiff(path) is not None
    a = read_tiff_stack(path)
    np.testing.assert_array_equal(a, stack)
    before = _launches()
    den, got = stack_stats(torch.from_numpy(a).to(dev))
    after = _launches()
    assert after == tuple(n + 1 for n in before)
    den_cpu, want = stack_stats(torch.from_numpy(a))
    assert torch.equal(den.cpu().view(torch.int32), den_cpu.view(torch.int32))
    assert bool(got[5].all()) and bool(want[5].all())
    for i in (0, 1, 2, 3, 4):  # mask, labels, count, num_fg, num_total
        assert torch.equal(got[i].cpu(), want[i]), i


@pytest.mark.parametrize("radius", [0, 1, 2, 20, 181])
def test_disk_morphology_and_edt_through_k9(dev, radius):
    """erode/open/close_disk (K9 on the card) against the plain transform
    on the card and on the CPU, and edt's float32 bits."""
    from particle_col_image_segmentation_tpu_torch.ops import (
        close_disk, edt, erode_disk, open_disk, sqrt_f32)

    m_np = _planes((3, 97, 130), 5) == 1
    m = torch.from_numpy(m_np).to(dev)
    plain = plain_morphology()
    for name, fn in (("erode_disk", erode_disk), ("open_disk", open_disk),
                     ("close_disk", close_disk)):
        got = fn(m, radius)
        _equal([got], [plain[name](m, radius)], name)
        assert torch.equal(got.cpu(), fn(torch.from_numpy(m_np), radius)), name
    _equal([edt(m, radius).view(torch.int32)],
           [sqrt_f32(edt_sq(m, radius)).view(torch.int32)])


def test_fill_holes_through_k2(dev):
    """fill_holes (K2 on the card) equals the plain fixpoint where that
    converges, reports converged, and ignores a budget the plain flood
    outlasts."""
    from particle_col_image_segmentation_tpu_torch.ops import fill_holes, fill_holes_fixpoint

    cases = {"planes": _planes((3, 97, 130), 9) == 1,
             "serpentine": np.stack([serpentine(97, 130), serpentine(97, 130, 6)])}
    for case, m_np in cases.items():
        m = torch.from_numpy(m_np).to(dev)
        want, conv = fill_holes_fixpoint(torch.from_numpy(m_np), with_flag=True)
        assert bool(conv), case
        got, got_conv = fill_holes(m, max_iters=3, with_flag=True)
        assert bool(got_conv) and got_conv.shape == (), case
        assert torch.equal(got.cpu(), want), case


def test_analyze_nanosims_card_equals_cpu(dev, tmp_path):
    """Config #4's acquisition at a cut size: the card's run equals the
    plain CPU run (ROI counts, labels, positions bit for bit, sums rtol
    1e-6)."""
    from particle_col_image_segmentation_tpu_torch.models import nanosims as ns

    painted, _ = config4_painting(300, 280, 20, 18, 40, 36)
    write_acquisition(str(tmp_path / "acq"), painted, seed=3)
    iso = ns.load_isotope_mats(str(tmp_path / "acq"))
    got = ns.analyze_nanosims(iso, painted, device=dev)
    want = ns.analyze_nanosims(iso, painted, device="cpu")
    for cls in ("red", "green"):
        g, w = getattr(got, cls), getattr(want, cls)
        assert g.num_rois == w.num_rois > 0
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.positions, w.positions)
        np.testing.assert_allclose(g.sums, w.sums, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.nearest, want.nearest)


def test_fused_multiply_adds_on_the_card_equal_the_cpu(dev):
    """fma_f32 on random, midpoint and special triples (and the NumPy rule),
    min_dist_to_set and nearest_neighbor_dists on the smoke's pairwise
    inputs (NaN rows, 8192 rows, an empty valid set), and the Otsu centres
    and thresholds at 3, 255, 256 and 1000 bins: the card's float32 bits
    equal the CPU run's, NaN where NaN."""
    from particle_col_image_segmentation_tpu_torch.ops.pairwise import (
        min_dist_to_set,
        nearest_neighbor_dists,
    )
    from particle_col_image_segmentation_tpu_torch.ops.rounding import fma_f32
    from particle_col_image_segmentation_tpu_torch.ops.threshold import (
        _centers,
        _value_range,
        otsu_threshold_batch,
    )

    for case, abc in (("random", fma_triples(n=1 << 16)), ("midpoints", midpoint_triples(5)),
                      ("specials", fma_specials())):
        cpu = [torch.from_numpy(v) for v in abc]
        got = fma_f32(*(v.to(dev) for v in cpu))
        assert same_f32(got, fma_f32(*cpu)), case
        assert same_f32(got, fma_f32_np(*abc)), case
    for case, a, b, valid in pairwise_inputs():
        cpu = [torch.from_numpy(v) for v in (a, b, valid)]
        assert same_f32(min_dist_to_set(*(v.to(dev) for v in cpu)), min_dist_to_set(*cpu)), case
        assert same_f32(nearest_neighbor_dists(cpu[1].to(dev), cpu[2].to(dev)),
                        nearest_neighbor_dists(cpu[1], cpu[2])), case
    x = torch.from_numpy(np.stack([*config2_stack(3, 128, discs=4),
                                   config1_plane(128, discs=4)])).to(torch.float32)
    lo, span = _value_range(x)
    for bins in (3, 255, 256, 1000):
        want = _centers(lo[..., 0], span[..., 0], bins)
        lo_d, span_d = _value_range(x.to(dev))
        assert same_f32(_centers(lo_d[..., 0], span_d[..., 0], bins), want), bins
        assert same_f32(otsu_threshold_batch(x.to(dev), bins), otsu_threshold_batch(x, bins)), bins


def _mesh_batch_planes():
    planes = {f"p{i}": synthetic_label_plane(seed=70 + i, shape=(192, 192)) for i in range(9)}
    planes["p3"][::7, ::5] = 1  # salt
    return planes


def _batch_stats(planes, **kw):
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig
    from particle_col_image_segmentation_tpu_torch.models.batch import run_batch

    got = dict(run_batch(list(planes), planes.__getitem__, AnalysisConfig(max_regions=1024),
                         batch_size=4, **kw))
    return {p: (s.num_regions, s.particle_px, s.cell_px, s.class_px.tolist(), s.overflow,
                s.converged) for p, s in got.items()}


def test_run_batch_on_an_emulated_mesh_and_refine_on_it(dev):
    """The data axis on ``cuda:0`` named twice (the real split, worker
    threads, kernels and gather on one card) equals the one-device run:
    run_batch's stats (the last batch's second chunk is padding), and
    refine_boundaries_sharded, tunnelled too, against refine_boundaries_stack;
    the launches add up over the workers."""
    from particle_col_image_segmentation_tpu_torch import RefineConfig
    from particle_col_image_segmentation_tpu_torch.models.refine import (
        refine_boundaries_sharded,
        refine_boundaries_stack,
    )
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh

    planes = _mesh_batch_planes()
    want = _batch_stats(planes, device=dev)
    median_label_filter_cuda.launches = 0
    assert _batch_stats(planes, mesh=make_mesh(n_data=2, devices=[dev] * 2)) == want
    assert median_label_filter_cuda.launches == 2 * 3  # two chunks a batch, three batches
    stack = np.stack([refine_relief(192, pairs=10, seed=s) for s in (1, 2, 3)])
    for cfg in (RefineConfig(), RefineConfig(tunnel_basins=True)):
        mesh = make_mesh(n_data=1 + (not cfg.tunnel_basins), n_space=1 + cfg.tunnel_basins,
                         devices=[dev] * 2)
        got = refine_boundaries_sharded(stack, cfg, mesh=mesh, stack=True)
        for g, w in zip(got, refine_boundaries_stack(stack, cfg, device=dev), strict=True):
            assert g.num_cells == w.num_cells
            for name in ("labels", "areas", "centroids", "nn_distances"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name), name)


def test_run_batch_on_two_cards(dev):
    """On a host with two cards, run_batch over both equals the one-device
    run (each chunk is launched under its own card's device guard)."""
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    planes = _mesh_batch_planes()
    want = _batch_stats(planes, device=dev)
    assert _batch_stats(planes, mesh=make_mesh(n_data=2)) == want


# ---- the space axis: the band modes, and the paths on emulated meshes ----


@pytest.mark.parametrize("n_space", [2, 4])
def test_band_mode_kernels(dev, n_space):
    """K1 on row-padded bands, K5 in the plane's rows and K8 counting its
    own rows (both routes), each band of a [2,192,192] batch against the
    plain version on the card (``chip_smoke.band_checks``)."""
    from chip_smoke import band_checks

    x = torch.from_numpy(_planes((2, 192, 192), seed=5)).to(dev)

    def compare(kernel, case, got, want):
        _equal(got, want, f"{kernel} {case}")

    band_checks(x, n_space, compare, f"[2,192,192] in {n_space} bands", max_regions=4096)


def test_space_axis_on_an_emulated_mesh(dev):
    """The space axis on ``cuda:0`` named 2 and 4 times equals the one-device
    run: run_batch's stats on 1x2 and 2x2 meshes, analyze_plane_device_sharded
    field for field, and the band-sharded DAPI dedup."""
    from particle_col_image_segmentation_tpu_torch import AnalysisConfig
    from particle_col_image_segmentation_tpu_torch.labels.analysis import (
        analyze_plane_device,
        analyze_plane_device_sharded,
        dapi_dedup_device,
    )
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh
    from particle_col_image_segmentation_tpu_torch.parallel.sharded import (
        make_sharded_dapi_dedup_fn,
    )

    planes = _mesh_batch_planes()
    want = _batch_stats(planes, device=dev)
    for nd, ns in ((1, 2), (2, 2)):
        assert _batch_stats(planes, mesh=make_mesh(nd, ns, devices=[dev] * (nd * ns))) == want
    cfg = AnalysisConfig(max_regions=1024)
    ct = ((1, "3D05"), (2, "Particle"), (3, "Background"))
    x = torch.from_numpy(planes["p3"]).to(dev)
    one = analyze_plane_device(x, ct, cfg)
    got = analyze_plane_device_sharded(x, ct, cfg, make_mesh(1, 4, devices=[dev] * 4))
    for name, g, w in zip(one._fields, got, one):
        for gg, ww in zip(*((list(g), list(w)) if name == "table" else ([g], [w]))):
            _equal([gg], [ww], name)
    other = torch.from_numpy(planes["p4"]).to(dev)
    dd, num, conv = make_sharded_dapi_dedup_fn(make_mesh(1, 2, devices=[dev] * 2), cfg)(
        x[None], other[None])
    _equal([dd[0]], [dapi_dedup_device(x, other, cfg)[0]], "dedup")
    assert bool(conv.all()) and int(num[0]) > 0


def test_space_axis_on_two_cards(dev):
    """On a host with two cards, a plane's rows split over both equal the
    one-device run (halo rows copied between the cards)."""
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    planes = _mesh_batch_planes()
    want = _batch_stats(planes, device=dev)
    assert _batch_stats(planes, mesh=make_mesh(n_data=1, n_space=2)) == want


# ---- the spatial refine's band modes and path --------------------------------


@pytest.mark.parametrize("n_space", [2, 4])
def test_refine_band_modes_equal_plain(dev, n_space):
    """K7 with a row offset, K9's flag over a band's own rows, K10 and K11
    resuming bands in every round of the band-coupled watershed, against
    their plain versions (``chip_smoke.refine_band_checks``), on three
    corridors whose flood crosses the seams."""
    from chip_smoke import refine_band_checks

    corr = [ws_corridor(96, 130, pitch=3 + i, seed=12 + i) for i in range(3)]
    img, mk, m = (torch.from_numpy(np.stack([c[k] for c in corr])).to(dev) for k in range(3))

    def compare(kernel, case, got, want):
        _equal(got, want, f"{kernel} {case}")

    refine_band_checks(img, mk, m, watershed_auto(img, mk, m), n_space, compare, "corridors")


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)])
def test_sharded_refine_on_the_card_equals_one_device(dev, mesh_shape):
    from particle_col_image_segmentation_tpu_torch import RefineConfig
    from particle_col_image_segmentation_tpu_torch.models.refine import refine_plane_device
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh, sharded

    x = torch.from_numpy(np.stack([refine_relief(256, pairs=12, seed=s)
                                   for s in range(2)])).to(dev)
    nd, ns = mesh_shape
    mesh = make_mesh(nd, ns, devices=[dev] * (nd * ns))
    labels, markers, num, conv, sums = sharded.make_sharded_refine_fn(
        mesh, with_tables=True)(x)
    w_labels, w_markers, w_num, table, _, w_conv = refine_plane_device(x, RefineConfig())
    assert bool(conv.all()) and bool(w_conv.all())
    _equal([labels, markers, num], [w_labels, w_markers, w_num])
    _equal([sums[..., i] for i in range(5)], list(table))


BLUR_CASES = {case: (u16, f32, shifted) for case, u16, f32, shifted in blur_inputs()}


@pytest.mark.parametrize("fma", [True, False])
@pytest.mark.parametrize("sigma", BLUR_SIGMAS)
@pytest.mark.parametrize("case", sorted(BLUR_CASES))
def test_blur_kernel(dev, case, sigma, fma):
    """The blur kernel against its plain version on the card, bit for bit,
    uint16 and float32, in the contracted and the op-by-op form, and
    ``gaussian_blur`` on the card launching it once."""
    from particle_col_image_segmentation_tpu_torch.ops import gaussian_blur

    u16, f32, shifted = BLUR_CASES[case]
    for a in (u16, f32):
        x = torch.from_numpy(a).to(dev)
        if shifted:
            x = off16(x.view(torch.int16)).view(x.dtype) if a is u16 else off16(x)
        want = plain_blur(x, sigma, fma)
        _equal([gaussian_blur_cuda(x, sigma, fma=fma).view(torch.int32)],
               [want.view(torch.int32)], case)
        before = gaussian_blur_cuda.launches
        _equal([gaussian_blur(x, sigma, fma=fma).view(torch.int32)], [want.view(torch.int32)],
               case)
        assert gaussian_blur_cuda.launches == before + 1


@pytest.mark.parametrize("sigma", BLUR_SIGMAS)
def test_blur_kernel_route(dev, sigma):
    """The register ring up to half-width ceil(2σ) = 5, the shared window
    past it (csrc/blur.cu), read from the kernel's name in a trace."""
    x = torch.zeros((2, 40, 64), device=dev)
    want = "blur_ring" if math.ceil(2 * sigma) <= 5 else "blur_window"
    assert blur_route(lambda: gaussian_blur_cuda(x, sigma)) == want


def test_blur_kernel_on_config2_stack_and_other_dtypes(dev):
    """Config #2's [24,512,512] stack through the kernel in both forms
    equals the plain version on the card and the CPU's; a uint8 or int16
    stack is cast to float32 first, a transposed uint16 view copied."""
    from particle_col_image_segmentation_tpu_torch.ops import gaussian_blur

    stack = config2_stack()
    x = torch.from_numpy(stack).to(dev)
    for fma in (True, False):
        got = gaussian_blur(x, 1.0, fma=fma)
        _equal([got.view(torch.int32)], [plain_blur(x, 1.0, fma).view(torch.int32)])
        assert torch.equal(got.cpu().view(torch.int32),
                           gaussian_blur(torch.from_numpy(stack), 1.0, fma=fma).view(torch.int32))
    small = stack[:2, :40, :50]
    for a in (small.astype(np.uint8), small.astype(np.int16)):
        got = gaussian_blur(torch.from_numpy(a).to(dev), 1.5, fma=True)
        assert torch.equal(got.cpu().view(torch.int32),
                           gaussian_blur(torch.from_numpy(a), 1.5, fma=True).view(torch.int32))
    t = torch.from_numpy(small).to(dev).transpose(-1, -2)
    assert torch.equal(gaussian_blur(t, 1.0).cpu().view(torch.int32),
                       gaussian_blur(torch.from_numpy(small).transpose(-1, -2), 1.0).view(
                           torch.int32))


def test_blur_kernel_refusals(dev):
    """A non-contiguous CUDA tensor, a dtype the kernel does not read and a
    σ past MAX_HALF raise; nothing launches."""
    x = torch.zeros((6, 4), device=dev)
    before = gaussian_blur_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        gaussian_blur_cuda(x.t(), 1.0)
    with pytest.raises(ValueError, match="expected uint16 or float32"):
        gaussian_blur_cuda(x.to(torch.int32), 1.0)
    with pytest.raises(ValueError, match="the tile's limit"):
        gaussian_blur_cuda(x, MAX_HALF / 2 + 0.01)
    assert gaussian_blur_cuda.launches == before
