"""Parity: the PyTorch port's thresholding (configs #1 and #2: histogram,
Otsu, threshold-and-count, Gaussian blur) against the JAX package.

Inputs are made with numpy from a seed (the bench's recipes at small sizes,
through ``chip_smoke``'s recipe helpers) and handed to both packages.  The
tolerance is 0 throughout: counts, masks, labels and flags are integers, and
thresholds, bin centres and blurred values are compared as float32 bit
patterns.  The JAX side runs with x64 off, as the JAX package is used, and
on the CPU, where its histogram is a scatter and its CCL the XLA fixpoint.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import threshold as jax_threshold
from particle_col_image_segmentation_tpu.ops.filters import gaussian_blur as jax_blur
from particle_col_image_segmentation_tpu_torch.ops import (
    gaussian_blur,
    histogram,
    otsu_threshold,
    otsu_threshold_batch,
    region_counts_cuda,
    threshold_and_count,
    threshold_and_count_batch,
)
from particle_col_image_segmentation_tpu_torch.ops import threshold as port_threshold

from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch.ops.filters import as_float32
from particle_col_image_segmentation_tpu_torch.ops.histogram_tiles import bin_histogram

from chip_smoke import (
    config1_plane,
    config2_stack,
    config2_stacks,
    hist_bins_inputs,
    hist_edge_inputs,
    hist_inputs,
    stack_stats,
)


@pytest.fixture(autouse=True)
def x64_off():
    """Another module in the same worker could have turned x64 on, which
    would move the JAX Otsu reduction to float64."""
    assert jax.config.jax_enable_x64 is False


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float32, a.dtype
    return a.view(np.int32)


def _bimodal():
    """The JAX package's Otsu oracle input (tests/test_ops_morphology.py)."""
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal(80, 10, 3000), rng.normal(180, 12, 2000)]
                          ).reshape(50, 100).astype(np.float32)


def _batch_with_constant():
    """The JAX package's [5,64,128] batch with a constant plane
    (tests/test_ops_morphology.py)."""
    rng = np.random.default_rng(4)
    imgs = rng.normal(900.0, 200.0, (5, 64, 128)).astype(np.float32)
    imgs[1] = 3.0
    imgs[2, :32] += 4000.0
    return imgs


def _extremes():
    """uint16 0 and 65535 with a few values between."""
    img = np.zeros((33, 47), np.uint16)
    img[:, 20:] = 65535
    img[5, :7] = [1, 2, 300, 32768, 65534, 65533, 40000]
    return img


PLANES = {
    "bimodal float32 [50,100]": _bimodal,
    "config-1 uint16 [128,128]": lambda: config1_plane(128, discs=10),
    "1x1": lambda: np.array([[7]], np.uint16),
    "uint16 0 and 65535 [33,47]": _extremes,
    "constant [9,11]": lambda: np.full((9, 11), 3.0, np.float32),
    "normal float32 [64,128]": lambda: _batch_with_constant()[0],
}


def _as_torch(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img))


@pytest.mark.parametrize("case", sorted(PLANES))
def test_histogram_and_otsu_match_jax(case):
    img = PLANES[case]()
    counts, centers = histogram(_as_torch(img))
    want_counts, want_centers = jax_threshold.histogram(jnp.asarray(img))
    assert counts.dtype == torch.int32 and counts.shape == (256,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(_bits(centers.numpy()), _bits(want_centers))
    t = otsu_threshold(_as_torch(img))
    assert t.shape == ()
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(jax_threshold.otsu_threshold(jnp.asarray(img))))


BATCHES = {
    "[5,64,128] with a constant plane": _batch_with_constant,
    "config-1 [4,128,128] rolled 7·b": lambda: np.stack(
        [np.roll(config1_plane(128, discs=10), 7 * b, axis=1) for b in range(4)]),
    "1x1 planes [3,1,1]": lambda: np.array([7, 0, 65535], np.uint16).reshape(3, 1, 1),
    "config-2 [3,96,130]": lambda: config2_stack(3, 130, discs=6)[:, :96],
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_histogram_batch_and_otsu_batch_match_jax(case):
    imgs = np.ascontiguousarray(BATCHES[case]())
    x = _as_torch(imgs)
    counts, centers = port_threshold._histogram_batch(x.to(torch.float32), 256)
    want_counts, want_centers = jax_threshold._histogram_batch(jnp.asarray(imgs, jnp.float32), 256)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(_bits(centers.numpy()), _bits(want_centers))
    t = otsu_threshold_batch(x)
    np.testing.assert_array_equal(_bits(t.numpy()),
                                  _bits(jax_threshold.otsu_threshold_batch(jnp.asarray(imgs))))
    # each plane's threshold is the single-plane call's
    for b in range(len(imgs)):
        np.testing.assert_array_equal(_bits(t[b].numpy()), _bits(otsu_threshold(x[b]).numpy()))


HIST_CASES = {
    **{case: (256, xs) for inputs in (hist_inputs, hist_edge_inputs) for case, xs in inputs()},
    **{case: (bins, xs) for case, bins, xs in hist_bins_inputs()},
}


# JAX's ``_histogram_batch`` as its jitted callers compile it
_jax_histogram_batch = jax.jit(jax_threshold._histogram_batch, static_argnames="bins")


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_bin_histogram_matches_jax(case):
    """The fused histogram kernel's plain version (bin ids, one bincount),
    ``_histogram_batch`` and the single-plane ``histogram`` of the last plane
    against the JAX package's ``_histogram_batch`` (jitted, as
    ``otsu_threshold_batch`` runs it) and ``histogram``, tolerance 0, on the
    smoke's histogram inputs: bin edges and one ulp either side, x == hi, a
    constant plane, a span clamped to 1e-12, negative values, uint16 and
    float16 planes (cast as ``astype(jnp.float32)`` casts them), and bin
    edges at 1 to 40000 bins.  The centres are XLA's fma((i + 0.5) · span,
    float32(1 / bins), lo) at every ``bins``."""
    bins, xs = HIST_CASES[case]
    xs = np.ascontiguousarray(xs)
    x = as_float32(_as_torch(xs))
    lo, span = port_threshold._value_range(x)
    got = bin_histogram(x, lo, span, bins)
    want, want_centers = _jax_histogram_batch(jnp.asarray(xs).astype(jnp.float32), bins)
    assert got.dtype == torch.int32 and got.shape == (xs.shape[0], bins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts, centers = port_threshold._histogram_batch(x, bins)
    np.testing.assert_array_equal(counts.numpy(), got.numpy())
    np.testing.assert_array_equal(_bits(centers.numpy()), _bits(want_centers))
    assert int(got.sum()) == xs.size
    counts, centers = histogram(x[-1], bins)
    want, want_centers = jax_threshold.histogram(jnp.asarray(xs[-1]), bins)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_bits(centers.numpy()), _bits(want_centers))


def _divided_centers(img: np.ndarray, bins: int) -> np.ndarray:
    """lo + (i + 0.5) · span / bins with each float32 op rounded apart: the
    port's centres before they were rounded as XLA's fma."""
    x = img.astype(np.float32)
    lo = x.min()
    span = np.maximum(x.max() - lo, np.float32(1e-12))
    i = np.arange(bins, dtype=np.float32)
    return lo + (i + np.float32(0.5)) * span / np.float32(bins)


@pytest.mark.parametrize("bins", [1, 3, 7, 100, 255, 256, 1000, 40000])
def test_otsu_at_any_bins_matches_jax_jitted(bins):
    """``histogram``, ``otsu_threshold`` and ``otsu_threshold_batch`` against
    JAX's jitted entry points at ``bins`` bins: counts, centres and
    thresholds bit for bit, on the bimodal plane, a config #1 plane and the
    [5,64,128] batch with a constant plane.  Where ``bins`` is not a power
    of two (and above 2), the centres in the written order differ from
    JAX's on some plane, which the test asserts: the port's earlier centres
    fail it."""
    differ = 0
    for img in (_bimodal(), config1_plane(128, discs=10)):
        counts, centers = histogram(_as_torch(img), bins)
        want_counts, want_centers = jax_threshold.histogram(jnp.asarray(img), bins)
        assert counts.shape == centers.shape == (bins,)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
        np.testing.assert_array_equal(_bits(centers.numpy()), _bits(want_centers))
        np.testing.assert_array_equal(
            _bits(otsu_threshold(_as_torch(img), bins).numpy()),
            _bits(jax_threshold.otsu_threshold(jnp.asarray(img), bins)))
        differ += int((_bits(_divided_centers(img, bins)) != _bits(want_centers)).sum())
    imgs = _batch_with_constant()
    counts, centers = port_threshold._histogram_batch(_as_torch(imgs), bins)
    want_counts, want_centers = _jax_histogram_batch(jnp.asarray(imgs), bins)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(_bits(centers.numpy()), _bits(want_centers))
    np.testing.assert_array_equal(
        _bits(otsu_threshold_batch(_as_torch(imgs), bins).numpy()),
        _bits(jax_threshold.otsu_threshold_batch(jnp.asarray(imgs), bins)))
    if bins > 2 and bins & (bins - 1):
        assert differ > 0
    else:
        assert differ == 0


def test_threshold_path_reaches_no_kernel_on_the_cpu(monkeypatch):
    """On CPU tensors the threshold path takes the plain versions: no K1-K12
    wrapper launches, and the histogram kernel's wrapper is never called."""

    def refuse(*args, **kwargs):
        raise AssertionError("the histogram kernel's wrapper was called on a CPU tensor")

    monkeypatch.setattr(port_threshold, "bin_histogram_cuda", refuse)
    reset_counts, read_counts = _kernels.launch_counters()
    saved = {fn: fn.launches for fns in _kernels.launch_counter_table().values() for fn in fns}
    try:
        reset_counts()
        c1 = config1_plane(128, discs=10)
        x = _as_torch(c1)
        histogram(x)
        otsu_threshold(x)
        threshold_and_count(x, max_regions=4095)
        threshold_and_count_batch(_as_torch(np.stack([c1, c1[::-1]])), max_regions=4095)
        stack_stats(_as_torch(config2_stack(2, 64, discs=4)))
        assert set(read_counts().values()) == {0}
    finally:
        for fn, n in saved.items():
            fn.launches = n


@pytest.mark.parametrize("n", [1, 5, 16, 17, 255, 256, 257, 1000, 4097])
def test_prefix_sum_is_jnp_cumsum_on_the_cpu(n):
    """The Otsu prefix sums' fixed order equals XLA's CPU ``jnp.cumsum`` bit
    for bit, on 1-D and batched float32 rows with mixed magnitudes and
    signs."""
    rng = np.random.default_rng(n)
    x = (rng.random((3, n)) * 1000 * rng.random((3, n)) - 100).astype(np.float32)
    x[:, ::7] = 0.0
    got = port_threshold._prefix_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jnp.cumsum(jnp.asarray(x), axis=-1)))
    np.testing.assert_array_equal(_bits(port_threshold._prefix_sum(torch.from_numpy(x[0])).numpy()),
                                  _bits(jnp.cumsum(jnp.asarray(x[0]))))


def test_otsu_near_tie_of_config2_plane6_matches_jax():
    """Plane 6 of config #2's blurred [24,512,512] stack (bench.py's recipe,
    seed 2) holds a near-tie: cuts at bins 61 and 62 score within 1.5e-7 of
    each other, one non-empty bin apart.  Summed in XLA's CPU order (the
    port's) bin 61 wins, as in the JAX package; ``torch.cumsum``'s order
    picks bin 62."""
    plane = config2_stack()[6:7]
    den = gaussian_blur(_as_torch(plane), 1.0)
    np.testing.assert_array_equal(_bits(den.numpy()), _bits(jax_blur(jnp.asarray(plane), 1.0)))
    t = otsu_threshold_batch(den)
    np.testing.assert_array_equal(_bits(t.numpy()),
                                  _bits(jax_threshold.otsu_threshold_batch(jnp.asarray(den.numpy()))))
    counts, centers = port_threshold._histogram_batch(den, 256)
    assert float(t[0]) == float(centers[0, 61])
    c = counts.to(torch.float32)
    w0 = torch.cumsum(c, -1)
    m = torch.cumsum(c * centers, -1)
    w1 = w0[..., -1:] - w0
    d = m / w0.clamp_min(1e-12) - (m[..., -1:] - m) / w1.clamp_min(1e-12)
    var_b = torch.where((w0 > 0) & (w1 > 0), w0 * w1 * (d * d), -1.0)
    assert int(var_b.argmax()) == 62


def _single_cases():
    yield "config-1 uint16 [128,128]", config1_plane(128, discs=10), 4096
    yield "config-1 uint16 [128,128] max_regions=8 (overflow)", config1_plane(128, discs=10), 8
    yield "bimodal float32 [50,100]", _bimodal(), 4096
    yield "uint16 0 and 65535 [33,47]", _extremes(), 4096
    yield "1x1", np.array([[7]], np.uint16), 4096


SINGLE = {case: (img, mr) for case, img, mr in _single_cases()}


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_threshold_and_count_matches_jax(case):
    img, max_regions = SINGLE[case]
    before = region_counts_cuda.launches
    got = threshold_and_count(_as_torch(img), max_regions=max_regions)
    assert region_counts_cuda.launches == before  # the CPU takes the plain versions
    want = jax_threshold.threshold_and_count(jnp.asarray(img), max_regions=max_regions)
    for name, g, w in zip(("mask", "seg", "count", "num"), got, want, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{case}: {name}")


def _serpentine_stack():
    """Plane 0's foreground is a 1-px serpentine over 256 rows, its
    background one comb-shaped component; plane 1 is bench noise and
    particles."""
    serp = np.zeros((256, 64), np.float32)
    serp[::2] = 1000.0
    serp[1::4, -1] = serp[3::4, 0] = 1000.0
    other = config1_plane(64, discs=4)[:, :64].astype(np.float32)
    return np.stack([serp, np.resize(other, (256, 64))])


STACKS = {
    "config-1 [4,128,128] rolled 7·b, max_regions 4095": (BATCHES["config-1 [4,128,128] rolled 7·b"], 4095),
    "config-1 [2,128,128] max_regions 8 (overflow)": (
        lambda: BATCHES["config-1 [4,128,128] rolled 7·b"]()[:2], 8),
    "[5,64,128] with a constant plane": (_batch_with_constant, 4096),
    "serpentine [2,256,64]": (_serpentine_stack, 4096),
    "1x1 planes [3,1,1]": (BATCHES["1x1 planes [3,1,1]"], 4096),
}


@pytest.mark.parametrize("case", sorted(STACKS))
def test_threshold_and_count_batch_matches_jax(case):
    make, max_regions = STACKS[case]
    imgs = np.ascontiguousarray(make())
    got = threshold_and_count_batch(_as_torch(imgs), max_regions=max_regions)
    want = jax_threshold.threshold_and_count_batch(jnp.asarray(imgs), max_regions=max_regions)
    names = ("mask", "seg", "count", "num_fg", "num_total", "converged")
    for name, g, w in zip(names, got, want, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{case}: {name}")
    if "overflow" in case:
        assert (got[4] > max_regions).any()


@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.3, 2.5, 2.6])
@pytest.mark.parametrize("shape", [(61, 77), (3, 37, 53), (2, 5, 130), (1, 1, 1)])
def test_gaussian_blur_matches_jax(shape, sigma):
    img = np.random.default_rng(len(shape) + int(10 * sigma)).integers(0, 65535, shape).astype(np.uint16)
    got = gaussian_blur(_as_torch(img), sigma)
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jax_blur(jnp.asarray(img), sigma)))


@jax.jit
def _jax_stack_stats(x):
    """bench.py's jitted stack_stats graph (bench.py:326-330), returning the
    blurred stack beside the six outputs."""
    den = jax_blur(x.astype(jnp.float32), sigma=1.0)
    return den, jax_threshold.threshold_and_count_batch(den, max_regions=4095)


def test_stack_stats_matches_jax():
    """Config #2's compute (bench.py's stack_stats: blur σ 1, then
    threshold_and_count_batch at max_regions 4095) on two [3,96,130] stacks
    of the bench's recipe, against the graph as bench.py runs it: under
    ``jax.jit``, whose XLA code contracts the blur into FMAs (the port's
    ``fma=True``).  The blur and all six outputs, bit for bit."""
    for stack in config2_stacks(2, 130, discs=6, planes=3):
        stack = stack[:, :96].copy()
        den, got = stack_stats(_as_torch(stack))
        want_den, want = _jax_stack_stats(jnp.asarray(stack))
        np.testing.assert_array_equal(_bits(den.numpy()), _bits(want_den))
        for g, w in zip(got, want, strict=True):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), w)
        assert (got[2] > 0).all()


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16", "int32", "float32", "float64"])
def test_every_input_dtype_matches_jax(dtype):
    """Each dtype the port takes is cast to float32 as ``astype(jnp.float32)``
    casts it (uint16 through its int16 view)."""
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype) if np.dtype(dtype).kind in "iu" else None
    lo, hi = (info.min, info.max) if info else (-1e4, 1e4)
    img = rng.uniform(lo, hi, (2, 23, 31)).astype(dtype)
    img[0, 0, :2] = [lo, hi]
    x = torch.from_numpy(img)
    np.testing.assert_array_equal(_bits(otsu_threshold_batch(x).numpy()),
                                  _bits(jax_threshold.otsu_threshold_batch(jnp.asarray(img))))
    np.testing.assert_array_equal(_bits(gaussian_blur(x, 1.0).numpy()),
                                  _bits(jax_blur(jnp.asarray(img), 1.0)))


def test_inputs_are_checked():
    with pytest.raises(ValueError, match="expected one of"):
        otsu_threshold(torch.zeros((4, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        otsu_threshold_batch(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        threshold_and_count_batch(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        threshold_and_count(torch.zeros((1, 4, 4)))


@pytest.mark.parametrize("n", [128, 257])
def test_config_recipes_draw_the_bench_planes(n):
    """The windowed particle draws equal the bench's full-plane masks."""
    rng = np.random.default_rng(1)
    img = (rng.random((n, n)) * 400).astype(np.uint16)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(40):
        cy, cx = rng.integers(20, n - 20, 2)
        r2 = int(rng.integers(30, 200))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r2] += 20000
    np.testing.assert_array_equal(config1_plane(n), img)


def test_config2_stacks_draw_the_bench_stacks():
    """config2_stacks draws bench_config2's stacks in sequence from one
    generator; config2_stack is its first."""
    n, planes = 128, 3
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:n, :n]
    want = []
    for _ in range(2):
        stack = (rng.random((planes, n, n)) * 400).astype(np.uint16)
        for p in range(planes):
            for _ in range(30):
                cy, cx = rng.integers(20, n - 20, 2)
                r2 = int(rng.integers(30, 200))
                stack[p][(yy - cy) ** 2 + (xx - cx) ** 2 <= r2] += 20000
        want.append(stack)
    got = config2_stacks(2, n, 30, planes)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(config2_stack(planes, n), want[0])
