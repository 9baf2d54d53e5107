"""Parity: the PyTorch port's tunnelled watershed (``tunnel_basins=True``)
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, on the
fixtures of the JAX package's ``TestWatershedTunnelBasins``
(``tests/test_ops_core.py``): the hand-traced 1×12 golden, 128² sparse point
seeds on an 8-level relief, the pipeline regime and a [2,1,12] batch.
Labels, basin segments and ``converged`` flags are integers or booleans:
tolerance 0.  Boundary IoU is scored by each package against its own
oracle priority flood, and the two scores must be equal.
"""

import importlib

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.ccl import connected_components as jax_ccl
from particle_col_image_segmentation_tpu.oracle import ndimage as jax_ond
from particle_col_image_segmentation_tpu.utils.metrics import boundary_iou as jax_iou
from particle_col_image_segmentation_tpu_torch.oracle import ndimage as ond
from particle_col_image_segmentation_tpu_torch.utils.metrics import boundary_iou

from chip_smoke import sparse_seeds
from test_torch_watershed import bench_relief, markers_of, quantize16

# the modules (each package's ``ops`` exports a function of the same name)
jax_ws = importlib.import_module("particle_col_image_segmentation_tpu.ops.watershed")
ws = importlib.import_module("particle_col_image_segmentation_tpu_torch.ops.watershed")


def golden():
    """The quantized-basin golden: the wave tunnels the 3-px basin, so
    marker 1 takes 8 of the 12 cells."""
    img = np.array([[2.0, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2]], np.float32)
    mk = np.zeros((1, 12), np.int32)
    mk[0, 0], mk[0, 11] = 1, 2
    return img, mk, None


def sparse8():
    """Unconfined sparse point seeds on an 8-level-quantized noise relief."""
    return (*sparse_seeds(), None)


def pipeline(n: int = 128, k: int = 8):
    """EDT-seeded markers confined to the object mask of a k-level relief."""
    rng = np.random.default_rng(1)
    m = np.zeros((n, n), bool)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(6):
        cy, cx = rng.integers(25, n - 25, 2)
        r2 = int(rng.integers(80, 200))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        m |= (yy - cy) ** 2 + (xx - cx - int(1.5 * np.sqrt(r2))) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    prob = (1.0 - dist / max(1.0, dist.max())).astype(np.float32)
    q = (np.round(prob * (k - 1)) / (k - 1)).astype(np.float32)
    binary = q < 0.5
    mk = jax_ond.label(jax_ond.local_maxima(ndi.distance_transform_edt(binary)).astype(np.uint8))
    return q, np.asarray(mk).astype(np.int32), binary


def batched():
    """Two 1×12 planes whose basins sit at different places."""
    img_a, mk, _ = golden()
    img_b = np.array([[2.0, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2]], np.float32)
    return np.stack([img_a, img_b]), np.stack([mk, mk]), None


def bench_q16(n: int = 128):
    """The bench's touching-cell relief, 16 levels, refine's seeds."""
    prob = bench_relief(n)
    mk, mask = markers_of(prob)
    return quantize16(prob), mk, mask


FIXTURES = {"golden": golden, "sparse8": sparse8, "pipeline": pipeline, "batched": batched,
            "bench_q16": bench_q16}


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def run_both(img, mk, mask, **kw):
    """(port labels, port flag, JAX labels, JAX flag) as numpy."""
    got, gconv = ws.watershed(_t(img), _t(mk), _t(mask), with_flag=True, **kw)
    want, wconv = jax_ws.watershed(_j(img), _j(mk), _j(mask), with_flag=True, **kw)
    return got.numpy(), gconv.numpy(), np.asarray(want), np.asarray(wconv)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_tunnel_matches_jax(name, connectivity):
    img, mk, mask = FIXTURES[name]()
    got, gconv, want, wconv = run_both(img, mk, mask, connectivity=connectivity,
                                       max_iters=4096, tunnel_basins=True)
    assert got.dtype == np.int32 and gconv.shape == wconv.shape == img.shape[:-2]
    assert gconv.all() and wconv.all()
    np.testing.assert_array_equal(got, want)
    auto = ws.watershed_auto(_t(img), _t(mk), _t(mask), connectivity=connectivity,
                             max_iters=4096, tunnel_basins=True)
    np.testing.assert_array_equal(auto.numpy(), got)


@pytest.mark.parametrize("name", ["golden", "batched"])
def test_tunnel_golden_equals_the_oracle(name):
    """The golden separates the keys: the tunnel gives the priority flood's
    labels exactly, the default key does not."""
    img, mk, _ = FIXTURES[name]()
    tun = ws.watershed(_t(img), _t(mk), tunnel_basins=True).numpy()
    base = ws.watershed(_t(img), _t(mk)).numpy()
    planes = [(img, mk, tun, base)] if img.ndim == 2 else zip(img, mk, tun, base)
    for p_img, p_mk, p_tun, p_base in planes:
        orc = ond.watershed(p_img, p_mk)
        np.testing.assert_array_equal(p_tun, orc)
        np.testing.assert_array_equal(orc, jax_ond.watershed(p_img, p_mk))
    assert not (base == tun).all()


@pytest.mark.parametrize("name", ["sparse8", "pipeline", "bench_q16"])
def test_tunnel_quality_against_the_oracle_equals_jax(name):
    """Boundary IoU of the port's labels against the port's oracle equals
    the JAX package's against its own, for both keys; the tunnel lifts the
    sparse-seed fixture by at least 0.2 and leaves the confined regimes'
    IoU where the default key has it (within 0.005)."""
    img, mk, mask = FIXTURES[name]()
    orc = ond.watershed(img, mk, mask=mask)
    np.testing.assert_array_equal(orc, jax_ond.watershed(img, mk, mask=mask))
    iou = {}
    for tunnel in (False, True):
        got, _, want, _ = run_both(img, mk, mask, max_iters=4096, tunnel_basins=tunnel)
        iou[tunnel] = boundary_iou(got, orc)
        assert iou[tunnel] == jax_iou(want, jax_ond.watershed(img, mk, mask=mask))
    if name == "sparse8":
        assert iou[True] >= iou[False] + 0.2 and iou[True] >= 0.7, iou
    else:
        assert iou[True] >= iou[False] - 0.005, iou


@pytest.mark.parametrize("max_iters", [1, 3, 12])
@pytest.mark.parametrize("name", ["sparse8", "pipeline", "batched"])
def test_tunnel_budget_runs_out_like_jax(name, max_iters):
    """Too few steps: the planes report unconverged on both sides, with the
    same labels (the Jacobi loops are the JAX package's step for step)."""
    img, mk, mask = FIXTURES[name]()
    got, gconv, want, wconv = run_both(img, mk, mask, max_iters=max_iters,
                                       tunnel_basins=True)
    np.testing.assert_array_equal(gconv, wconv)
    np.testing.assert_array_equal(got, want)
    if name != "batched" or max_iters == 1:
        assert not gconv.any()


def _jax_segments(img, mk, mask, connectivity):
    """The JAX package's seg and inc (``ops/watershed.py``'s tunnel branch),
    computed with its phase-1 costs and its CCL."""
    im = jnp.asarray(img)
    m = jnp.ones(im.shape, bool) if mask is None else jnp.asarray(mask)
    seeded = (jnp.asarray(mk) > 0) & m
    cost0 = jnp.where(seeded, im, jnp.float32(jax_ws._INF))
    cost = cost0
    for _ in range(4096):
        best = cost
        for dy, dx in jax_ws._offsets(connectivity):
            best = jnp.minimum(best, jnp.maximum(
                jax_ws._shifted(cost, dy, dx, jnp.float32(jax_ws._INF)), im))
        new = jnp.where(seeded, cost0, jnp.where(m, best, jnp.float32(jax_ws._INF)))
        if bool(jnp.all(new == cost)):
            break
        cost = new
    H, W = img.shape[-2:]
    at_level = im == cost
    below = m & ~seeded & ~at_level & (cost < jax_ws._INF)
    comp, conv = jax_ccl(below.astype(jnp.int32), background=0,
                         connectivity=4 if connectivity == 1 else 8, num_classes=2,
                         with_flag=True)
    lin = (jax.lax.broadcasted_iota(jnp.int32, im.shape, im.ndim - 2) * W
           + jax.lax.broadcasted_iota(jnp.int32, im.shape, im.ndim - 1))
    seg = jnp.where(below, comp, lin).reshape((-1, H, W))
    seg = seg + (jnp.arange(seg.shape[0], dtype=jnp.int32) * (H * W)).reshape((-1, 1, 1))
    return (np.asarray(cost), np.asarray(seg).reshape(img.shape),
            np.asarray(at_level.astype(jnp.int32)), np.asarray(conv))


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("name", ["sparse8", "pipeline", "batched"])
def test_basin_segments_match_jax(name, connectivity):
    img, mk, mask = FIXTURES[name]()
    cost, seg, inc, conv = _jax_segments(img, mk, mask, connectivity)
    t_img, t_mk = _t(img), _t(mk)
    m = torch.ones(t_img.shape, dtype=torch.bool) if mask is None else _t(mask)
    seeded = (t_mk > 0) & m
    got_cost, _ = ws.minimax_costs(t_img, m, seeded, connectivity, 4096)
    np.testing.assert_array_equal(got_cost.numpy(), cost)
    g_seg, g_inc, g_conv = ws.basin_segments(got_cost, t_img, m, seeded, connectivity)
    assert g_seg.dtype == g_inc.dtype == torch.int32
    np.testing.assert_array_equal(g_seg.numpy(), seg)
    np.testing.assert_array_equal(g_inc.numpy(), inc)
    np.testing.assert_array_equal(g_conv.numpy(), conv)
    if name != "pipeline":  # there, no below-level pixel lies outside a marker's cell
        assert len(np.unique(seg)) < seg.size  # a basin of several pixels


def test_segment_broadcast_is_the_lexicographic_minimum():
    """Every pixel gets its segment's least (d, e, s, lab), with ties in d,
    e and s broken by the next key; checked against a per-segment sort."""
    rng = np.random.default_rng(8)
    n = 4000
    seg = rng.integers(0, 300, n)
    d = rng.integers(0, 3, n).astype(np.int32)
    e = rng.integers(0, 3, n).astype(np.float32)
    s = rng.integers(0, 2, n).astype(np.float32)
    lab = rng.integers(1, 50, n).astype(np.int32)
    dm, em, lm = ws._segment_broadcast(torch.from_numpy(seg), *map(torch.from_numpy, (d, e, s, lab)))
    for sid in np.unique(seg):
        idx = np.flatnonzero(seg == sid)
        best = min(zip(d[idx], e[idx], s[idx], lab[idx]))
        assert (dm.numpy()[idx] == best[0]).all() and (em.numpy()[idx] == best[1]).all()
        assert (lm.numpy()[idx] == best[3]).all()


@pytest.mark.parametrize("tunnel", [False, True], ids=["pixel-graph", "quotient-graph"])
def test_claim_candidates_match_jax(tunnel):
    """One candidate set per offset, port against the JAX package's
    ``claim_candidates`` on the same state: with the defaults (``inc`` 1,
    no ``seg``) and with the quotient graph's ``inc`` and ``seg``."""
    rng = np.random.default_rng(6)
    shape = (2, 9, 11)
    cost = rng.integers(0, 4, shape).astype(np.float32)
    img = np.minimum(cost, rng.integers(0, 4, shape).astype(np.float32))
    lab = np.where(rng.random(shape) < 0.6, rng.integers(1, 6, shape), jax_ws._BIG_LAB)
    dist = np.where(rng.random(shape) < 0.8, rng.integers(0, 9, shape), jax_ws._BIG_LAB)
    eimg = rng.integers(0, 4, shape).astype(np.float32)
    seg = rng.integers(0, 20, shape).astype(np.int32) if tunnel else None
    inc = (rng.random(shape) < 0.5).astype(np.int32) if tunnel else 1
    state = (cost, img, lab.astype(np.int32), dist.astype(np.int32), eimg)
    for dy, dx in ws._offsets(2):
        got = ws.claim_candidates(*map(torch.from_numpy, state), dy, dx,
                                  inc=_t(inc) if tunnel else 1, seg=_t(seg))
        want = jax_ws.claim_candidates(*map(jnp.asarray, state), dy, dx, jax_ws._shifted,
                                       inc=_j(inc) if tunnel else 1, seg=_j(seg))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
