"""Parity: the PyTorch port's watershed and local maxima (the plain versions
behind K10/K11 and K2's plateau use) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  Labels,
maxima and ``converged`` flags are integers or booleans, so the tolerance is
exact equality.  The JAX side runs its XLA fixpoints and, kept small because
interpret mode is slow, its Pallas band sweeps in interpret mode
(``watershed_sweeps(tile=32)``, ``_local_maxima_sweeps``).
"""

import importlib

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import scans as jax_scans
from particle_col_image_segmentation_tpu.ops.morphology import (
    _local_maxima_sweeps,
    local_maxima as jax_local_maxima,
)
from particle_col_image_segmentation_tpu.ops.watershed import watershed as jax_watershed
from particle_col_image_segmentation_tpu.ops.watershed_tiles import watershed_sweeps
from particle_col_image_segmentation_tpu.oracle import ndimage as ond
from particle_col_image_segmentation_tpu_torch.ops.morphology import (
    local_maxima,
    local_maxima_auto,
)
from particle_col_image_segmentation_tpu_torch.ops.scans import seg_or_scan_bidi
from particle_col_image_segmentation_tpu_torch.ops.watershed import watershed, watershed_auto
from particle_col_image_segmentation_tpu_torch.ops.watershed_tiles import (
    passes_from_history,
    watershed_cuda,
)


def bench_relief(n: int = 128, pairs: int = 30, seed: int = 0, margin: int = 40,
                 r2_range=(150, 400)) -> np.ndarray:
    """The bench's touching-cell relief (``bench.py`` config #3): ``pairs``
    touching disc pairs with centres in [margin, n−margin), r² in
    ``r2_range``, and prob = 1 − edt/max.  The defaults are the bench's."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), bool)
    yy, xx = np.mgrid[:n, :n]
    for _ in range(pairs):
        cy, cx = rng.integers(margin, n - margin, 2)
        r2 = int(rng.integers(*r2_range))
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
        m |= (yy - cy) ** 2 + (xx - cx - int(1.5 * np.sqrt(r2))) ** 2 <= r2
    dist = ndi.distance_transform_edt(m)
    return (1.0 - dist / max(1.0, dist.max())).astype(np.float32)


def quantize16(prob: np.ndarray) -> np.ndarray:
    """The bench's 16-level quantization of a relief."""
    return (np.round(prob * 15.0) / 15.0).astype(np.float32)


def markers_of(prob: np.ndarray):
    """(markers int32, mask bool) as refine seeds them: labelled local maxima
    of the EDT of the object mask prob < 0.5."""
    mask = prob < 0.5
    mk = ond.label(ond.local_maxima(ndi.distance_transform_edt(mask)).astype(np.uint8))
    return np.asarray(mk).astype(np.int32), mask


def _both(img, mk, mask, **kw):
    got, gconv = watershed(
        torch.from_numpy(img), torch.from_numpy(mk),
        None if mask is None else torch.from_numpy(mask), with_flag=True, **kw,
    )
    want, wconv = jax_watershed(
        jnp.asarray(img), jnp.asarray(mk), None if mask is None else jnp.asarray(mask),
        with_flag=True, **kw,
    )
    return got.numpy(), gconv.numpy(), np.asarray(want), np.asarray(wconv)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("relief", ["smooth", "q16"])
def test_watershed_matches_jax_xla_and_sweeps(relief, connectivity):
    prob = bench_relief()
    mk, mask = markers_of(prob)
    img = prob if relief == "smooth" else quantize16(prob)
    got, gconv, want, wconv = _both(img, mk, mask, connectivity=connectivity)
    assert got.dtype == np.int32 and bool(gconv) and bool(wconv)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[mask])) == mk.max() >= 2  # every seed floods
    sweeps, sconv = watershed_sweeps(
        jnp.asarray(img), jnp.asarray(mk), jnp.asarray(mask),
        connectivity=connectivity, tile=32, interpret=True, with_flag=True,
    )
    assert bool(sconv)
    np.testing.assert_array_equal(got, np.asarray(sweeps))


def test_watershed_unreachable_mask_and_seeds_outside_it():
    rng = np.random.default_rng(3)
    img = rng.random((48, 80)).astype(np.float32)
    mask = np.ones((48, 80), bool)
    mask[:, 38:42] = False  # a wall: the right half has one seed of its own
    mask[20:28, 60:70] = False
    mask[22:26, 63:67] = True  # an island no seed reaches
    mk = np.zeros((48, 80), np.int32)
    mk[5, 5], mk[40, 30], mk[10, 75] = 1, 2, 3
    mk[0, 40] = 4  # a seed outside the mask floods nothing
    for connectivity in (1, 2):
        got, gconv, want, wconv = _both(img, mk, mask, connectivity=connectivity)
        assert bool(gconv) and bool(wconv)
        np.testing.assert_array_equal(got, want)
        assert (got[~mask] == 0).all() and (got[22:26, 63:67] == 0).all()
        assert 4 not in got and set(np.unique(got[mask])) >= {1, 2, 3}


def test_watershed_batched_planes_match_jax_and_single_planes():
    rng = np.random.default_rng(7)
    img = rng.random((3, 64, 128)).astype(np.float32)
    img[1, -12:, :] = 0.01  # a low corridor along a plane's bottom edge
    mk = np.zeros((3, 64, 128), np.int32)
    mask = np.ones((3, 64, 128), bool)
    mask[2, :4, :] = False
    for b in range(3):
        mk[b, 8, 8 + 11 * b] = 1 + b
        mk[b, 55, 100 - 9 * b] = 4 + b
    got, gconv, want, wconv = _both(img, mk, mask, connectivity=1)
    assert gconv.shape == (3,) and gconv.all() and wconv.all()
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        one = watershed(torch.from_numpy(img[b]), torch.from_numpy(mk[b]),
                        torch.from_numpy(mask[b]))
        np.testing.assert_array_equal(got[b], one.numpy())


def test_watershed_budget_runs_out_like_jax():
    prob = bench_relief()
    mk, mask = markers_of(prob)
    img = np.stack([prob, quantize16(prob)])
    mks, masks = np.stack([mk, mk]), np.stack([mask, mask])
    got, gconv, want, wconv = _both(img, mks, masks, max_iters=2)
    assert not gconv.any() and not wconv.any()
    np.testing.assert_array_equal(got, want)  # the same two Jacobi steps


def test_watershed_tunnel_basins_matches_jax():
    """Both entry points with ``tunnel_basins=True`` on a [2, H, W] batch of
    the smooth and the 16-level bench relief (more in test_torch_tunnel.py)."""
    prob = bench_relief()
    mk, mask = markers_of(prob)
    img = np.stack([prob, quantize16(prob)])
    mks, masks = np.stack([mk, mk]), np.stack([mask, mask])
    got, gconv, want, wconv = _both(img, mks, masks, tunnel_basins=True)
    assert gconv.all() and wconv.all()
    np.testing.assert_array_equal(got, want)
    auto = watershed_auto(torch.from_numpy(img), torch.from_numpy(mks), torch.from_numpy(masks),
                          tunnel_basins=True)
    np.testing.assert_array_equal(auto.numpy(), want)


def test_watershed_auto_takes_the_plain_path_on_cpu_and_the_kernel_refuses_it():
    prob = bench_relief()
    mk, mask = markers_of(prob)
    args = (torch.from_numpy(prob), torch.from_numpy(mk), torch.from_numpy(mask))
    np.testing.assert_array_equal(watershed_auto(*args).numpy(), watershed(*args).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        watershed_cuda(*args)


def _plateau_dsq(seed: int, shape=(128, 128)):
    """An EDT² image with large plateaus: dilated sparse seeds."""
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < 0.03
    m = ond.binary_dilation(m, ond.disk(5))
    dsq = np.round(ndi.distance_transform_edt(m) ** 2).astype(np.int32)
    dsq[:20, :30] = 7  # one wide plateau, and the zero plateau around the cells
    return dsq


@pytest.mark.parametrize("connectivity", [1, 2])
def test_local_maxima_matches_jax_flood_and_sweeps(connectivity):
    dsq = np.stack([_plateau_dsq(0), _plateau_dsq(1)])
    got, gconv = local_maxima(torch.from_numpy(dsq), connectivity, with_flag=True)
    want, wconv = jax_local_maxima(jnp.asarray(dsq), connectivity, with_flag=True)
    assert gconv.all() and np.asarray(wconv).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sweeps, sconv = _local_maxima_sweeps(
        jnp.asarray(dsq), connectivity, True, tile=32, max_sweeps=16, interpret=True,
    )
    assert np.asarray(sconv).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(sweeps))
    auto = local_maxima_auto(torch.from_numpy(dsq), connectivity)
    np.testing.assert_array_equal(auto.numpy(), got.numpy())
    for b in range(2):
        np.testing.assert_array_equal(
            got.numpy()[b], ond.local_maxima(dsq[b].astype(np.float64), connectivity=connectivity)
        )


def test_local_maxima_budget_flag_matches_jax():
    dsq = _plateau_dsq(2)
    got, gconv = local_maxima(torch.from_numpy(dsq), 2, max_iters=1, with_flag=True)
    want, wconv = jax_local_maxima(jnp.asarray(dsq), 2, max_iters=1, with_flag=True)
    assert bool(gconv) == bool(wconv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the CUDA pass loop's schedule, modelled in plain torch ----
#
# K10 and K11 (``csrc/watershed.cu``) relax tiles to their local fixpoint
# against a frozen one-pixel halo; pass 1 runs every tile, a later pass runs
# a live tile (one with a masked non-seed pixel) only if it or one of its 8
# neighbour tiles changed in the pass before, and a plane whose pass changed
# nothing runs no tile again.  The model below runs that rule with tiles of
# 8 and every running tile reading the state from before the pass (one of
# the schedules the card may take); its costs and labels must equal the JAX
# package's exactly.


def _jax_costs(img, mk, mask, connectivity):
    """Phase 1 of the JAX ``watershed`` (its Jacobi loop, in jnp)."""
    jw = importlib.import_module("particle_col_image_segmentation_tpu.ops.watershed")

    im = jnp.asarray(img)
    m = jnp.asarray(mask)
    seeded = (jnp.asarray(mk) > 0) & m
    cost0 = jnp.where(seeded, im, jnp.float32(jw._INF))
    cost = cost0
    while True:
        best = cost
        for dy, dx in jw._offsets(connectivity):
            best = jnp.minimum(best, jnp.maximum(jw._shifted(cost, dy, dx, jnp.float32(jw._INF)), im))
        new = jnp.where(seeded, cost0, jnp.where(m, best, jnp.float32(jw._INF)))
        if bool(jnp.all(new == cost)):
            return np.asarray(cost)
        cost = new


def _windows(x, tiles, T, fill):
    """[N, T+2, T+2] windows (tile and a one-pixel halo, ``fill`` past the
    plane) of [B, H, W] ``x`` for the (z, ty, tx) in ``tiles``."""
    B, H, W = x.shape
    pad = torch.full((B, H + 2, W + 2), fill, dtype=x.dtype)
    pad[:, 1:-1, 1:-1] = x
    return torch.stack([pad[z, ty * T:ty * T + T + 2, tx * T:tx * T + T + 2]
                        for z, ty, tx in tiles])


def _tile_schedule(state, fills, upd, relax, T=8, max_passes=1024):
    """Run passes of the tile rule over [B, H, W] state tensors (H, W
    multiples of T).  ``relax(windows, upd_windows)`` takes a list of
    [N, T+2, T+2] windows to their local fixpoint with the halo frozen.
    Returns (state, per-pass [B] change rows, per-pass tiles run per plane,
    per-tile pass numbers it ran in)."""
    B, H, W = state[0].shape
    TY, TX = H // T, W // T
    upd_t = upd.reshape(B, TY, T, TX, T).any(dim=4).any(dim=2)  # live tiles
    every = [(z, ty, tx) for z in range(B) for ty in range(TY) for tx in range(TX)]
    queued, rows, runs, ran_in = set(every), [], [], {t: [] for t in every}
    for k in range(1, max_passes + 1):
        tiles = sorted(t for t in queued if k == 1 or bool(upd_t[t]))
        row = torch.zeros(B, dtype=torch.bool)
        runs.append([sum(1 for t in tiles if t[0] == z) for z in range(B)])
        queued = set()
        if tiles:
            wins = [_windows(s, tiles, T, f) for s, f in zip(state, fills)]
            uwin = _windows(upd, tiles, T, False)
            uwin[:, 0, :] = uwin[:, -1, :] = uwin[:, :, 0] = uwin[:, :, -1] = False
            out = relax(wins, uwin)
            new = [s.clone() for s in state]
            for i, (z, ty, tx) in enumerate(tiles):
                ran_in[(z, ty, tx)].append(k)
                inner = [o[i, 1:-1, 1:-1] for o in out]
                old = [s[z, ty * T:(ty + 1) * T, tx * T:(tx + 1) * T] for s in state]
                if any(not torch.equal(a, b) for a, b in zip(inner, old)):
                    row[z] = True
                    queued |= {(z, ty + dy, tx + dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                               if 0 <= ty + dy < TY and 0 <= tx + dx < TX}
                for n, a in zip(new, inner):
                    n[z, ty * T:(ty + 1) * T, tx * T:(tx + 1) * T] = a
            state = new
        rows.append(row)
        if not row.any():
            break
    return state, torch.stack(rows), runs, ran_in


def _model_watershed(img, mk, mask, connectivity):
    """Both phases through ``_tile_schedule``: (cost, labels, phase-1 and
    phase-2 change rows, runs, ran_in)."""
    from particle_col_image_segmentation_tpu_torch.ops.watershed import (
        _BIG_LAB,
        _INF,
        _offsets,
        _shifted,
        claim_candidates,
        fold_claim,
    )

    img_t, lab0 = torch.from_numpy(img), torch.from_numpy(mk)
    m = torch.from_numpy(mask)
    seeded = (lab0 > 0) & m
    upd = m & ~seeded
    inf = torch.tensor(_INF, dtype=torch.float32)

    def relax_costs(wins, uwin):
        cw, iw = wins
        while True:
            best = cw
            for dy, dx in _offsets(connectivity):
                best = torch.minimum(best, torch.maximum(_shifted(cw, dy, dx, _INF), iw))
            new = torch.where(uwin, best, cw)
            if torch.equal(new, cw):
                return [cw, iw]
            cw = new

    (cost, _), c_rows, c_runs, c_ran = _tile_schedule(
        [torch.where(seeded, img_t, inf), img_t], [_INF, _INF], upd, relax_costs)

    def relax_labels(wins, uwin):
        cw, iw, lw, dw, ew = wins
        big = torch.full_like(lw, _BIG_LAB)
        while True:
            best = (big, torch.full_like(iw, _INF), torch.full_like(iw, _INF), big)
            for dy, dx in _offsets(connectivity):
                best = fold_claim(best, claim_candidates(cw, iw, lw, dw, ew, dy, dx))
            bd, be, _, bl = best
            nl, nd, ne = (torch.where(uwin, b, o) for b, o in ((bl, lw), (bd, dw), (be, ew)))
            if torch.equal(nl, lw) and torch.equal(nd, dw) and torch.equal(ne, ew):
                return [cw, iw, lw, dw, ew]
            lw, dw, ew = nl, nd, ne

    big = torch.full(img_t.shape, _BIG_LAB, dtype=torch.int32)
    state = [cost, img_t, torch.where(seeded, lab0, big), torch.where(seeded, 0, big),
             torch.where(seeded, -inf, inf)]
    (_, _, lab, _, _), l_rows, l_runs, l_ran = _tile_schedule(
        state, [_INF, _INF, _BIG_LAB, _BIG_LAB, _INF], upd, relax_labels)
    labels = torch.where(m & (cost < inf) & (lab != _BIG_LAB), lab, 0)
    return cost, labels, (c_rows, l_rows), (c_runs, l_runs), (c_ran, l_ran)


def _schedule_cases():
    """(name, img, markers, mask) [B, H, W] numpy inputs, H and W multiples
    of 8: the random, 16-level and smooth reliefs, the serpentine corridor
    and a batch whose planes need a few and many passes."""
    from chip_smoke import ws_corridor, ws_mixed

    rng = np.random.default_rng(21)
    prob = bench_relief(n=64, pairs=6, margin=20, r2_range=(40, 120))
    mk, mask = markers_of(prob)
    rand = rng.random((64, 64)).astype(np.float32)
    rmk = np.zeros((64, 64), np.int32)
    rmk[5, 5], rmk[50, 60], rmk[30, 20] = 1, 2, 3
    yield "random relief", rand[None], rmk[None], np.ones((1, 64, 64), bool)
    yield "16-level relief", quantize16(prob)[None], mk[None], mask[None]
    yield "smooth relief", prob[None], mk[None], mask[None]
    img, cmk, cmask = ws_corridor(32, 48)
    yield "serpentine corridor", img[None], cmk[None], cmask[None]
    yield "mixed pass counts", *ws_mixed(32, 48)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", ["random relief", "16-level relief", "smooth relief",
                                  "serpentine corridor", "mixed pass counts"])
def test_tile_schedule_matches_jax(case, connectivity):
    name, img, mk, mask = next(c for c in _schedule_cases() if c[0] == case)
    cost, labels, rows, runs, ran_in = _model_watershed(img, mk, mask, connectivity)
    np.testing.assert_array_equal(cost.numpy(), _jax_costs(img, mk, mask, connectivity))
    want, wconv = jax_watershed(jnp.asarray(img), jnp.asarray(mk), jnp.asarray(mask),
                                connectivity=connectivity, max_iters=1 << 14, with_flag=True)
    assert bool(np.asarray(wconv).all())
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))
    for r in rows:  # each phase stopped at its first pass that changed no plane
        passes, conv = passes_from_history(r.numpy(), 1024)
        assert passes == len(r) and conv.all()
    if case == "serpentine corridor":
        for phase in (0, 1):
            assert len(rows[phase]) > 12
            # some tile ran, was skipped for a pass, and woke again
            assert any(any(b - a > 1 for a, b in zip(ks, ks[1:])) for ks in ran_in[phase].values())
    if case == "mixed pass counts":
        for phase in (0, 1):
            need0 = int(np.flatnonzero(~rows[phase][:, 0].numpy())[0]) + 1
            assert need0 < len(rows[phase]) - 4  # plane 0 stops early
            assert all(r[0] == 0 for r in runs[phase][need0:])  # and runs no tile again


def _old_run(flag_rows, max_iters):
    """The loop the pass chunks replace: one pass at a time, a host read of
    the pass's change flags after each, stop at the first pass that changed
    no plane or at ``max_iters``.  Returns (passes, converged)."""
    passes, changed = 0, None
    while passes < max_iters:
        changed = flag_rows[passes]
        passes += 1
        if not changed.any():
            break
    return passes, changed == 0


@pytest.mark.parametrize("budget", ["1", "2", "need-1", "need", "1024"])
def test_passes_from_history_matches_the_per_pass_loop(budget):
    """Flag histories of planes that first change nothing in passes 3, 13
    and 1 (and a plane still changing at 30), cut at the budget as the chunked
    loop runs them: the pass count and per-plane flags equal the per-pass
    loop's."""
    for firsts in ((3, 13, 1), (3, 13, 31)):
        need = max(firsts)
        rows = np.array([[int(k < f) for f in firsts] for k in range(1, 40)], np.int32)
        b = {"1": 1, "2": 2, "need-1": need - 1, "need": need, "1024": 1024}[budget]
        want = _old_run(rows, b)
        ran = 0
        for chunk in (8, 16, 32, 64, 64):  # the chunks the loop enqueues
            ran = min(ran + chunk, b, len(rows))
            got = passes_from_history(rows[:ran], b)
            if got is not None:
                break
        assert got is not None and got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("axis", [-1, -2])
def test_seg_or_scan_bidi_matches_jax(axis):
    rng = np.random.default_rng(4)
    vals = rng.random((3, 17, 23)) < 0.1
    same = rng.random((3, 17, 23)) < 0.7
    if axis == -1:
        same[..., 0] = False
    else:
        same[..., 0, :] = False
    got = seg_or_scan_bidi(torch.from_numpy(vals), torch.from_numpy(same), axis)
    want = jax_scans.seg_or_scan_bidi(jnp.asarray(vals), jnp.asarray(same), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
