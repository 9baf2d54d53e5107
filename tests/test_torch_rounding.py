"""Parity: the port's float32 multiply-adds rounded as XLA's fused
multiply-adds round them, against an exact rational oracle and the JAX
package on the CPU.

``ops.rounding.fma_f32`` is held to ``fractions.Fraction`` arithmetic (the
exact a·b + c, rounded once to float32, ties to even) on random triples and
on triples built so that the float64 sum lands on a float32 midpoint, where
a plain float64 sum rounded to float32 is wrong; non-finite operands give
what a hardware FMA gives (JAX's jitted ``a * b + c``, which XLA fuses on
the CPU).  The nearest-neighbour distances (``min_dist_to_set``,
``nearest_neighbor_dists``, ``cross_strain_distances``) and refine's
``nn_distance_px`` column are held to the JAX package at tolerance 0:
float32 bit patterns equal, NaN where JAX gives NaN (its payload is not
compared), and the CSVs byte for byte.  Each seeded set is one the port's
earlier rounding (two products rounded apart) got wrong, which the tests
assert, so none of them can pass by accident.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu import config as jax_config
from particle_col_image_segmentation_tpu.models import refine as jax_refine
from particle_col_image_segmentation_tpu.ops import pairwise as jax_pairwise
from particle_col_image_segmentation_tpu_torch.config import config_from_fields
from particle_col_image_segmentation_tpu_torch.models import refine as torch_refine
from particle_col_image_segmentation_tpu_torch.ops import pairwise
from particle_col_image_segmentation_tpu_torch.ops.rounding import fma_f32

from chip_smoke import midpoint_triples, same_f32

CPU = torch.device("cpu")


# ---- the exact oracle ----


def _round_f32(q: Fraction, negative_zero: bool = False) -> np.float32:
    """The float32 nearest the rational ``q``, ties to even (IEEE
    round-to-nearest, overflow to ±inf, gradual underflow); an exact 0 is
    −0 where ``negative_zero``."""
    if q == 0:
        return np.float32(-0.0 if negative_zero else 0.0)
    sign, q = (-1, -q) if q < 0 else (1, q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n, rem = divmod(q, quantum)
    n = int(n) + (rem > quantum / 2 or (rem == quantum / 2 and n % 2 == 1))
    if n * quantum >= Fraction(2) ** 128:
        return np.float32(sign * np.inf)
    return np.float32(sign * float(n * quantum)) if n else np.float32(-0.0 if sign < 0 else 0.0)


def exact_fma(a, b, c) -> np.ndarray:
    """a·b + c of float32 arrays, exactly, rounded once to float32; where an
    operand is not finite, the IEEE result the float64 arithmetic gives."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float32) for v in (a, b, c)))
    out = np.empty(a.shape, np.float32)
    for i in np.ndindex(a.shape):
        x, y, z = a[i], b[i], c[i]
        with np.errstate(invalid="ignore", over="ignore"):
            wide = np.float64(x) * np.float64(y) + np.float64(z)
            product_zero = x * y == 0
        if not np.isfinite(wide):
            out[i] = np.float32(wide)
            continue
        # an exact zero sum is −0 only where the product and c are both −0
        neg_zero = (bool(np.signbit(x) != np.signbit(y)) and bool(np.signbit(z))
                    and product_zero and z == 0)
        out[i] = _round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)), neg_zero)
    return out


def assert_same_f32(got, want, err_msg: str = "") -> None:
    """float32 bit patterns equal, NaN where NaN (``chip_smoke.same_f32``)."""
    assert same_f32(got, want), err_msg


def plain_f64_fma(a, b, c) -> np.ndarray:
    """a·b + c summed in float64, then rounded to float32: twice."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    return (a * b + c).astype(np.float32)


def _fma(a, b, c) -> np.ndarray:
    return fma_f32(*(torch.from_numpy(np.asarray(v, np.float32)) for v in (a, b, c))).numpy()


# ---- fma_f32 ----


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma_f32_equals_the_exact_fma_on_random_triples(seed):
    """Products and addends of overlapping magnitudes, so the sum cancels or
    rounds, with random signs and exponents from 2^-30 to 2^30."""
    rng = np.random.default_rng(seed)
    n = 4000

    def draw():
        return (rng.standard_normal(n) * 2.0 ** rng.integers(-15, 16, n)).astype(np.float32)

    a, b, c = draw(), draw(), draw()
    c[: n // 4] = -(a[: n // 4].astype(np.float64) * b[: n // 4]).astype(np.float32)  # cancels
    got = _fma(a, b, c)
    assert got.dtype == np.float32 and got.shape == (n,)
    assert_same_f32(got, exact_fma(a, b, c))


@pytest.mark.parametrize("seed", [3, 4])
def test_fma_f32_rounds_midpoints_once(seed):
    """On triples whose float64 sum is a float32 midpoint (``chip_smoke``'s
    ``midpoint_triples``), a plain float64 sum rounded to float32 (ties to
    even) is wrong about half the time; the round-to-odd step makes fma_f32
    the exact FMA on every one."""
    a, b, c = midpoint_triples(seed)
    want = exact_fma(a, b, c)
    wide = a.astype(np.float64) * b + c
    mid = (wide.astype(np.float32).astype(np.float64) != wide)
    assert mid.all(), "every float64 sum should lie off the float32 grid (on a midpoint)"
    wrong = plain_f64_fma(a, b, c) != want
    assert wrong.mean() > 0.4, wrong.mean()
    assert_same_f32(_fma(a, b, c), want)
    assert_same_f32(_fma(a[wrong], b[wrong], c[wrong]), want[wrong])


SPECIALS = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -3.0, np.inf, -np.inf, np.nan,
                     np.finfo(np.float32).max, -np.finfo(np.float32).max,
                     np.finfo(np.float32).tiny, 2.0 ** -149, -(2.0 ** -149)], np.float32)


def test_fma_f32_on_zeros_infinities_nan_and_extremes():
    """Every triple of ±0, ±1, 2.5, −3, ±inf, NaN, ±FLT_MAX, FLT_MIN and
    ±2^-149: the IEEE FMA's value (±inf, NaN for inf·0 and inf − inf, signed
    zeros, FLT_MAX·2 − FLT_MAX finite, gradual underflow), equal to the
    exact oracle, and to XLA's fused ``a * b + c`` on the CPU wherever no
    operand or result is subnormal: XLA's CPU code flushes those to zero
    (inf · 2^-149 is NaN there), which the port's paths never meet."""
    a, b, c = np.meshgrid(SPECIALS, SPECIALS, SPECIALS, indexing="ij")
    a, b, c = a.ravel(), b.ravel(), c.ravel()
    got = _fma(a, b, c)
    want = exact_fma(a, b, c)
    assert_same_f32(got, want)
    hw = np.asarray(jax.jit(lambda x, y, z: x * y + z)(jnp.asarray(a), jnp.asarray(b),
                                                      jnp.asarray(c)))
    tiny = np.finfo(np.float32).tiny
    normal = ~np.any([(v != 0) & (np.abs(v) < tiny) for v in (a, b, c, want)], axis=0)
    assert normal.sum() >= 12 ** 3 and np.isnan(hw[normal]).sum() >= 300
    assert_same_f32(got[normal], hw[normal])
    # the cases a plain float32 multiply and add get wrong, spelled out
    big = np.finfo(np.float32).max
    assert_same_f32(_fma([big], [2.0], [-big]), np.array([big], np.float32))
    assert_same_f32(_fma([2.0 ** -149], [0.5], [-0.0]), np.array([0.0], np.float32))
    assert np.signbit(_fma([-(2.0 ** -149)], [0.5], [0.0])[0])  # −2^-150 rounds to −0
    assert np.signbit(_fma([-0.0], [1.0], [-0.0])[0])
    assert not np.signbit(_fma([-1.0], [1.0], [1.0])[0])


def test_xla_fuses_the_multiply_add_that_fma_f32_reproduces():
    """The premise, checked: JAX's jitted ``x * y + z`` on the CPU equals the
    exact FMA on midpoint triples, not the separately rounded sum."""
    a, b, c = midpoint_triples(5, 500)
    hw = np.asarray(jax.jit(lambda x, y, z: x * y + z)(jnp.asarray(a), jnp.asarray(b),
                                                      jnp.asarray(c)))
    assert_same_f32(hw, exact_fma(a, b, c))
    assert_same_f32(_fma(a, b, c), hw)


def test_fma_f32_broadcasts_and_takes_numbers():
    """A [B, 1] addend, a [bins] factor and a NumPy float32 scalar, as the Otsu
    centres pass them; the result is float32 on the tensors' device."""
    lo = torch.tensor([[3.0], [-7.25]])
    t = torch.arange(5, dtype=torch.float32) + 0.5
    got = fma_f32(t * 1.3, np.float32(1) / np.float32(5), lo)
    assert got.dtype == torch.float32 and got.shape == (2, 5) and got.device == CPU
    want = exact_fma((t * 1.3).numpy()[None], np.float32(1) / np.float32(5), lo.numpy())
    assert_same_f32(got.numpy(), want)


# ---- the pairwise distances ----


def _plain_parent(a, b, valid):
    """The port's earlier min distance: dx² + dy² rounded apart, float64 root."""
    d = a[:, None, :] - b[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    d2 = np.where(valid[None], d2, np.float32(np.inf)).min(1)
    return np.sqrt(d2.astype(np.float64)).astype(np.float32)


def _centroid_sets(seed: int, n: int = 600, side: int = 2048):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, 2)) * side).astype(np.float32)
    b = (rng.random((n + 900, 2)) * side).astype(np.float32)  # two blocks of 1024
    valid = rng.random(n + 900) < 0.9
    return a, b, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_min_dist_to_set_equals_jax_bit_for_bit(seed):
    """600 centroids on a 2048² plane against 1500 (90 % valid), a NaN row,
    and an empty valid set (+inf): tolerance 0."""
    a, b, valid = _centroid_sets(seed)
    a[7] = np.nan  # an empty NanoSIMS ROI's position
    b[11] = np.nan
    valid[11] = False
    got = pairwise.min_dist_to_set(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(valid)).numpy()
    want = np.asarray(jax_pairwise.min_dist_to_set(jnp.asarray(a), jnp.asarray(b),
                                                   jnp.asarray(valid)))
    assert_same_f32(got, want)
    assert np.isnan(got[7]) and np.isfinite(np.delete(got, 7)).all()
    fine = ~np.isnan(want)
    assert (_plain_parent(a, b, valid)[fine] != want[fine]).sum() >= 10  # the old rounding
    none = np.zeros_like(valid)
    got = pairwise.min_dist_to_set(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(none)).numpy()
    want = np.asarray(jax_pairwise.min_dist_to_set(jnp.asarray(a), jnp.asarray(b),
                                                   jnp.asarray(none)))
    assert_same_f32(got, want)
    assert np.isposinf(got).all()
    nan_b = np.where(valid[:, None], b, np.nan).astype(np.float32)  # a valid NaN row
    got = pairwise.min_dist_to_set(torch.from_numpy(a[:5]), torch.from_numpy(nan_b),
                                   torch.from_numpy(np.ones_like(valid))).numpy()
    want = np.asarray(jax_pairwise.min_dist_to_set(jnp.asarray(a[:5]), jnp.asarray(nan_b),
                                                   jnp.asarray(np.ones_like(valid))))
    assert_same_f32(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nearest_neighbor_dists_equals_jax_plain_and_vmapped(seed):
    """Within-set distances on 1500 points (two blocks): the port's per-set
    call against JAX's call and against ``jax.vmap`` over valid-masked sets
    padded to a power of two, as JAX's refine stack path calls it."""
    _, b, valid = _centroid_sets(seed)
    got = pairwise.nearest_neighbor_dists(torch.from_numpy(b), torch.from_numpy(valid)).numpy()
    want = np.asarray(jax_pairwise.nearest_neighbor_dists(jnp.asarray(b), jnp.asarray(valid)))
    assert_same_f32(got, want)
    sets = [b[:600], b[600:1100], b[1100:1400]]
    cap = 1024
    pts = np.zeros((len(sets), cap, 2), np.float32)
    ok = np.zeros((len(sets), cap), bool)
    for z, s in enumerate(sets):
        pts[z, :len(s)] = s
        ok[z, :len(s)] = True
    vm = np.asarray(jax.vmap(jax_pairwise.nearest_neighbor_dists)(jnp.asarray(pts),
                                                                  jnp.asarray(ok)))
    differed = 0
    for z, s in enumerate(sets):
        one = pairwise.nearest_neighbor_dists(torch.from_numpy(s),
                                              torch.ones(len(s), dtype=torch.bool)).numpy()
        assert_same_f32(one, vm[z, :len(s)], f"set {z}")
        d = s[:, None, :] - s[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        np.fill_diagonal(d2, np.inf)
        differed += (np.sqrt(d2.min(1).astype(np.float64)).astype(np.float32) != one).sum()
    assert differed >= 10  # sets the port's earlier rounding got wrong


def test_cross_strain_distances_equal_jax_bit_for_bit():
    a, b, _ = _centroid_sets(9, n=400)
    got = torch_refine.cross_strain_distances(a, b[:700], device=CPU)
    want = jax_refine.cross_strain_distances(a, b[:700])
    for k in ("a_to_b", "b_to_a"):
        assert_same_f32(got[k], want[k], k)
    ones = np.ones(700, bool)
    assert (_plain_parent(a, b[:700], ones) != want["a_to_b"]).sum() >= 5


# ---- refine's nn_distance_px column ----


def _blob(m, r0, c0, h, w, s, k):
    """An h × w rectangle at (r0, c0) with k pixels on the row above, from
    column c0 + s: its centroid is no half-integer."""
    m[r0:r0 + h, c0:c0 + w] = True
    m[r0 - 1, c0 + s:c0 + s + k] = True


def two_cells() -> np.ndarray:
    """Two isolated cells whose centroids are 23.2355 px apart, a distance
    whose third decimal the order of rounding decides (found with NumPy
    over rectangles with a partial row)."""
    m = np.zeros((32, 48), bool)
    _blob(m, 10, 8, 7, 11, 2, 5)
    _blob(m, 13, 33, 5, 7, 4, 2)
    return np.where(m, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("path", ["plane", "stack"])
def test_refine_csv_nn_distance_equals_jax_byte_for_byte(path, tmp_path):
    """A refine CSV whose ``nn_distance_px`` column the port's earlier
    rounding wrote as 23.235 where the JAX package writes 23.236: now byte
    for byte equal, through ``refine_boundaries`` (JAX's plain call) and
    ``refine_boundaries_stack`` (JAX's ``jax.vmap``)."""
    prob = two_cells()
    jcfg = jax_config.RefineConfig()
    tcfg = config_from_fields(jcfg)
    if path == "plane":
        got = [torch_refine.refine_boundaries(prob, tcfg, device=CPU)]
        want = [jax_refine.refine_boundaries(prob, jcfg)]
        torch_refine.write_refine_csv(got[0], tmp_path / "torch.csv")
        jax_refine.write_refine_csv(want[0], tmp_path / "jax.csv")
    else:
        stack = np.stack([prob, prob])
        got = torch_refine.refine_boundaries_stack(stack, tcfg, device=CPU)
        want = jax_refine.refine_boundaries_stack(stack, jcfg)
        torch_refine.write_refine_stack_csv(got, tmp_path / "torch.csv")
        jax_refine.write_refine_stack_csv(want, tmp_path / "jax.csv")
    for g, w in zip(got, want, strict=True):
        assert g.num_cells == w.num_cells == 2
        np.testing.assert_array_equal(g.centroids, w.centroids)
        assert_same_f32(g.nn_distances, w.nn_distances)
        earlier = _plain_parent(g.centroids[:1].astype(np.float32),
                                g.centroids[1:].astype(np.float32), np.ones(1, bool))
        assert round(float(earlier[0]), 3) == 23.235 != round(float(w.nn_distances[0]), 3)
    text = (tmp_path / "jax.csv").read_text()
    assert "23.236" in text and "23.235" not in text
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
