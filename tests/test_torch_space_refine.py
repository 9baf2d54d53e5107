"""Parity: the PyTorch port's spatial refine — the band phases of
``ops/watershed.py``, ``make_sharded_watershed_fn`` and
``make_sharded_refine_fn`` of ``parallel/sharded.py``, the band modes' plain
versions (K7's ``row_offset``, K9's flag over a row window),
``refine_boundaries_sharded`` on a mesh with a space axis and the ``refine
--space-parallel`` verb — against the JAX package on the CPU.

A mesh here names the CPU several times (``["cpu"] * n``).  Inputs are made
with numpy from a seed, on the JAX suite's own fixtures (64×64 and 64×128
planes).  Labels, markers, counts, d² and the centroid sums are integers and
are compared exactly; nearest-neighbour distances too, as float32 bit
patterns, as in ``test_torch_refine.py`` (the port rounds them as XLA's
fused multiply-add does), and the CSVs, which round them, byte for byte.
The watershed's budgets differ by design (the JAX package counts
halo-exchanged Jacobi steps, the port rounds of band fixpoints), so labels
are compared where both report converged.  The JAX
package's own sharded functions run once, in a fresh interpreter with the
compilation cache off.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.config import RefineConfig
from particle_col_image_segmentation_tpu.models import refine as jax_refine
from particle_col_image_segmentation_tpu.ops.edt import edt_sq_exact as jax_edt_sq_exact
from particle_col_image_segmentation_tpu.ops.regionprops import centroid_sums as jax_centroid_sums
from particle_col_image_segmentation_tpu.oracle import ndimage as ond
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import config_from_fields
from particle_col_image_segmentation_tpu_torch.models import refine as torch_refine
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_auto
from particle_col_image_segmentation_tpu_torch.ops.regionprops import centroid_sums
from particle_col_image_segmentation_tpu_torch.parallel import make_mesh, sharded

from test_torch_refine import _assert_results_equal

# the ops packages export a function named ``watershed`` beside the module
jax_ws = importlib.import_module("particle_col_image_segmentation_tpu.ops.watershed")
ws = importlib.import_module("particle_col_image_segmentation_tpu_torch.ops.watershed")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 2), (1, 4), (2, 2)]
JCFG = RefineConfig()
TCFG = config_from_fields(JCFG)
INF = 3.4e38
BIG = np.iinfo(np.int32).max
torch.set_num_threads(1)  # several xdist workers share the host's cores


def cpu_mesh(n_data, n_space):
    return make_mesh(n_data=n_data, n_space=n_space, devices=["cpu"] * (n_data * n_space))


# ---- fixtures (the JAX suite's, tests/test_parallel.py) ---------------------


def watershed_planes(B: int, n: int = 64, seed: int = 50):
    """``test_sharded_watershed_matches_single_chip``'s planes: (relief f32,
    oracle markers i32, mask bool), each [B, n, n]."""
    yy, xx = np.mgrid[:n, :n]
    imgs, marks, masks = [], [], []
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        m = np.zeros((n, n), bool)
        for _ in range(3):
            cy, cx = rng.integers(15, n - 15, 2)
            r2 = int(rng.integers(40, 120))
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
            m |= (yy - cy) ** 2 + (xx - cx - int(1.2 * np.sqrt(r2))) ** 2 <= r2
        dist = ndi.distance_transform_edt(m)
        prob = (1.0 - dist / max(1.0, dist.max())).astype(np.float32)
        binary = prob < 0.5
        marks.append(ond.label(ond.local_maxima(ndi.distance_transform_edt(binary))
                               .astype(np.uint8)).astype(np.int32))
        imgs.append(prob)
        masks.append(binary)
    return tuple(map(np.stack, (imgs, marks, masks)))


def refine_probs(B: int, H: int = 64, W: int = 128, seed: int = 70):
    """``test_sharded_refine_matches_single_chip``'s probability maps."""
    planes = []
    yy, xx = np.mgrid[:H, :W]
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        m = np.zeros((H, W), bool)
        for _ in range(4):
            cy, cx = rng.integers(10, H - 10), rng.integers(10, W - 10)
            r2 = int(rng.integers(30, 90))
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r2
            m |= (yy - cy) ** 2 + (xx - cx - int(1.4 * np.sqrt(r2))) ** 2 <= r2
        dist = ndi.distance_transform_edt(m)
        planes.append((1.0 - dist / max(1.0, dist.max())).astype(np.float32))
    return np.stack(planes)


def corridor(n: int = 64, ramp: bool = False):
    """A serpentine corridor 2 px wide that runs down and up the plane in
    columns 6 apart, so the flood from its two end markers crosses every row
    seam many times: (relief, markers, mask) [1, n, n].  The relief is a
    plateau (phase 2 decides by level distance) or, with ``ramp``, rises
    along the path (every phase-1 cost crosses each seam)."""
    mask = np.zeros((n, n), bool)
    path = []
    cols = list(range(1, n - 2, 6))
    for i, c in enumerate(cols):
        rows = range(1, n - 1) if i % 2 == 0 else range(n - 2, 0, -1)
        for r in rows:
            path.append((r, c))
        if i + 1 < len(cols):
            r = n - 2 if i % 2 == 0 else 1
            path += [(r, x) for x in range(c + 1, cols[i + 1])]
    img = np.full((n, n), 0.9, np.float32)
    for k, (r, c) in enumerate(path):
        for dc in (0, 1):
            mask[r, c + dc] = True
            img[r, c + dc] = 0.2 + (0.6 * k / len(path) if ramp else 0.0)
    mk = np.zeros((n, n), np.int32)
    (r0, c0), (r1, c1) = path[0], path[-1]
    mk[r0, c0], mk[r1, c1] = 1, 2
    return img[None], mk[None], mask[None]


# ---- the band phases against the one-plane phases ---------------------------


def _pad(x, fill):
    """A plane's rows with one fill row above and below (``_ws_pad``)."""
    x = np.asarray(x)
    row = np.full_like(x[..., :1, :], fill)
    return torch.from_numpy(np.concatenate([row, x, row], axis=-2))


def _seed_state(mk, seeded):
    """Phase 2's starting (lab, dist, eimg) with ``_ws_pad``'s fill rows."""
    return (_pad(np.where(seeded, mk, BIG).astype(np.int32), BIG),
            _pad(np.where(seeded, 0, BIG).astype(np.int32), BIG),
            _pad(np.where(seeded, -INF, INF).astype(np.float32), INF))


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("n_bands", [2, 4])
def test_band_phases_match_the_one_plane_phases(connectivity, n_bands):
    """The whole plane as one band (fill rows above and below) gives the
    one-plane phases.  A band whose halo rows hold the plane's converged
    state relaxes from the seeds to that state on its own rows (its local
    fixpoint under those rows is unique); resumed from it, it changes
    nothing."""
    img, mk, mask = watershed_planes(2)
    seeded = (mk > 0) & mask
    t = torch.from_numpy
    cost, ch1 = ws.minimax_costs(t(img), t(mask), t(seeded), connectivity, 4096)
    want, ch2 = ws.claim_labels(cost, t(img), t(mk), t(mask), t(seeded), connectivity, 4096)
    assert not ch1.any() and not ch2.any()
    img_p, m_p, s_p = _pad(img, INF), _pad(mask, False), _pad(seeded, False)
    cost0 = _pad(np.where(seeded, img, INF).astype(np.float32), INF)
    c_full, changing, _, _ = ws.minimax_costs_band(img_p, m_p, s_p, cost0, connectivity, 4096)
    assert not changing.any()
    np.testing.assert_array_equal(c_full[:, 1:-1].numpy(), cost.numpy())
    full = ws.claim_labels_band(c_full, img_p, m_p, s_p, *_seed_state(mk, seeded),
                                connectivity, 4096)
    assert not full[3].any()
    reached = m_p & (c_full < INF) & (full[0] != BIG)
    np.testing.assert_array_equal(torch.where(reached, full[0], 0)[:, 1:-1].numpy(),
                                  want.numpy())
    h = img.shape[-2] // n_bands
    for j in range(n_bands):
        rows = slice(j * h, j * h + h + 2)  # the band's own rows and its halo rows
        ib, mb, sb = img_p[:, rows], m_p[:, rows], s_p[:, rows]

        def seeds_with_halos(start, final):
            x = start[:, rows].clone()
            x[:, 0], x[:, -1] = final[:, rows][:, 0], final[:, rows][:, -1]
            return x

        cb, changing, _, _ = ws.minimax_costs_band(
            ib, mb, sb, seeds_with_halos(cost0, c_full), connectivity, 4096)
        assert not changing.any()
        np.testing.assert_array_equal(cb.numpy(), c_full[:, rows].numpy())
        again = ws.minimax_costs_band(ib, mb, sb, cb.clone(), connectivity, 4096)
        assert not again[1].any() and not again[2].any()
        state = [seeds_with_halos(x, f) for x, f in zip(_seed_state(mk, seeded), full[:3])]
        got = ws.claim_labels_band(cb, ib, mb, sb, *state, connectivity, 4096)
        assert not got[3].any()
        for x, f in zip(got[:3], full[:3]):
            np.testing.assert_array_equal(x.numpy(), f[:, rows].numpy())
        again = ws.claim_labels_band(cb, ib, mb, sb, *(x.clone() for x in got[:3]),
                                     connectivity, 4096)
        assert not again[3].any() and not again[4].any()


# ---- the band-coupled watershed ---------------------------------------------


def _watershed_cases():
    img, mk, mask = watershed_planes(4)
    flat, ramp = corridor(), corridor(ramp=True)
    return {
        "jax-fixture": (img, mk, mask),
        "corridors": tuple(np.concatenate([a, b]) for a, b in zip(flat, ramp)),
    }


@pytest.mark.parametrize("case", list(_watershed_cases()))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("connectivity", [1, 2])
def test_sharded_watershed_matches_jax_watershed(case, mesh_shape, connectivity):
    img, mk, mask = _watershed_cases()[case]
    fn = sharded.make_sharded_watershed_fn(cpu_mesh(*mesh_shape), connectivity)
    got, conv = fn(img, mk, mask)
    assert bool(conv.all())
    for b in range(img.shape[0]):
        want, wconv = jax_ws.watershed(jnp.asarray(img[b]), jnp.asarray(mk[b]),
                                       jnp.asarray(mask[b]), connectivity, 4096, True)
        assert bool(wconv)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    stats = fn.last_stats
    assert stats["phase1"]["rounds"] >= 2 and stats["phase2"]["rounds"] >= 2
    if case == "corridors":  # the flood crosses each seam several times
        assert stats["phase2"]["rounds"] > 2 * mesh_shape[1]


def test_starved_round_budget_reports_unconverged():
    """One round cannot carry the corridor's flood over a seam: the plane
    reports unconverged (and ``refine_boundaries_sharded`` raises JAX's
    message on such a plane); the fixture's other budgets converge."""
    img, mk, mask = corridor()
    got, conv = sharded.make_sharded_watershed_fn(cpu_mesh(1, 4), 1, 1)(img, mk, mask)
    assert not bool(conv.any())
    probs = refine_probs(2)
    with pytest.raises(RuntimeError, match="did not converge on plane\\(s\\) \\[0, 1\\]"):
        torch_refine.refine_boundaries_sharded(
            probs, dataclasses.replace(TCFG, watershed_max_iters=1), mesh=cpu_mesh(1, 2),
            stack=True)


# ---- the refine pipeline ----------------------------------------------------


def _assert_refine_matches_jax(probs, out, max_regions):
    labels, markers, num, conv, sums = out
    assert bool(conv.all())
    for b in range(probs.shape[0]):
        want_l, want_m, want_n, table, _, want_c = jax_refine.refine_plane_device(
            jnp.asarray(probs[b]), JCFG, max_regions)
        assert bool(want_c)
        assert int(num[b]) == int(want_n)
        np.testing.assert_array_equal(markers[b].numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(want_l))
        for i, f in enumerate(("area", "sr_hi", "sr_lo", "sc_hi", "sc_lo")):
            np.testing.assert_array_equal(sums[b, :, i].numpy(), np.asarray(getattr(table, f)))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_refine_matches_jax_refine_plane_device(mesh_shape):
    probs = refine_probs(2)
    fn = sharded.make_sharded_refine_fn(cpu_mesh(*mesh_shape), max_regions=1024,
                                        with_tables=True)
    out = fn(probs)
    _assert_refine_matches_jax(probs, out, 1024)
    assert fn.last_stats["edt_fallback_rows"] == 0
    short = sharded.make_sharded_refine_fn(cpu_mesh(*mesh_shape), max_regions=1024)(probs)
    assert len(short) == 4
    for a, b in zip(short, out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def deep_planes():
    """[3, 64, 128]: a blob deeper than the probe cap (here 4) across the
    seams, the refine fixture, and a plane without a boundary pixel."""
    yy, xx = np.mgrid[:64, :128]
    blob = np.clip(np.sqrt((yy - 32.0) ** 2 + (xx - 60.0) ** 2) / 30.0, 0, 1)
    return np.stack([blob.astype(np.float32), refine_probs(1)[0],
                     np.zeros((64, 128), np.float32)])


@pytest.mark.parametrize("mesh_shape", [(1, 4), (3, 2)], ids=["1x4", "3x2"])
def test_edt_fallback_and_featureless_plane_match_jax(mesh_shape):
    """K9's probe flags the deep blob (on the band that holds it, or on
    all): its data row takes the exact transform with the whole plane's
    ``inf``, as does the featureless plane; d² and the refine equal JAX's."""
    probs = deep_planes()
    mesh = cpu_mesh(*mesh_shape)
    feature = [x >= 0.5 for x in sharded.split_bands(probs, mesh)]
    stats = {}
    d2 = sharded._edt_bands(feature, mesh, 4, stats)
    got = sharded.join_bands(d2, mesh).numpy()
    assert stats["edt_fallback_rows"] == mesh_shape[0]
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.asarray(jax_edt_sq_exact(jnp.asarray(probs[b] >= 0.5))))
    assert got[2].min() == (64 + 128 + 2) ** 2
    fn = sharded.make_sharded_refine_fn(mesh, max_regions=1024, with_tables=True, probe_cap=4)
    _assert_refine_matches_jax(probs, fn(probs), 1024)


def test_centroid_sums_row_offset_matches_jax_on_the_whole_plane():
    """K7's plain version on row bands with their plane rows (as
    ``region_props``' ``row_offset``) sums to JAX's table of the whole
    plane; at an offset whose base-128 digits carry (2²⁰ + 77) each digit
    column is the sum of that pixel's shifted row digits."""
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 40, (2, 96, 70)).astype(np.int32)
    want = jax_centroid_sums(jnp.asarray(seg[0]), 50)
    parts = [centroid_sums(torch.from_numpy(seg[:1, j * 24:(j + 1) * 24]), 50, row_offset=j * 24)
             for j in range(4)]
    for i, f in enumerate(("area", "sr_hi", "sr_lo", "sc_hi", "sc_lo")):
        np.testing.assert_array_equal(sum(p[i] for p in parts)[0].numpy(),
                                      np.asarray(getattr(want, f)))
    off = 2**20 + 77
    got = centroid_sums(torch.from_numpy(seg), 50, row_offset=off)
    rows = np.arange(96)[None, :, None] + off + np.zeros_like(seg)
    for i, d in ((1, rows // 128), (2, rows % 128)):
        want_d = np.stack([np.bincount(seg[b].ravel(), d[b].ravel(), 51) for b in range(2)])
        np.testing.assert_array_equal(got[i].numpy(), want_d)


@pytest.mark.parametrize("rows", [(0, 40), (10, 30), (20, 20), (39, 40)])
def test_edt_flag_over_a_row_window(rows):
    """K9's band-mode flag, plain version: some d² > cap² in rows [lo, hi)."""
    feature = torch.zeros((2, 40, 50), dtype=torch.bool)
    feature[0, 2, 3] = feature[1, 35, 40] = True
    out, flag = edt_sq_auto(feature, 6, with_flag=True, flag_rows=rows)
    lo, hi = rows
    assert bool(flag) == bool((out[..., lo:hi, :] > 36).any())
    assert bool(edt_sq_auto(feature, 6, with_flag=True)[1])
    with pytest.raises(ValueError, match="row window"):
        edt_sq_auto(feature, 6, with_flag=True, flag_rows=(5, 41))


# ---- refine_boundaries_sharded and the verb ---------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_refine_boundaries_sharded_on_a_space_mesh_matches_jax_stack(tmp_path, mesh_shape):
    """Z = 3 (padded on a 2-row data axis), [Z, H, W, C] input: every
    result and the stack CSV equal JAX's ``refine_boundaries_stack``."""
    stack = np.concatenate([refine_probs(2), refine_probs(1, seed=90)])
    probs = np.repeat(stack[..., None], 4, axis=-1)
    want = jax_refine.refine_boundaries_stack(probs, JCFG)
    got = torch_refine.refine_boundaries_sharded(probs, TCFG, mesh=cpu_mesh(*mesh_shape))
    assert len(got) == 3 and all(r.num_cells > 3 for r in got)
    for g, w in zip(got, want, strict=True):
        _assert_results_equal(g, w)
    jax_refine.write_refine_stack_csv(want, str(tmp_path / "jax.csv"))
    torch_refine.write_refine_stack_csv(got, str(tmp_path / "torch.csv"))
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("stack", [False, True], ids=["plane", "stack"])
def test_refine_cli_space_parallel_matches_jax_cli(tmp_path, capsys, stack):
    arr = (np.concatenate([refine_probs(2), deep_planes()[:1]]) if stack
           else refine_probs(1, H=128, W=128, seed=5)[0])
    src = str(tmp_path / "probs.h5")
    with h5py.File(src, "w") as f:
        f.create_dataset("exported_data", data=arr)
    flags = ["--stack"] if stack else []
    assert jax_cli(["refine", src, "--csv", str(tmp_path / "jax.csv"),
                    "--out", str(tmp_path / "jax.h5"), *flags]) == 0
    jax_out = capsys.readouterr().out.splitlines()[0]
    assert torch_cli(["refine", src, "--device", "cpu", "--space-parallel", "2",
                      "--csv", str(tmp_path / "torch.csv"), "--out", str(tmp_path / "torch.h5"),
                      *flags]) == 0
    assert capsys.readouterr().out.splitlines()[0] == jax_out
    got = (tmp_path / "torch.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes() and got.count(b"\n") > 3
    with h5py.File(tmp_path / "jax.h5") as fj, h5py.File(tmp_path / "torch.h5") as ft:
        np.testing.assert_array_equal(ft["exported_data"][()], fj["exported_data"][()])


# ---- the JAX package's own sharded functions --------------------------------


_JAX_SHARDED = """
import json, sys
import numpy as np, jax.numpy as jnp
sys.path.insert(0, 'tests')
from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh
from particle_col_image_segmentation_tpu.parallel.sharded import (
    make_sharded_refine_fn, make_sharded_watershed_fn)
from test_torch_space_refine import corridor, refine_probs, watershed_planes
out = {}
img, mk, mask = watershed_planes(4)
cimg, cmk, cmask = corridor()
probs = refine_probs(2)
for nd, ns in %s:
    key = f"{nd}x{ns}"
    lab, conv = make_sharded_watershed_fn(make_mesh(n_data=nd, n_space=ns))(
        jnp.asarray(img), jnp.asarray(mk), jnp.asarray(mask))
    out[key + "/ws"] = [np.asarray(lab).tolist(), np.asarray(conv).tolist()]
    lab, conv = make_sharded_watershed_fn(make_mesh(n_data=1, n_space=ns), 1, 1)(
        jnp.asarray(cimg), jnp.asarray(cmk), jnp.asarray(cmask))
    out[key + "/starved"] = np.asarray(conv).tolist()
    res = make_sharded_refine_fn(make_mesh(n_data=nd, n_space=ns), max_regions=1024,
                                 with_tables=True)(jnp.asarray(probs))
    out[key + "/refine"] = [np.asarray(x).tolist() for x in res]
print(json.dumps(out))
"""


def test_jax_sharded_watershed_and_refine_equal_the_port():
    """JAX's ``make_sharded_watershed_fn`` and ``make_sharded_refine_fn``
    (``with_tables``) on its fixtures at 1×2, 1×4 and 2×2, and its
    starved one-step watershed on the corridor, against the port's: equal
    where both converge, and both unconverged where starved."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_COMPILATION_CACHE="false",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _JAX_SHARDED % (MESHES,)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.splitlines()[-1])
    img, mk, mask = watershed_planes(4)
    cimg, cmk, cmask = corridor()
    probs = refine_probs(2)
    for nd, ns in MESHES:
        key, mesh = f"{nd}x{ns}", cpu_mesh(nd, ns)
        lab, conv = sharded.make_sharded_watershed_fn(mesh)(img, mk, mask)
        assert all(want[key + "/ws"][1]) and bool(conv.all())
        np.testing.assert_array_equal(lab.numpy(), np.asarray(want[key + "/ws"][0]))
        _, starved = sharded.make_sharded_watershed_fn(cpu_mesh(1, ns), 1, 1)(cimg, cmk, cmask)
        assert want[key + "/starved"] == [False] and not bool(starved.any())
        got = sharded.make_sharded_refine_fn(mesh, max_regions=1024, with_tables=True)(probs)
        assert all(want[key + "/refine"][3]) and bool(got[3].all())
        for g, w in zip(got, want[key + "/refine"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
