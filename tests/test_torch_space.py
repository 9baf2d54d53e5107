"""Parity: the PyTorch port's space axis — ``parallel/halo.py``, the
band-sharded segment, tables, fill, merge and DAPI dedup of
``parallel/sharded.py``, ``run_batch`` / ``run_analysis`` on a mesh with a
space axis, and the ``batch`` / ``analyze`` verbs' ``--space-parallel`` —
against the JAX package's single-device functions and scipy, on the CPU.

A mesh here names the CPU several times (``["cpu"] * n``), so every band runs
the plain versions in a worker thread of its own.  Inputs are made with numpy
from a seed; planes are 64×64 to 96×128.  Everything compared is an integer,
a mask or a CSV, so the tolerance is exact equality.  The port's sharded
outputs are held to the JAX package's single-device ones (the JAX suite holds
its own sharded path to those); the one JAX sharded run, the starved budget,
runs in a fresh interpreter with the compilation cache off.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.labels import analysis as jax_analysis
from particle_col_image_segmentation_tpu.models import batch as jax_batch
from particle_col_image_segmentation_tpu.models import experiment as jax_experiment
from particle_col_image_segmentation_tpu.ops import ccl as jax_ccl
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import config_from_fields
from particle_col_image_segmentation_tpu_torch.labels import analysis as torch_analysis
from particle_col_image_segmentation_tpu_torch.models import batch as torch_batch
from particle_col_image_segmentation_tpu_torch.models import experiment as torch_experiment
from particle_col_image_segmentation_tpu_torch.parallel import halo, make_mesh, sharded

from fixtures import random_class_plane, synthetic_label_plane
from test_torch_analysis import (
    THREE,
    _csvs,
    _mixed_tree,
    _single_tree,
    _three_channel_tree,
    _two_channel_tree,
    assert_device_outs_equal,
)
from test_torch_batch import _assert_stats_equal, _h5_tree

CFG = AnalysisConfig(max_regions=4096)
TCFG = config_from_fields(CFG)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 2), (1, 4), (2, 2)]
torch.set_num_threads(1)  # several xdist workers share the host's cores


def cpu_mesh(n_data, n_space):
    return make_mesh(n_data=n_data, n_space=n_space, devices=["cpu"] * (n_data * n_space))


def _planes(n, shape, seed=0, cell_types=THREE):
    out = [synthetic_label_plane(seed=seed + i, cell_types=dict(cell_types), shape=shape)
           for i in range(n)]
    for i, p in enumerate(out):
        p[i::9, ::7] = 1  # salt for the median to clean, crossing the seams
    return np.stack(out)


# ---- parallel/halo.py ----------------------------------------------------


@pytest.mark.parametrize("mode,halo_rows,n", [
    ("symmetric", 2, 4), ("symmetric", 16, 4), ("constant", 20, 4), ("constant", 40, 4),
    ("constant", 3, 2), ("symmetric", 0, 2),
], ids=["sym-2", "sym-full-band", "const-two-hops", "const-three-hops", "const-3", "zero"])
def test_pad_with_halo_equals_the_padded_plane(mode, halo_rows, n):
    """Each padded band is the plane padded as numpy pads it, cut at the
    band's rows: neighbour rows inside, the edge mode at the true edges,
    several bands deep where the halo is taller than a band."""
    plane = np.random.default_rng(7).integers(0, 9, (3, 64, 24)).astype(np.int32)
    h = 64 // n
    bands = [torch.from_numpy(plane[:, j * h:(j + 1) * h]) for j in range(n)]
    kw = dict(constant_values=-5) if mode == "constant" else {}
    want = np.pad(plane, [(0, 0), (halo_rows, halo_rows), (0, 0)], mode=mode, **kw)
    got = halo.pad_with_halo(bands, halo_rows, mode, fill=-5)
    for j, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), want[:, j * h:(j + 1) * h + 2 * halo_rows])
    tops_bottoms = halo.exchange_rows(bands, halo_rows)
    zero = np.pad(plane, [(0, 0), (halo_rows, halo_rows), (0, 0)])
    for j, (top, bottom) in enumerate(tops_bottoms):
        np.testing.assert_array_equal(top.numpy(), zero[:, j * h:j * h + halo_rows])
        np.testing.assert_array_equal(bottom.numpy(),
                                      zero[:, (j + 1) * h + halo_rows:(j + 1) * h + 2 * halo_rows])


def test_pad_with_halo_errors_as_jax():
    bands = [torch.zeros((2, 8, 5), dtype=torch.uint8)] * 4
    with pytest.raises(ValueError, match="edge_mode must be 'symmetric' or 'constant', got 'reflect'"):
        halo.pad_with_halo(bands, 2, "reflect")
    with pytest.raises(ValueError, match="halo 9 > band height 8"):
        halo.pad_with_halo(bands, 9, "symmetric")
    with pytest.raises(ValueError, match="share one"):
        halo.pad_with_halo(bands[:3] + [torch.zeros((2, 7, 5), dtype=torch.uint8)], 2)
    # the JAX package raises for both as well (its halo check is an assert)
    import jax
    from jax.sharding import PartitionSpec as P

    from particle_col_image_segmentation_tpu.parallel import halo as jax_halo
    from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh

    with pytest.raises(ValueError, match="edge_mode must be 'symmetric' or 'constant', got 'reflect'"):
        jax_halo.pad_with_halo(jnp.zeros((8, 5)), 2, edge_mode="reflect")
    mesh = jax_make_mesh(n_data=1, n_space=2)
    fn = jax.shard_map(lambda x: jax_halo.pad_with_halo(x, 9), mesh=mesh,
                       in_specs=P(None, "space", None), out_specs=P(None, "space", None))
    with pytest.raises(AssertionError):
        jax.eval_shape(fn, jnp.zeros((2, 16, 5)))


# ---- the cross-band CCL --------------------------------------------------


def _snake(shape=(64, 48)):
    """One component that winds through every band: rows joined at
    alternating ends, on a background of another value."""
    img = np.full(shape, 3, np.uint8)
    for r in range(1, shape[0], 4):
        img[r, 1:-1] = 1
        end = shape[1] - 2 if (r // 4) % 2 == 0 else 1
        img[r:r + 4, end] = 1
    img[-1] = 3
    return img


def _diagonal(shape=(64, 48)):
    """Components that meet each seam only through a diagonal neighbour."""
    img = np.full(shape, 2, np.uint8)
    for r in range(shape[0]):
        img[r, (r * 3) % shape[1]] = 1
        img[r, (shape[1] - 1 - r) % shape[1]] = 0
    return img


def _three_bands(shape=(64, 48)):
    """A U that opens downward over three 16-row bands, its arms apart on
    the lower bands, plus random classes elsewhere."""
    img = random_class_plane(shape, n_classes=4, seed=11).astype(np.uint8)
    img[img == 5] = 4
    img[10:12, 5:40] = 5
    img[10:50, 5:7] = 5
    img[10:50, 38:40] = 5
    return img


def _same_value_rows(img):
    """The value-and-8-connectivity partition, by scipy: each component's
    pixels share one label."""
    lab = np.zeros(img.shape, np.int64)
    nxt = 0
    for v in np.unique(img):
        comp, n = ndi.label(img == v, structure=np.ones((3, 3)))
        lab[comp > 0] = comp[comp > 0] + nxt
        nxt += n
    return lab, nxt


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("make", [_snake, _diagonal, _three_bands],
                         ids=["snake", "diagonal-seam", "three-bands"])
def test_cross_band_ccl_matches_jax_and_scipy(make, mesh_shape):
    imgs = np.stack([make(), make()[::-1].copy()])
    # no median here: the CCL sees the planes themselves
    full = sharded.make_sharded_full_analysis_fn(cpu_mesh(*mesh_shape), TCFG, particle_val=4,
                                                 cell_vals=(1,), denoise=False)(imgs)
    lab, n_comp, seg = full[1], full[3], full[7]
    for b in range(2):
        want_lab = np.asarray(jax_ccl.connected_components(jnp.asarray(imgs[b]), background=None))
        want_seg, want_num = jax_ccl.compact_labels(jnp.asarray(want_lab), CFG.max_regions)
        np.testing.assert_array_equal(lab[b].numpy(), want_lab)
        np.testing.assert_array_equal(seg[b].numpy(), np.asarray(want_seg))
        part, n = _same_value_rows(imgs[b])
        assert int(n_comp[b]) == int(want_num) == n
        # one seg id a scipy component, and the other way round
        pairs = np.unique(np.stack([part.ravel(), seg[b].numpy().ravel()]), axis=1)
        assert pairs.shape[1] == n
    assert bool(full[6].all())


# ---- the sharded factories against the single-device graphs --------------


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "1x4", "2x2"])
def test_space_sharded_segment_fn_matches_jax_fused_segment(mesh_shape):
    imgs = _planes(4, (64, 96), seed=3)
    imgs[3] = random_class_plane((64, 96), n_classes=4, seed=5)
    mesh = cpu_mesh(*mesh_shape)
    fn = torch_batch.make_space_sharded_segment_fn(mesh, TCFG, particle_val=4, cell_vals=(1, 2, 3))
    outs = fn(sharded.split_bands(imgs, mesh))
    want = jax_batch.fused_segment_batch(jnp.asarray(imgs), CFG, 4, (1, 2, 3))
    one = torch_batch.fused_segment_batch(torch.from_numpy(imgs), TCFG, 4, (1, 2, 3))
    b = 4 // mesh_shape[0]
    for i, out in enumerate(outs):
        seg = torch.cat(list(out[0]), dim=-2)
        rows = slice(i * b, (i + 1) * b)
        np.testing.assert_array_equal(seg.numpy(), np.asarray(want[0])[rows])
        valid = out[2].numpy() > 0  # JAX's class table holds INT32_MIN on empty rows
        for k in range(1, 8):
            g, w = out[k].numpy(), np.asarray(want[k])[rows]
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g[valid] if k == 3 else g, w[valid] if k == 3 else w,
                                          err_msg=str(k))
            np.testing.assert_array_equal(g, one[k].numpy()[rows], err_msg=str(k))


def _assert_sharded_equals_single(full, want, S):
    """The full-analysis tuple against a single-device PlaneDeviceOut of a
    batch (JAX's or the port's), every field exact."""
    (den, lab, particle_ct, n_comp, filled, overlap, conv, seg, area, class_id,
     sr_hi, sr_lo, sc_hi, sc_lo, bbox, g_ctx) = full
    np.testing.assert_array_equal(den.numpy(), np.asarray(want.den))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(want.seg))
    np.testing.assert_array_equal(n_comp.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(particle_ct.numpy(), np.asarray(want.particle_area))
    np.testing.assert_array_equal(filled.numpy(), np.asarray(want.filled))
    np.testing.assert_array_equal(overlap.numpy(), np.asarray(want.overlap_counts).T.reshape(overlap.shape))
    assert bool(conv.all()) and bool(np.asarray(want.converged).all())
    valid = np.asarray(want.table.valid)
    np.testing.assert_array_equal(area.numpy(), np.asarray(want.table.area))
    for name, got in (("class_id", class_id), ("sr_hi", sr_hi), ("sr_lo", sr_lo),
                      ("sc_hi", sc_hi), ("sc_lo", sc_lo), ("bbox", bbox)):
        np.testing.assert_array_equal(got.numpy()[valid], np.asarray(getattr(want.table, name))[valid],
                                      err_msg=name)
    # g_ctx: each dilated component's minimum linear index, as the one-device
    # graph holds it, so the grouping partition is the same too
    np.testing.assert_array_equal(g_ctx.numpy(), np.moveaxis(np.asarray(want.g_ctx), 0, 1))
    assert g_ctx.shape[1] == S + 1


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "1x4", "2x2"])
def test_sharded_full_analysis_matches_jax_analyze_planes_device(mesh_shape):
    imgs = _planes(2, (96, 128), seed=21)
    full = sharded.make_sharded_full_analysis_fn(
        cpu_mesh(*mesh_shape), TCFG, particle_val=4, cell_vals=(1, 2, 3))(imgs)
    want = jax_analysis.analyze_planes_device(jnp.asarray(imgs), THREE, CFG)
    _assert_sharded_equals_single(full, want, 3)
    assert (full[-1].numpy()[..., 1:] >= 0).any()
    single = torch_analysis.analyze_planes_device(torch.from_numpy(imgs), THREE, TCFG)
    np.testing.assert_array_equal(full[1].numpy(), torch_analysis.connected_components_auto(
        single.den, num_classes=8, max_iters=TCFG.ccl_max_iters).numpy())


@pytest.mark.parametrize("compute_merge,denoise", [(True, True), (False, True), (True, False)],
                         ids=["merge", "no-merge", "undenoised"])
@pytest.mark.parametrize("n_space", [2, 4])
def test_analyze_plane_device_sharded_matches_jax(n_space, compute_merge, denoise):
    img = _planes(1, (64, 96), seed=9)[0]
    got = torch_analysis.analyze_plane_device_sharded(
        img, THREE, TCFG, cpu_mesh(1, n_space), compute_merge=compute_merge, denoise=denoise)
    want = jax_analysis.analyze_plane_device(jnp.asarray(img), THREE, CFG,
                                             compute_merge=compute_merge, denoise=denoise)
    assert_device_outs_equal(got, want)
    one = torch_analysis.analyze_plane_device(torch.from_numpy(img), THREE, TCFG,
                                              compute_merge=compute_merge, denoise=denoise)
    assert_device_outs_equal(got, one)


def test_sharded_errors_name_both_numbers():
    img = _planes(1, (64, 96))[0]
    with pytest.raises(ValueError, match="plane height 64 is not a multiple of the mesh's space axis \\(3\\)"):
        torch_analysis.analyze_plane_device_sharded(img, THREE, TCFG, cpu_mesh(1, 3))
    with pytest.raises(ValueError, match="the mesh data axis must be 1"):
        torch_analysis.analyze_plane_device_sharded(img, THREE, TCFG, cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="3 planes do not split over the mesh's data axis \\(2\\)"):
        sharded.sharded_segment_batch(_planes(3, (64, 96)), cpu_mesh(2, 2), TCFG)
    with pytest.raises(ValueError, match="takes make_space_sharded_segment_fn"):
        torch_batch.make_fused_segment_fn(cpu_mesh(1, 2), TCFG)


def test_segment_fn_without_tables_matches_jax():
    """The bare step (den, labels, counts, fill) and ``sharded_segment_batch``."""
    imgs = _planes(2, (64, 64), seed=30, cell_types=((1, "3D05"), (2, "Particle"), (3, "Background")))
    out = sharded.sharded_segment_batch(imgs, cpu_mesh(1, 4), TCFG, particle_val=2, cell_vals=(1,))
    assert len(out) == 7
    want = jax_analysis.analyze_planes_device(
        jnp.asarray(imgs), ((1, "3D05"), (2, "Particle"), (3, "Background")), CFG)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want.den))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(want.particle_area))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(want.filled))
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(want.overlap_counts).sum(axis=0))
    np.testing.assert_array_equal(
        out[1].numpy(),
        np.stack([np.asarray(jax_ccl.connected_components(want.den[b], background=None))
                  for b in range(2)]))


# ---- budgets: the seam join needs none -----------------------------------


_JAX_STARVED = """
import numpy as np, jax.numpy as jnp, sys
sys.path.insert(0, 'tests')
from fixtures import synthetic_label_plane
from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.models.batch import make_space_sharded_segment_fn
from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh
batch = np.stack([synthetic_label_plane(seed=3, shape=(64, 64))])
out = make_space_sharded_segment_fn(make_mesh(n_data=1, n_space=4),
                                    AnalysisConfig(max_regions=4096, sharded_max_iters=1))(jnp.asarray(batch))
print('converged', bool(np.asarray(out[-1]).all()))
"""


def test_starved_sharded_budget_still_converges_and_equals_one_device():
    """JAX's distributed fixpoints stop at ``sharded_max_iters`` and flag the
    plane; the port's seam join is exact in one pass, so with the budget
    starved to 1 it reports converged and equals the one-device run."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_COMPILATION_CACHE="false",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _JAX_STARVED], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "False"
    batch = np.stack([synthetic_label_plane(seed=3, shape=(64, 64))])
    starved = dataclasses.replace(TCFG, sharded_max_iters=1)
    mesh = cpu_mesh(1, 4)
    outs = torch_batch.make_space_sharded_segment_fn(mesh, starved)(sharded.split_bands(batch, mesh))
    one = torch_batch.fused_segment_batch(torch.from_numpy(batch), starved)
    assert bool(outs[0][-1].all())
    np.testing.assert_array_equal(torch.cat(list(outs[0][0]), -2).numpy(), one[0].numpy())
    for k in range(1, 8):
        np.testing.assert_array_equal(outs[0][k].numpy(), one[k].numpy())


# ---- DAPI dedup ------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)], ids=["1x2", "1x4", "2x2"])
def test_sharded_dapi_dedup_matches_jax(mesh_shape):
    rng = np.random.default_rng(4)
    dapi = np.stack([synthetic_label_plane(seed=s, cell_types={1: "6B07", 2: "Particle", 3: "Background"},
                                           shape=(64, 96)) for s in (1, 2)])
    other = np.where(rng.random(dapi.shape) < 0.3, 1, 3).astype(np.uint8)
    other[0, :, 40:] = 1  # whole cells under the other channel
    out, num, conv = sharded.make_sharded_dapi_dedup_fn(cpu_mesh(*mesh_shape), TCFG)(dapi, other)
    assert bool(conv.all())
    for b in range(2):
        want, wconv = jax_analysis.dapi_dedup_device(jnp.asarray(dapi[b]), jnp.asarray(other[b]), CFG)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(want))
        assert int(num[b]) == _same_value_rows((dapi[b] == 1).astype(np.uint8))[1]
    assert (out.numpy() == 2).sum() > (dapi == 2).sum()


def test_sharded_dapi_dedup_overflow_raises_as_jax(tmp_path, monkeypatch):
    """The count comes back with the plane, true past ``max_regions``, and
    the multi-channel flow raises on it before using the verdicts."""
    speckle = (np.random.default_rng(0).random((1, 64, 64)) < 0.5).astype(np.uint8)
    _, num, _ = sharded.make_sharded_dapi_dedup_fn(cpu_mesh(1, 4), dataclasses.replace(TCFG, max_regions=8))(
        speckle, speckle)
    assert int(num[0]) == _same_value_rows(speckle[0])[1] > 8
    real = sharded.make_sharded_dapi_dedup_fn

    def counted_past_capacity(mesh, cfg, max_iters=128):
        fn = real(mesh, cfg, max_iters)

        def run(dapi, other):
            out, n, conv = fn(dapi, other)
            return out, n + cfg.max_regions, conv
        return run

    monkeypatch.setattr(torch_experiment, "make_sharded_dapi_dedup_fn", counted_past_capacity)
    _three_channel_tree(tmp_path)
    with pytest.raises(ValueError, match="DAPI plane has .* components > max_regions=4096"):
        torch_experiment.run_analysis(str(tmp_path), TCFG, make_figures=False, mesh=cpu_mesh(1, 2))


# ---- run_batch, run_analysis and the verbs ---------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "1x4", "2x2"])
def test_run_batch_space_mesh_matches_jax_and_one_device(mesh_shape):
    planes = {f"p{i}": synthetic_label_plane(seed=70 + i, shape=(64, 64)) for i in range(5)}
    planes["speckle"] = np.random.default_rng(0).integers(1, 4, (64, 64)).astype(np.uint8)
    kw = dict(batch_size=4, particle_val=2, cell_vals=(1,))
    cfg = AnalysisConfig(max_regions=64)
    want = dict(jax_batch.run_batch(list(planes), planes.__getitem__, cfg, **kw))
    one = dict(torch_batch.run_batch(list(planes), planes.__getitem__, config_from_fields(cfg),
                                     device="cpu", **kw))
    got = dict(torch_batch.run_batch(list(planes), planes.__getitem__, config_from_fields(cfg),
                                     mesh=cpu_mesh(*mesh_shape), **kw))
    _assert_stats_equal(got, want)
    _assert_stats_equal(got, one)
    assert got["speckle"].overflow and not got["p0"].overflow


@pytest.mark.parametrize("tree,n_space,n_csvs", [
    (_single_tree, 2, 7),
    (_three_channel_tree, 4, 4),
    (_two_channel_tree, 2, 4),
], ids=["single-file", "6B07_C3M10", "3D05_6B07"])
def test_run_analysis_space_mesh_csvs_byte_identical_to_jax(tmp_path, tree, n_space, n_csvs):
    tree(tmp_path / "jax")
    tree(tmp_path / "torch")
    jax_experiment.run_analysis(str(tmp_path / "jax"), CFG, make_figures=False)
    torch_experiment.run_analysis(str(tmp_path / "torch"), TCFG, make_figures=False,
                                  mesh=cpu_mesh(1, n_space))
    want, got = _csvs(tmp_path / "jax"), _csvs(tmp_path / "torch")
    assert sorted(got) == sorted(want) and len(want) == n_csvs
    for rel in want:
        assert got[rel] == want[rel], rel
    with pytest.raises(ValueError, match="cannot combine with space sharding"):
        torch_experiment.run_analysis(str(tmp_path / "torch"), TCFG, make_figures=False,
                                      mesh=cpu_mesh(1, n_space), batch_planes=2)


def test_cli_analyze_space_parallel_matches_jax_cli(tmp_path, capsys):
    _mixed_tree(tmp_path / "jax")
    _mixed_tree(tmp_path / "torch")
    flags = ["--no-figures", "--max-regions", "4096"]
    assert jax_cli(["analyze", str(tmp_path / "jax"), *flags]) == 0
    assert torch_cli(["analyze", str(tmp_path / "torch"), "--device", "cpu",
                      "--space-parallel", "4", *flags]) == 0
    assert _csvs(tmp_path / "torch") == _csvs(tmp_path / "jax")


@pytest.mark.parametrize("mesh_flags", [["--space-parallel", "2"],
                                        ["--space-parallel", "2", "--data-parallel", "2"]],
                         ids=["space", "space-and-data"])
def test_cli_batch_space_parallel_matches_jax_cli(tmp_path, capsys, monkeypatch, mesh_flags):
    """Each package on its own copy of the tree, from its copy's parent (the
    CSV names planes by path)."""
    _h5_tree(tmp_path / "jax" / "exp")
    shutil.copytree(tmp_path / "jax" / "exp", tmp_path / "torch" / "exp")
    args = ["batch", "exp", "--batch-size", "2", "--max-regions", "1023"]
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_cli(args + ["--csv", "out.csv"]) == 0
    jax_out = capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "torch")
    assert torch_cli(args + mesh_flags + ["--csv", "out.csv", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    got = (tmp_path / "torch" / "out.csv").read_bytes()
    assert got == (tmp_path / "jax" / "out.csv").read_bytes() and got.count(b",ok") == 5
