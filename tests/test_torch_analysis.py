"""Parity: the PyTorch port's analysis plane — ``labels.analysis``,
``models.single_channel``, ``models.multichannel``, ``models.experiment`` and
the ``analyze`` CLI verb — against the JAX package and the NumPy oracle, on
the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
state that crosses between them is the frozen ``AnalysisConfig`` and the
label planes; every device output is an integer or a mask, so the tolerance
is exact equality, and CSVs must be byte-identical.  Region tables are
compared on valid rows, plus ``area`` on every row (the JAX scatter path
holds segment-max identities on empty rows, the port zeros).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.config import BASE_TYPE_MAP, AnalysisConfig
from particle_col_image_segmentation_tpu.io.hdf5 import save_h5_plane
from particle_col_image_segmentation_tpu.labels import analysis as jax_analysis
from particle_col_image_segmentation_tpu.models import experiment as jax_experiment
from particle_col_image_segmentation_tpu.oracle import reference_pipeline as rp
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import config_from_fields
from particle_col_image_segmentation_tpu_torch.labels import analysis as torch_analysis
from particle_col_image_segmentation_tpu_torch.models import experiment as torch_experiment
from particle_col_image_segmentation_tpu_torch.models import single_channel as torch_single

import parity
from fixtures import synthetic_label_plane

CFG = AnalysisConfig(max_regions=4096)
TCFG = config_from_fields(CFG)  # the port's own config, same fields
CPU = torch.device("cpu")
# The suite runs in several pytest-xdist workers that share the host's cores,
# and every worker collects this module.  One intra-op thread a worker keeps
# torch from oversubscribing them: the JAX package's multi-device CPU tests
# abort when their collectives' threads are starved.
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SINGLE = ((1, "3D05"), (2, "Particle"), (3, "Background"))
THREE = tuple(sorted(BASE_TYPE_MAP.items()))  # 3D05, 6B07, C3M10, Particle, Background


def device_out_to_numpy(out):
    """Carry a PlaneDeviceOut of either package across to numpy, field by
    field (the table as a dict of its columns)."""
    fields = {}
    for name, leaf in zip(out._fields, out):
        if name == "table":
            fields[name] = {c: np.asarray(torch_single.host(v)) for c, v in zip(leaf._fields, leaf)}
        else:
            fields[name] = np.asarray(torch_single.host(leaf))
    return fields


def assert_device_outs_equal(got, want):
    """Every field equal, exactly: dtypes, shapes and values; the table on
    valid rows plus ``area`` on every row."""
    g, w = device_out_to_numpy(got), device_out_to_numpy(want)
    assert list(g) == list(w)
    for name in w:
        if name == "table":
            valid = w[name]["valid"]
            for col, wv in w[name].items():
                gv = g[name][col]
                assert gv.shape == wv.shape and gv.dtype == wv.dtype, col
                if col in ("area", "valid"):
                    np.testing.assert_array_equal(gv, wv, err_msg=col)
                else:
                    np.testing.assert_array_equal(gv[valid], wv[valid], err_msg=col)
        else:
            assert g[name].shape == w[name].shape, name
            assert g[name].dtype == w[name].dtype, name
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def _plane(cell_types, seed, shape=(128, 128)):
    return synthetic_label_plane(seed=seed, cell_types=dict(cell_types), shape=shape)


@pytest.mark.parametrize("compute_merge", [True, False])
@pytest.mark.parametrize("cell_types", [SINGLE, THREE], ids=["one-strain", "three-strain"])
def test_analyze_plane_device_matches_jax(cell_types, compute_merge):
    img = _plane(cell_types, seed=5)
    img[::9, ::7] = 1  # salt for the median filter to clean
    got = torch_analysis.analyze_plane_device(
        torch.from_numpy(img), cell_types, TCFG, compute_merge=compute_merge)
    want = jax_analysis.analyze_plane_device(
        jnp.asarray(img), cell_types, CFG, compute_merge=compute_merge)
    assert_device_outs_equal(got, want)
    assert bool(got.converged) and int(got.num) > 1
    if compute_merge:
        assert (got.g_ctx.numpy()[:, 1 : int(got.num) + 1] >= 0).any()


@pytest.mark.parametrize("cell_types", [SINGLE, THREE], ids=["one-strain", "three-strain"])
def test_analyze_planes_device_matches_jax_and_single_planes(cell_types):
    imgs = np.stack([_plane(cell_types, seed=20 + b, shape=(96, 112)) for b in range(3)])
    got = torch_analysis.analyze_planes_device(torch.from_numpy(imgs), cell_types, TCFG)
    want = jax_analysis.analyze_planes_device(jnp.asarray(imgs), cell_types, CFG)
    assert_device_outs_equal(got, want)
    for b in range(3):
        one = torch_analysis.analyze_plane_device(torch.from_numpy(imgs[b]), cell_types, TCFG)
        assert_device_outs_equal(torch_analysis.split_plane_device_out(got, b), one)


def test_stage_merge_of_one_plane_matches_jax():
    """The single-plane merge stage (the JAX package's ``_stage_merge``):
    raw K2 roots under every row's truncated centroid, empty rows included."""
    img = _plane(THREE, seed=7)
    strain_vals = (1, 2, 3)
    den, _, _, table, _, _ = torch_analysis._stage_segment(torch.from_numpy(img), TCFG, True, 4)
    g_ctx, conv = torch_analysis._stage_merge(den, table, TCFG, strain_vals)
    jden, _, _, jtable, _, _ = jax_analysis._stage_segment(
        jnp.asarray(img), cfg=CFG, denoise=True, particle_val=4)
    want, wconv = jax_analysis._stage_merge(jden, jtable, cfg=CFG, strain_vals=strain_vals)
    assert g_ctx.shape == (4, CFG.max_regions + 1) and g_ctx.dtype == torch.int32
    np.testing.assert_array_equal(g_ctx.numpy(), np.asarray(want))
    assert bool(conv) and bool(wconv)


def test_analyze_undenoised_plane_matches_jax():
    img = _plane(THREE, seed=31)
    got = torch_analysis.analyze_plane_device(torch.from_numpy(img), THREE, TCFG, denoise=False)
    want = jax_analysis.analyze_plane_device(jnp.asarray(img), THREE, CFG, denoise=False)
    assert_device_outs_equal(got, want)


def test_dapi_dedup_matches_jax_and_oracle_at_one_in_ten():
    """A 10-px DAPI cell under 1 px of the other channel's cells has
    ov/area = 0.1: not above the 0.1 threshold in float32, so it stays; one
    under 2 px goes.  Plus the random cells of a synthetic pair."""
    dapi = synthetic_label_plane(seed=42, cell_types={1: "6B07", 2: "Particle", 3: "Background"},
                                 shape=(96, 96))
    other = synthetic_label_plane(seed=43, cell_types={1: "C3M10", 2: "Particle", 3: "Background"},
                                  shape=(96, 96))
    dapi[:8, :16] = 3
    other[:8, :16] = 3
    dapi[1:3, 1:6] = 1  # area 10
    other[1, 1] = 1  # overlap 1
    dapi[1:3, 9:14] = 1  # area 10
    other[2, 9:11] = 1  # overlap 2
    got, conv = torch_analysis.dapi_dedup_device(torch.from_numpy(dapi), torch.from_numpy(other), TCFG)
    want, wconv = jax_analysis.dapi_dedup_device(jnp.asarray(dapi), jnp.asarray(other), CFG)
    assert bool(conv) and bool(wconv)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), rp.combine_cell_positions_and_clusters(dapi, other, CFG))
    assert (got.numpy()[1:3, 1:6] == 1).all() and (got.numpy()[1:3, 9:14] == 2).all()


@pytest.mark.parametrize("seed,cell_types", [
    (1, {1: "3D05", 2: "Particle", 3: "Background"}),
    (2, dict(BASE_TYPE_MAP)),
])
def test_analyze_plane_passes_the_oracle_parity_checks(monkeypatch, seed, cell_types):
    """tests/parity.py's assertion body, run on the port's analyze_plane."""
    monkeypatch.setattr(parity, "analyze_plane",
                        functools.partial(torch_single.analyze_plane, device="cpu"))
    img = synthetic_label_plane(seed=seed, cell_types=cell_types, shape=(160, 160))
    ours = parity.assert_plane_parity(img, cell_types, CFG)
    assert isinstance(ours, torch_single.PlaneAnalysis)


@pytest.mark.parametrize("cell_types", [dict(SINGLE), {1: "3D05", 2: "C3M10", 3: "Particle",
                                                        4: "Background"}],
                         ids=["1strain", "2strain"])
@pytest.mark.parametrize("seed", [0, 3])
def test_analyze_plane_equals_the_ports_own_oracle(seed, cell_types):
    """The port's ``oracle.parity.assert_plane_parity`` (the check the card
    runs at 2048² in chip_smoke.py) on JAX's test_single_channel.py planes:
    the port's CPU ``analyze_plane(merged=True)`` against the port's oracle."""
    from particle_col_image_segmentation_tpu_torch.oracle import parity as torch_parity

    img = synthetic_label_plane(seed=seed, cell_types=cell_types, shape=(192, 192))
    ours = torch_single.analyze_plane(img, cell_types, TCFG, merged=True, device="cpu")
    seen = torch_parity.assert_plane_parity(ours, img, cell_types, TCFG)
    assert seen["regions"] > 5 and seen["groups"] > 0
    broken = dataclasses.replace(ours, particle_area=ours.particle_area + 1)
    with pytest.raises(AssertionError, match="particle area"):
        torch_parity.assert_plane_parity(broken, img, cell_types, TCFG)


def test_analyze_plane_errors_match_jax():
    from particle_col_image_segmentation_tpu.models.single_channel import (
        analyze_plane as jax_analyze_plane,
    )

    img = np.random.default_rng(0).integers(1, 4, (64, 64)).astype(np.uint8)  # speckle
    tiny = AnalysisConfig(max_regions=8)
    messages = []
    for analyze, cfg in ((functools.partial(torch_single.analyze_plane, device="cpu"),
                          config_from_fields(tiny)),
                         (jax_analyze_plane, tiny)):
        with pytest.raises(ValueError, match="components > max_regions=8") as e:
            analyze(img, dict(SINGLE), cfg, denoise=False)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    plane = _plane(SINGLE, seed=3, shape=(64, 64))
    out = torch_analysis.analyze_plane_device(torch.from_numpy(plane), SINGLE, TCFG,
                                              compute_merge=False)
    with pytest.raises(ValueError, match="compute_merge=False"):
        torch_single.analyze_plane(plane, dict(SINGLE), TCFG, merged=True, device_out=out)


# ---- folder flows: CSVs byte-identical to the JAX package's ----------------


def _single_tree(root):
    for i in range(3):
        folder = root / "exp" / "24h" / f"Tp_3D05_{i}_24h_60X"
        folder.mkdir(parents=True)
        img = synthetic_label_plane(seed=60 + i, cell_types=dict(SINGLE), shape=(160, 160))
        save_h5_plane(str(folder / f"Tp_3D05_{i}_24h_60X_labels.h5"), img[None])


def _three_channel_tree(root):
    folder = root / "6B07_C3M10" / "48h" / "Tp_2_48h_60X_3"
    folder.mkdir(parents=True)
    planes = {
        "RFP": synthetic_label_plane(seed=41, cell_types={1: "Particle", 2: "Background"},
                                     shape=(160, 160), n_cells_per_strain=0,
                                     n_clusters_per_strain=0),
        "DAPI": synthetic_label_plane(seed=42, cell_types={1: "6B07", 2: "Particle", 3: "Background"},
                                      shape=(160, 160)),
        "GFP": synthetic_label_plane(seed=43, cell_types={1: "C3M10", 2: "Particle", 3: "Background"},
                                     shape=(160, 160)),
    }
    for ch, arr in planes.items():
        save_h5_plane(str(folder / f"Tp_2_48h_60X_3_{ch}_labels.h5"), arr)


def _two_channel_tree(root):
    folder = root / "3D05_6B07" / "24h" / "Tp_1_24h_60X_7"
    folder.mkdir(parents=True)
    save_h5_plane(str(folder / "Tp_1_24h_60X_7_RFP_labels.h5"),
                  synthetic_label_plane(seed=31, cell_types=dict(SINGLE), shape=(160, 160)))
    save_h5_plane(str(folder / "Tp_1_24h_60X_7_DAPI_labels.h5"),
                  synthetic_label_plane(seed=32, cell_types={1: "6B07", 2: "Particle", 3: "Background"},
                                        shape=(160, 160)))


def _mixed_tree(root):
    _single_tree(root)
    _three_channel_tree(root)
    _two_channel_tree(root)


def _csvs(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".csv"):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("tree,batch_planes,n_csvs", [
    (_single_tree, 1, 7),
    (_three_channel_tree, 1, 4),
    (_two_channel_tree, 1, 4),
    (_mixed_tree, 3, 15),
], ids=["single-file", "6B07_C3M10", "3D05_6B07", "mixed-batch_planes=3"])
def test_run_analysis_csvs_byte_identical_to_jax(tmp_path, tree, batch_planes, n_csvs):
    tree(tmp_path / "jax")
    tree(tmp_path / "torch")
    jax_experiment.run_analysis(str(tmp_path / "jax"), CFG, make_figures=False,
                                batch_planes=batch_planes)
    torch_experiment.run_analysis(str(tmp_path / "torch"), TCFG, make_figures=False,
                                  device=CPU, batch_planes=batch_planes)
    want, got = _csvs(tmp_path / "jax"), _csvs(tmp_path / "torch")
    assert sorted(got) == sorted(want) and len(want) == n_csvs
    for rel in want:
        assert got[rel] == want[rel], rel


def test_run_analysis_load_fn_reads_every_plane(tmp_path):
    """``load_fn`` replaces the HDF5 reader in the folder flow and in the
    batched provider alike: empty placeholder files are enough."""
    _single_tree(tmp_path / "h5")
    planes = {}
    for d, _, files in os.walk(tmp_path / "h5"):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), tmp_path / "h5")
            dst = tmp_path / "stub" / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(b"")
            from particle_col_image_segmentation_tpu.io.hdf5 import load_h5_plane

            planes[str(dst)] = load_h5_plane(os.path.join(d, f))
    torch_experiment.run_analysis(str(tmp_path / "h5"), TCFG, make_figures=False, device=CPU)
    for batch_planes in (1, 2):
        for f in (tmp_path / "stub").rglob("*.csv"):
            f.unlink()
        torch_experiment.run_analysis(str(tmp_path / "stub"), TCFG, make_figures=False,
                                      device=CPU, batch_planes=batch_planes,
                                      load_fn=planes.__getitem__)
        assert _csvs(tmp_path / "stub") == _csvs(tmp_path / "h5")


def test_batched_provider_bound_on_channel_trees(tmp_path):
    """On a tree of C-channel folders the provider keeps up to about
    C·batch_planes planes live (one chunk per channel map), and every
    consumed entry drops for good."""
    from particle_col_image_segmentation_tpu.io.discovery import get_h5_files_recursively

    for i in range(4):
        sub = tmp_path / f"t{i}"
        _three_channel_tree(sub)
    folders = get_h5_files_recursively(str(tmp_path))
    outs = torch_experiment._BatchedDeviceOuts(folders, TCFG, 2, CPU)
    assert outs.peak_live == 0
    got = 0
    for folder, files in folders.items():
        for f in files:
            pre = outs.get(os.path.join(folder, f))
            if pre is not None:
                got += 1
                assert outs.get(os.path.join(folder, f)) is None
            assert outs.live <= 3 * 2
    assert got == 12 and outs.live == 0 and 2 < outs.peak_live <= 3 * 2


def test_cli_analyze_csvs_byte_identical_to_jax(tmp_path, capsys):
    _mixed_tree(tmp_path / "jax")
    _mixed_tree(tmp_path / "torch")
    flags = ["--no-figures", "--max-regions", "4096"]
    assert jax_cli(["analyze", str(tmp_path / "jax"), *flags]) == 0
    assert torch_cli(["analyze", str(tmp_path / "torch"), "--device", "cpu",
                      "--batch-planes", "2", "--profile", *flags]) == 0
    assert "profile: analyze_plane" in capsys.readouterr().out
    assert _csvs(tmp_path / "torch") == _csvs(tmp_path / "jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_cli(["analyze", str(tmp_path / "torch"), "--device", "cuda", *flags])


def test_analysis_modules_import_no_jax():
    """Import each module of this slice and of the refine slice in a fresh
    interpreter, run the analysis graph on the CPU, and check that neither
    jax nor the JAX package was ever loaded."""
    modules = [
        "ops.regionprops", "ops.regionprops_tiles", "ops.edt", "ops.edt_tiles",
        "ops.morphology", "ops.fill_tiles", "labels.analysis",
        "models.single_channel", "models.multichannel", "models.experiment", "cli",
        "ops.watershed", "ops.watershed_tiles", "ops.pairwise", "models.refine",
        "oracle.reference_pipeline", "report.csvio", "io.discovery", "utils.manifest",
    ]
    code = (
        "import importlib, sys\n"
        "import numpy as np, torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('particle_col_image_segmentation_tpu_torch.' + m)\n"
        "    assert 'jax' not in sys.modules, m\n"
        "    assert 'particle_col_image_segmentation_tpu' not in sys.modules, m\n"
        "from particle_col_image_segmentation_tpu_torch import AnalysisConfig\n"
        "from particle_col_image_segmentation_tpu_torch.labels.analysis import analyze_plane_device\n"
        "img = np.random.default_rng(0).integers(1, 4, (48, 40)).astype(np.uint8)\n"
        "ct = ((1, '3D05'), (2, 'Particle'), (3, 'Background'))\n"
        "out = analyze_plane_device(torch.from_numpy(img), ct, AnalysisConfig(max_regions=1024))\n"
        "assert bool(out.converged) and int(out.num) > 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'particle_col_image_segmentation_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
