"""Parity: the PyTorch port's fused segmentation pass, ``run_batch``, batch
loader and ``batch`` CLI verb against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; every
output is an integer, so the tolerance is exact equality, except that class
tables are compared only on rows with ``area > 0`` (the JAX scatter path
holds INT32_MIN on empty rows, the port 0).
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.models import batch as jax_batch
from particle_col_image_segmentation_tpu.utils.manifest import RunManifest
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import config_from_fields
from particle_col_image_segmentation_tpu_torch.io.loader import batched_device_iterator
from particle_col_image_segmentation_tpu_torch.models import batch as torch_batch

from fixtures import synthetic_label_plane

CFG = AnalysisConfig(max_regions=4096)
TCFG = config_from_fields(CFG)  # the port's own config, same fields
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(n=3, seed=0, shape=(96, 96)):
    return {f"plane{i}": synthetic_label_plane(seed=seed + i, shape=shape)
            for i in range(n)}


def _assert_stats_equal(got, want):
    assert list(got) == list(want)
    for path in want:
        g, w = got[path], want[path]
        assert (g.num_regions, g.particle_px, g.cell_px, g.overflow, g.converged) == (
            w.num_regions, w.particle_px, w.cell_px, w.overflow, w.converged
        ), path
        np.testing.assert_array_equal(g.class_px, w.class_px)


@pytest.mark.parametrize("cell_vals", [(1,), ()])
def test_fused_segment_batch_matches_jax(cell_vals):
    imgs = np.stack(list(_planes().values()))
    imgs[:, ::11, ::13] = 1  # salt
    got = torch_batch.fused_segment_batch(torch.from_numpy(imgs), TCFG, 2, cell_vals)
    want = jax_batch.fused_segment_batch(jnp.asarray(imgs), CFG, 2, cell_vals)
    names = ["seg", "num", "areas", "classes", "particle_px", "cell_px",
             "class_px", "converged"]
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "classes":
            valid = got[2].numpy() > 0
            np.testing.assert_array_equal(g[valid], w[valid])
            assert (g[~valid] == 0).all()
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[-1].all()


def test_run_batch_matches_jax_and_resumes(tmp_path):
    planes = _planes()
    kw = dict(batch_size=2, particle_val=2, cell_vals=(1,))
    want = dict(jax_batch.run_batch(list(planes), planes.__getitem__, CFG, **kw))
    manifest = RunManifest(str(tmp_path / "m.jsonl"))
    got = dict(torch_batch.run_batch(list(planes), planes.__getitem__, TCFG,
                                     device=CPU, manifest=manifest, **kw))
    _assert_stats_equal(got, want)
    assert all(manifest.is_done(p) for p in planes)
    again = list(torch_batch.run_batch(list(planes), planes.__getitem__, TCFG,
                                       device=CPU, manifest=manifest, **kw))
    assert again == []


def test_run_batch_overflow_matches_jax_and_is_retried(tmp_path):
    rng = np.random.default_rng(0)
    plane = rng.integers(1, 4, (64, 64)).astype(np.uint8)  # speckle
    tiny = AnalysisConfig(max_regions=8)
    want = dict(jax_batch.run_batch(["p"], lambda k: plane, tiny, batch_size=1))
    manifest = RunManifest(str(tmp_path / "m.jsonl"))
    got = dict(torch_batch.run_batch(["p"], lambda k: plane, config_from_fields(tiny), device=CPU,
                                     batch_size=1, manifest=manifest))
    _assert_stats_equal(got, want)
    assert got["p"].overflow and got["p"].num_regions > 8
    assert not manifest.is_done("p")
    (_, s2), = torch_batch.run_batch(["p"], lambda k: plane, TCFG, device=CPU,
                                     batch_size=1, manifest=manifest)
    assert not s2.overflow and manifest.is_done("p")


def test_run_batch_skips_failed_decode_with_path_alignment(tmp_path):
    planes = _planes()

    def load(key):
        if key == "plane1":
            raise OSError("truncated file")
        return planes[key]

    want = dict(jax_batch.run_batch(list(planes), load, CFG, batch_size=2))
    manifest = RunManifest(str(tmp_path / "m.jsonl"))
    got = dict(torch_batch.run_batch(list(planes), load, TCFG, device=CPU,
                                     batch_size=2, manifest=manifest))
    assert set(got) == {"plane0", "plane2"}
    _assert_stats_equal(got, want)
    assert manifest.is_done("plane0") and not manifest.is_done("plane1")
    again = dict(torch_batch.run_batch(list(planes), planes.__getitem__, TCFG,
                                       device=CPU, batch_size=2, manifest=manifest))
    assert set(again) == {"plane1"}
    with pytest.raises(OSError, match="truncated"):
        list(torch_batch.run_batch(list(planes), load, TCFG, device=CPU,
                                   batch_size=2, on_error="raise"))


def test_run_batch_empty_cell_vals_matches_jax():
    plane = synthetic_label_plane(
        seed=3, cell_types={1: "Particle", 2: "Background"}, shape=(64, 64),
        n_cells_per_strain=0, n_clusters_per_strain=0,
    )
    kw = dict(batch_size=1, particle_val=1, cell_vals=())
    want = dict(jax_batch.run_batch(["p"], lambda k: plane, CFG, **kw))
    got = dict(torch_batch.run_batch(["p"], lambda k: plane, TCFG, device=CPU, **kw))
    _assert_stats_equal(got, want)
    assert got["p"].cell_px == 0 and got["p"].particle_px > 0


def test_loader_pads_short_batch_and_keeps_paths():
    planes = {f"p{i}": np.full((8, 8), i, np.uint8) for i in range(5)}
    batches = list(batched_device_iterator(
        planes.__getitem__, list(planes), batch_size=2, devices=[CPU], with_paths=True,
    ))
    assert [(c, paths) for _, c, paths in batches] == [
        (2, ("p0", "p1")), (2, ("p2", "p3")), (1, ("p4",))
    ]
    (last,) = batches[-1][0]
    assert last.shape == (2, 8, 8) and last.device == CPU
    assert (last == 4).all()  # the short batch repeats its last plane
    with pytest.raises(ValueError, match="with_paths"):
        next(batched_device_iterator(planes.__getitem__, list(planes), 2, devices=[CPU],
                                     on_error="skip"))


def test_derive_class_values_matches_jax():
    tree = {
        "/data/run/acq1": ["3D05_C3M10_scan.h5"],
        "/data/3D05_6B07/acq2": ["scan_RFP_x.h5", "scan_DAPI_x.h5"],
        "/data/misc": ["plain.h5", "other.h5"],
    }
    assert torch_batch.derive_class_values(tree) == jax_batch.derive_class_values(tree)


def _h5_tree(root):
    """Single-file, multi-channel and token-free folders, 64×64 planes."""
    layout = {
        "run/acq1": [("3D05_C3M10_scan.h5",
                      {1: "3D05", 2: "C3M10", 3: "Particle", 4: "Background"})],
        "3D05_6B07/acq2": [(f"scan_{ch}_{i}.h5",
                            {1: "3D05", 2: "Particle", 3: "Background"})
                           for i, ch in enumerate(["RFP", "DAPI", "RFP"])],
        "misc": [("plain.h5", None)],
    }
    seed = 50
    for folder, files in layout.items():
        (root / folder).mkdir(parents=True)
        for name, cell_types in files:
            img = synthetic_label_plane(seed=seed, shape=(64, 64),
                                        cell_types=cell_types)
            seed += 1
            with h5py.File(root / folder / name, "w") as f:
                f.create_dataset("exported_data", data=img[None])


@pytest.mark.parametrize("max_regions", ["1023", "8"])
def test_cli_batch_csv_byte_identical_to_jax(tmp_path, capsys, max_regions):
    exp = tmp_path / "exp"
    _h5_tree(exp)
    args = ["batch", str(exp), "--batch-size", "2", "--max-regions", max_regions]
    jax_csv, torch_csv = tmp_path / "jax.csv", tmp_path / "torch.csv"
    assert jax_cli(args + ["--csv", str(jax_csv)]) == 0
    jax_out = capsys.readouterr().out
    manifest = str(tmp_path / "m.jsonl")
    port_args = args + ["--csv", str(torch_csv), "--device", "cpu",
                        "--manifest", manifest]
    assert torch_cli(port_args) == 0
    assert capsys.readouterr().out == jax_out
    assert torch_csv.read_bytes() == jax_csv.read_bytes()
    status = b",ok" if max_regions == "1023" else b",overflow"
    assert jax_csv.read_bytes().count(status) == 5
    # a manifest resume neither repeats nor loses rows
    assert torch_cli(port_args) == 0
    assert torch_csv.read_bytes() == jax_csv.read_bytes()


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    plane = synthetic_label_plane(seed=1, shape=(32, 32))
    with pytest.raises(RuntimeError):
        list(torch_batch.run_batch(["p"], lambda k: plane, TCFG,
                                   device=torch.device("cuda"), batch_size=1))
    _h5_tree(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli(["batch", str(tmp_path / "exp"), "--device", "cuda"])


def test_entry_points_default_to_the_card(monkeypatch):
    """run_batch, run_analysis and refine_boundaries(_stack) run on ``cuda``
    unless the caller asks for the CPU; analyze_plane sends a NumPy plane
    there when it is given no device.  The space axis's entry points take a
    mesh, which defaults to the cards, and a mesh's bands go to its devices."""
    import inspect

    from particle_col_image_segmentation_tpu_torch.models import experiment, refine, single_channel
    from particle_col_image_segmentation_tpu_torch.parallel import make_mesh, sharded

    for fn in (torch_batch.run_batch, experiment.run_analysis, refine.refine_boundaries,
               refine.refine_boundaries_stack):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_mesh(n_data=1, n_space=4).flat == tuple(torch.device("cuda", i) for i in range(4))
    monkeypatch.undo()
    bands = sharded.split_bands(np.zeros((2, 8, 3), np.uint8),
                                make_mesh(n_data=2, n_space=2, devices=["cpu"] * 4))
    assert [tuple(b.shape) for b in bands] == [(1, 4, 3)] * 4
    plane = synthetic_label_plane(seed=1, shape=(64, 64))
    assert single_channel.as_plane(torch.from_numpy(plane)).device.type == "cpu"
    assert single_channel.as_plane(plane, "cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert single_channel.as_plane(plane).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            single_channel.as_plane(plane)
    # the bench, as the verb and as its own module, runs on the card unless
    # asked for the CPU; its launch counts read the package's table: K1-K12,
    # the blur kernel and the plateau maxima pair
    from particle_col_image_segmentation_tpu_torch import _kernels, bench, cli

    asked = []
    monkeypatch.setattr(cli, "_device", torch.device)
    monkeypatch.setattr(bench, "run", lambda dev: asked.append(dev) or {})
    assert torch_cli(["bench"]) == 0 and bench.main([]) == 0
    assert torch_cli(["bench", "--device", "cpu"]) == 0
    assert asked == [torch.device("cuda")] * 2 + [torch.device("cpu")]
    assert list(_kernels.launch_counter_table()) == [f"K{i}" for i in range(1, 13)] + [
        "blur", "maxima"]


@pytest.mark.parametrize("verb", ["analyze", "batch", "refine", "bench"])
def test_cli_without_device_asks_for_cuda(tmp_path, verb):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _h5_tree(tmp_path / "exp")
    target = str(tmp_path / ("exp" if verb != "refine" else "missing.h5"))
    with pytest.raises(RuntimeError, match="--device cuda: CUDA is not available"):
        torch_cli([verb] if verb == "bench" else [verb, target])


def test_port_imports_no_jax():
    """Import every module of the port, run the fused pass on the CPU, and
    check that neither jax nor the JAX package was ever loaded (a fresh
    interpreter, not this one)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np, torch\n"
        "import particle_col_image_segmentation_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    if not m.name.endswith('.__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from particle_col_image_segmentation_tpu_torch.models.batch import fused_segment_batch\n"
        "imgs = np.random.default_rng(0).integers(0, 4, (2, 40, 48)).astype(np.uint8)\n"
        "out = fused_segment_batch(torch.from_numpy(imgs), port.AnalysisConfig(max_regions=4096))\n"
        "assert bool(out[-1].all()) and int(out[1].min()) > 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'particle_col_image_segmentation_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
