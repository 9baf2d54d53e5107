"""Parity: the PyTorch port's refine path (``pcis refine``) against the JAX
package on the CPU, and the guards that keep the port apart from it.

Inputs are made with numpy from a seed and handed to both packages.
Integers (labels, markers, counts, tables, EDT², flags) are compared
exactly; the float32 distance map too (``jnp.sqrt`` and the port's
``sqrt_f32`` both give the correctly rounded float32 root, so any difference
is a failure).  Nearest-neighbour distances are
compared exactly too: the port rounds each d² as XLA's fused multiply-add
does (``ops.rounding.fma_f32``) and takes the correctly rounded root, so
they equal the JAX package's float32 bit patterns
(``tests/test_torch_rounding.py`` holds the rule).  The CSVs round those
distances to 3 decimals and must match byte for byte.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu import config as jax_config
from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.models import refine as jax_refine
from particle_col_image_segmentation_tpu.ops.edt import (
    edt_exact as jax_edt_exact,
    edt_sq_exact as jax_edt_sq_exact,
    edt_sq_exact_auto as jax_edt_sq_exact_auto,
)
from particle_col_image_segmentation_tpu.ops import pairwise as jax_pairwise
from particle_col_image_segmentation_tpu.report import csvio as jax_csvio
from particle_col_image_segmentation_tpu_torch import config as port_config
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import config_from_fields
from particle_col_image_segmentation_tpu_torch.models import refine as torch_refine
from particle_col_image_segmentation_tpu_torch.ops import pairwise
from particle_col_image_segmentation_tpu_torch.ops.edt import edt_exact, edt_sq_exact, sqrt_f32
from particle_col_image_segmentation_tpu_torch.ops.edt_tiles import edt_sq_exact_auto
from particle_col_image_segmentation_tpu_torch.report import csvio as port_csvio

from test_torch_watershed import bench_relief

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "particle_col_image_segmentation_tpu_torch"
JCFG = jax_config.RefineConfig()
TCFG = config_from_fields(JCFG)
CPU = torch.device("cpu")


def cells(seed: int) -> np.ndarray:
    """A 128² relief with 13 (seed 0) or 27 (seed 1) cells: the bench relief
    with smaller, denser touching pairs."""
    return bench_relief(128, pairs=14, seed=seed, margin=12, r2_range=(30, 90))


# ---- exact EDT ----


def _edt_cases():
    rng = np.random.default_rng(11)
    shallow = rng.random((2, 40, 56)) < 0.15  # every distance small
    deep = np.zeros((2, 40, 56), bool)  # distances past probe_cap 2
    deep[0, 3, 5] = deep[0, 30, 50] = True
    deep[1, :, :2] = True
    empty = np.zeros((1, 24, 40), bool)
    full = np.ones((1, 24, 40), bool)
    rows = np.zeros((1, 50, 20), bool)  # featureless rows, H > W
    rows[0, 1, 4] = rows[0, 47, 15] = True
    return {"shallow": shallow, "deep": deep, "empty": empty, "full": full, "rows": rows}


@pytest.mark.parametrize("name", list(_edt_cases()))
def test_edt_sq_exact_and_auto_match_jax(name):
    f = _edt_cases()[name]
    want = np.asarray(jax_edt_sq_exact(jnp.asarray(f)))
    got = edt_sq_exact(torch.from_numpy(f))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for probe_cap in (2, 32):
        auto = edt_sq_exact_auto(torch.from_numpy(f), probe_cap=probe_cap)
        jauto = jax_edt_sq_exact_auto(jnp.asarray(f), probe_cap=probe_cap)
        np.testing.assert_array_equal(auto.numpy(), np.asarray(jauto))
        np.testing.assert_array_equal(auto.numpy(), want)
    np.testing.assert_array_equal(edt_exact(torch.from_numpy(f)).numpy(),
                                  np.asarray(jax_edt_exact(jnp.asarray(f))))


def _sqrt_cases():
    rng = np.random.default_rng(17)
    return {
        "every d2 below 2^20": np.arange(2**20, dtype=np.int32),
        "seeded d2 in [2^24, 2^31)": rng.integers(2**24, 2**31, 200_000).astype(np.int32),
        # roots that a float32 square root which is not correctly rounded misses
        "d2 19 and 37": np.array([19, 37], np.int32),
    }


@pytest.mark.parametrize("name", list(_sqrt_cases()))
def test_sqrt_f32_rounds_as_numpy_and_jax(name):
    """sqrt_f32 is the correctly rounded float32 root of float32(d²): numpy's
    and jnp.sqrt's, bit for bit (tolerance 0)."""
    d2 = _sqrt_cases()[name]
    got = sqrt_f32(torch.from_numpy(d2))
    assert got.dtype == torch.float32
    want = np.sqrt(d2.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.sqrt(jnp.asarray(d2).astype(jnp.float32))))


# ---- the device graph and the host results ----


@pytest.mark.parametrize("edt_cap", [None, 9], ids=["exact-edt", "capped-edt"])
def test_refine_plane_device_matches_jax(edt_cap):
    stack = np.stack([cells(0), cells(1)])
    jcfg = dataclasses.replace(JCFG, edt_cap=edt_cap)
    got = torch_refine.refine_plane_device(torch.from_numpy(stack), config_from_fields(jcfg), 4095)
    want = jax_refine.refine_plane_device(jnp.asarray(stack), jcfg, 4095)
    labels, markers, num, table, distance, converged = got
    assert labels.dtype == markers.dtype == torch.int32 and labels.shape == stack.shape
    for g, w in ((labels, want[0]), (markers, want[1]), (num, want[2]), (converged, want[5])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in table._fields:
        np.testing.assert_array_equal(getattr(table, name).numpy(),
                                      np.asarray(getattr(want[3], name)), name)
    np.testing.assert_array_equal(distance.numpy(), np.asarray(want[4]))
    assert converged.all() and num.tolist() == [13, 27]


def _assert_results_equal(got, want):
    assert got.num_cells == want.num_cells
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.areas, want.areas)
    np.testing.assert_array_equal(got.centroids, want.centroids)
    assert got.nn_distances.dtype == want.nn_distances.dtype == np.float32
    np.testing.assert_array_equal(got.nn_distances.view(np.int32),
                                  want.nn_distances.view(np.int32))


def test_refine_boundaries_and_csv_match_jax(tmp_path):
    probs = np.stack([np.zeros_like(cells(0))] * 3 + [cells(0)])  # [C, H, W], channel 3
    got = torch_refine.refine_boundaries(probs, TCFG, device=CPU)
    want = jax_refine.refine_boundaries(probs, JCFG)
    _assert_results_equal(got, want)
    assert got.num_cells == 13
    torch_refine.write_refine_csv(got, tmp_path / "torch.csv")
    jax_refine.write_refine_csv(want, tmp_path / "jax.csv")
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_refine_boundaries_stack_and_csv_match_jax(tmp_path):
    # the third plane has no object: one plateau-wide marker that floods nothing
    stack = np.stack([cells(0), cells(1), np.ones((128, 128), np.float32)])
    probs = np.repeat(stack[..., None], 4, axis=-1)  # [Z, H, W, C]
    got = torch_refine.refine_boundaries_stack(probs, TCFG, device=CPU)
    want = jax_refine.refine_boundaries_stack(probs, JCFG)
    assert [r.num_cells for r in got] == [13, 27, 1] and got[2].areas.tolist() == [0]
    for g, w in zip(got, want):
        _assert_results_equal(g, w)
    for z, r in enumerate(got):  # each plane equals its single-plane run
        one = torch_refine.refine_boundaries(stack[z], TCFG, device=CPU)
        np.testing.assert_array_equal(one.labels, r.labels)
    torch_refine.write_refine_stack_csv(got, tmp_path / "torch.csv")
    jax_refine.write_refine_stack_csv(want, tmp_path / "jax.csv")
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    with pytest.raises(ValueError, match="single \\[H, W, C\\] plane"):
        torch_refine.refine_boundaries_stack(probs[0], TCFG, device=CPU)


def test_refine_raises_on_unconverged_and_tunnel_basins():
    tight = dataclasses.replace(TCFG, watershed_max_iters=1)
    with pytest.raises(RuntimeError, match="did not converge"):
        torch_refine.refine_boundaries(cells(0), tight, device=CPU)
    with pytest.raises(RuntimeError, match="plane\\(s\\) \\[0, 1\\]"):
        torch_refine.refine_boundaries_stack(np.stack([cells(0), cells(1)]), tight, device=CPU)
    tight_tunnel = dataclasses.replace(tight, tunnel_basins=True)
    with pytest.raises(RuntimeError, match="did not converge"):
        torch_refine.refine_boundaries(cells(0), tight_tunnel, device=CPU)
    with pytest.raises(ValueError, match="cells > max_regions=4"):
        torch_refine.refine_boundaries(cells(0), TCFG, max_regions=4, device=CPU)


def tunnel_stack() -> np.ndarray:
    """cells(0), cells(1) and cells(0) at 16 levels (plateaus, where basins
    tunnel)."""
    return np.stack([cells(0), cells(1), (np.round(cells(0) * 15.0) / 15.0).astype(np.float32)])


def test_refine_tunnel_basins_matches_jax():
    """refine_plane_device, refine_boundaries and refine_boundaries_stack
    with ``tunnel_basins=True`` against the JAX package: labels, markers,
    counts, tables, flags, areas and centroids exact."""
    jcfg = dataclasses.replace(JCFG, tunnel_basins=True)
    tcfg = config_from_fields(jcfg)
    stack = tunnel_stack()
    got = torch_refine.refine_plane_device(torch.from_numpy(stack), tcfg, 4095)
    want = jax_refine.refine_plane_device(jnp.asarray(stack), jcfg, 4095)
    for g, w in zip(got[:3] + got[5:], want[:3] + want[5:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in got[3]._fields:
        np.testing.assert_array_equal(getattr(got[3], name).numpy(),
                                      np.asarray(getattr(want[3], name)), name)
    assert got[5].all()
    for g, w in zip(torch_refine.refine_boundaries_stack(stack, tcfg, device=CPU),
                    jax_refine.refine_boundaries_stack(stack, jcfg)):
        _assert_results_equal(g, w)
    one = torch_refine.refine_boundaries(stack[2], tcfg, device=CPU)
    _assert_results_equal(one, jax_refine.refine_boundaries(stack[2], jcfg))
    np.testing.assert_array_equal(one.labels, got[0][2].numpy())


def test_pairwise_and_cross_strain_distances_match_jax():
    rng = np.random.default_rng(5)
    # nearby points at coordinates near 2000: the difference form keeps them
    a = (2000 + rng.random((37, 2)) * 3).astype(np.float32)
    b = (2000 + rng.random((1100, 2)) * 40).astype(np.float32)
    valid = rng.random(1100) < 0.9
    got = pairwise.min_dist_to_set(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(valid))
    want = jax_pairwise.min_dist_to_set(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    nn = pairwise.nearest_neighbor_dists(torch.from_numpy(b), torch.from_numpy(valid))
    jnn = jax_pairwise.nearest_neighbor_dists(jnp.asarray(b), jnp.asarray(valid))
    np.testing.assert_array_equal(nn.numpy().view(np.int32), np.asarray(jnn).view(np.int32))
    cross = torch_refine.cross_strain_distances(a, b[:50], device=CPU)
    jcross = jax_refine.cross_strain_distances(a, b[:50])
    for k in ("a_to_b", "b_to_a"):
        np.testing.assert_array_equal(cross[k].view(np.int32), jcross[k].view(np.int32))
    empty = pairwise.min_dist_to_set(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.zeros(1100, dtype=torch.bool))
    assert torch.isinf(empty).all()


# ---- the CLI verb ----


def _h5(path, arr):
    with h5py.File(path, "w") as f:
        f.create_dataset("exported_data", data=arr)
    return str(path)


@pytest.mark.parametrize("layout", ["CHW", "ZHWC-stack", "CHW-tunnel", "ZHWC-stack-tunnel"])
def test_refine_cli_matches_jax_cli(tmp_path, capsys, layout):
    if layout.startswith("CHW"):
        arr = np.stack([np.zeros((128, 128), np.float32)] * 3 + [cells(1)])
        flags = []
    else:
        planes = tunnel_stack() if layout.endswith("tunnel") else np.stack([cells(0), cells(1)])
        arr = planes[..., None].repeat(4, axis=-1)
        flags = ["--stack"]
    if layout.endswith("tunnel"):
        flags.append("--tunnel-basins")
    src = _h5(tmp_path / "probs.h5", arr)
    jcsv, tcsv = tmp_path / "jax.csv", tmp_path / "torch.csv"
    assert jax_cli(["refine", src, "--csv", str(jcsv), "--out", str(tmp_path / "jax.h5"), *flags]) == 0
    jax_first = capsys.readouterr().out.splitlines()[0]
    assert torch_cli(["refine", src, "--device", "cpu", "--csv", str(tcsv),
                      "--out", str(tmp_path / "torch.h5"), *flags]) == 0
    assert capsys.readouterr().out.splitlines()[0] == jax_first
    assert tcsv.read_bytes() == jcsv.read_bytes()
    with h5py.File(tmp_path / "jax.h5") as fj, h5py.File(tmp_path / "torch.h5") as ft:
        np.testing.assert_array_equal(ft["exported_data"][()], fj["exported_data"][()])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_cli(["refine", src, "--device", "cuda", *flags])


# ---- the port keeps its own host code ----


def _imported_modules(tree):
    """Every module an AST imports, lazy imports and import_module("...")
    calls with a literal name included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            yield node.args[0].value


def test_port_sources_never_import_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    assert PORT / "io" / "native" / "__init__.py" in files
    assert {PORT / "oracle" / "ndimage.py", PORT / "utils" / "metrics.py"} <= set(files)
    # the benchmark module and the launch-counter table (``_kernels.py``)
    assert {PORT / "bench.py", PORT / "_kernels.py"} <= set(files)
    bad = []
    for path in files:
        for mod in _imported_modules(ast.parse(path.read_text(), str(path))):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "particle_col_image_segmentation_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert bad == []


def test_copied_constants_and_defaults_equal_the_jax_package(tmp_path):
    for name in ("CMAP", "BASE_TYPE_MAP", "CELL_TYPES", "CHANNELS", "CHANNEL_MAP", "STRAIN_MAP",
                 "CAPTURE_CHANNELS"):
        assert getattr(port_config, name) == getattr(jax_config, name), name
    for cls in ("AnalysisConfig", "RefineConfig", "NanoSIMSConfig"):
        ours = {f.name: f.default for f in dataclasses.fields(getattr(port_config, cls))}
        theirs = {f.name: f.default for f in dataclasses.fields(getattr(jax_config, cls))}
        assert ours == theirs, cls
    assert port_config.DEFAULT_CONFIG == config_from_fields(jax_config.DEFAULT_CONFIG)
    # CSV headers (and the empty files) of every copied writer
    writers = [
        (lambda m, p: m.write_cell_position_info({}, {}, p, 1.0)),
        (lambda m, p: m.write_merged_cell_position_info({}, p, 1.0)),
        (lambda m, p: m.write_density_info(p, "f", {}, {}, {})),
    ]
    for i, write in enumerate(writers):
        write(port_csvio, str(tmp_path / f"port{i}.csv"))
        write(jax_csvio, str(tmp_path / f"jax{i}.csv"))
        assert (tmp_path / f"port{i}.csv").read_bytes() == (tmp_path / f"jax{i}.csv").read_bytes()
    empty = torch_refine.RefineResult(np.zeros((2, 2), np.int32), 0, np.zeros(0),
                                      np.zeros((0, 2)), np.zeros(0))
    for mod, tag in ((torch_refine, "port"), (jax_refine, "jax")):
        mod.write_refine_csv(empty, str(tmp_path / f"{tag}_r.csv"))
        mod.write_refine_stack_csv([empty], str(tmp_path / f"{tag}_s.csv"))
    for s in ("r", "s"):
        assert (tmp_path / f"port_{s}.csv").read_bytes() == (tmp_path / f"jax_{s}.csv").read_bytes()


def test_config_from_fields_carries_configs_across():
    a = jax_config.AnalysisConfig(max_regions=77, px_to_um=3.5)
    ours = config_from_fields(a)
    assert type(ours) is port_config.AnalysisConfig
    assert dataclasses.asdict(ours) == dataclasses.asdict(a)
    r = jax_config.RefineConfig(boundary_threshold=0.25, edt_cap=9)
    assert type(config_from_fields(r)) is port_config.RefineConfig
    assert dataclasses.asdict(config_from_fields(r)) == dataclasses.asdict(r)
    assert dataclasses.asdict(jax_config.RefineConfig(**dataclasses.asdict(TCFG))) == \
        dataclasses.asdict(JCFG)
    with pytest.raises(TypeError, match="neither"):
        config_from_fields(object())


def test_refine_modules_import_neither_jax_nor_the_jax_package():
    """Import the refine slice in a fresh interpreter, refine a plane on the
    CPU, and check that neither jax nor the JAX package was loaded."""
    modules = [
        "config", "ops.scans", "ops.edt", "ops.edt_tiles", "ops.morphology",
        "ops.regionprops", "ops.regionprops_tiles", "ops.watershed",
        "ops.watershed_tiles", "ops.pairwise", "parallel", "parallel.mesh", "models.refine",
        "io.hdf5", "cli",
        "oracle", "oracle.ndimage", "utils.metrics",
    ]
    code = (
        "import importlib, sys\n"
        "import numpy as np, torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('particle_col_image_segmentation_tpu_torch.' + m)\n"
        "from particle_col_image_segmentation_tpu_torch import RefineConfig\n"
        "from particle_col_image_segmentation_tpu_torch.models.refine import refine_boundaries\n"
        "yy, xx = np.mgrid[:40, :48]\n"
        "prob = np.where((yy - 20) ** 2 + (xx - 24) ** 2 < 90, 0.0, 1.0).astype(np.float32)\n"
        "for tunnel in (False, True):\n"
        "    res = refine_boundaries(prob, RefineConfig(tunnel_basins=tunnel), device='cpu')\n"
        "    assert res.num_cells == 1, res.num_cells\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'particle_col_image_segmentation_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
