"""The port's benchmark module against the root bench.py.

bench.py is read (its record's keys, with ``ast``) and its input recipes are
run up to the first JAX call (``jnp.asarray`` or ``refine_boundaries``
patched to stop there), never its measurements.  The CPU fallback of the
``bench`` verb runs once, in a fresh interpreter.
"""

import ast
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as jax_bench
import chip_smoke
from particle_col_image_segmentation_tpu.models import refine as jax_refine
from particle_col_image_segmentation_tpu.oracle import ndimage as jax_ond
from particle_col_image_segmentation_tpu.utils.metrics import boundary_iou as jax_boundary_iou
from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch import bench
from particle_col_image_segmentation_tpu_torch import ops
from particle_col_image_segmentation_tpu_torch.ops import watershed_tiles

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "particle_col_image_segmentation_tpu_torch"
ADDED_KEYS = ["device", "power_limit", "launches"]


def _dict_literal_keys(path: pathlib.Path, func: str) -> dict:
    """{name: keys} of every dict literal assigned to a plain name in
    ``func`` of the module at ``path``."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    return {node.targets[0].id: [k.value for k in node.value.keys]
            for node in ast.walk(fn)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
            and isinstance(node.targets[0], ast.Name)}


def test_record_keys_are_bench_py_keys():
    theirs = _dict_literal_keys(REPO / "bench.py", "main")
    ours = _dict_literal_keys(PORT / "bench.py", "run")
    assert len(theirs["record"]) == 11 and len(theirs["configs"]) == 13
    assert ours["record"] == theirs["record"] + ADDED_KEYS
    assert ours["configs"] == theirs["configs"]
    # the smoke's phase 18 reads the same keys
    assert chip_smoke.bench_py_keys() == (theirs["record"], theirs["configs"])


class _Stop(Exception):
    pass


def _stop_at_asarray(monkeypatch, call: int) -> list:
    """Patch ``jnp.asarray`` to record what bench.py hands JAX (as NumPy
    arrays, after JAX's own conversion) and stop bench.py at call ``call``."""
    real = jnp.asarray
    seen = []

    def fake(a, *args, **kw):
        seen.append(np.asarray(real(a, *args, **kw)))
        if len(seen) == call:
            raise _Stop
        return seen[-1]

    monkeypatch.setattr(jnp, "asarray", fake)
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_make_plane_is_bench_py_plane(seed):
    np.testing.assert_array_equal(bench.make_plane(seed), jax_bench.make_plane(seed))


def test_cpu_otsu_is_bench_py_otsu():
    img = bench.config1_plane(128)
    assert bench._cpu_otsu(img) == jax_bench._cpu_otsu(img)
    assert bench._cpu_otsu(img.astype(np.float32) / 3) == jax_bench._cpu_otsu(
        img.astype(np.float32) / 3)


@pytest.mark.parametrize("fallback", [False, True])
def test_config1_plane_is_bench_py_plane(monkeypatch, fallback):
    monkeypatch.setattr(jax_bench, "FALLBACK", fallback)
    seen = _stop_at_asarray(monkeypatch, 1)
    with pytest.raises(_Stop):
        jax_bench.bench_config1()
    sizes = bench.FALLBACK if fallback else bench.FULL
    assert seen[0].dtype == np.uint16 and seen[0].shape == (sizes.c1,) * 2
    np.testing.assert_array_equal(bench.config1_plane(sizes.c1), seen[0])


@pytest.mark.parametrize("fallback", [False, True])
def test_config2_stacks_are_bench_py_stacks(monkeypatch, tmp_path, fallback):
    from PIL import Image

    monkeypatch.setattr(jax_bench, "FALLBACK", fallback)
    _stop_at_asarray(monkeypatch, 1)  # the warm-up call, after the TIFFs are written
    with pytest.raises(_Stop):
        jax_bench.bench_config2(str(tmp_path))
    sizes = bench.FALLBACK if fallback else bench.FULL
    ours = bench.config2_stacks(*sizes.zstack)
    assert len(ours) == sizes.zstack[2]
    for s, stack in enumerate(ours):
        with Image.open(tmp_path / f"stack{s}_zstack.tif") as im:
            pages = []
            for i in range(im.n_frames):
                im.seek(i)
                pages.append(np.asarray(im))
        np.testing.assert_array_equal(stack, np.stack(pages))


@pytest.mark.parametrize("fallback", [False, True])
def test_relief_is_bench_py_relief(monkeypatch, fallback):
    seen = []

    def stop(prob, *args, **kw):
        seen.append(prob)
        raise _Stop

    monkeypatch.setattr(jax_bench, "FALLBACK", fallback)
    monkeypatch.setattr(jax_refine, "refine_boundaries", stop)
    with pytest.raises(_Stop):
        jax_bench.watershed_boundary_iou()
    sizes = bench.FALLBACK if fallback else bench.FULL
    assert seen[0].dtype == np.float32 and seen[0].shape == (sizes.relief,) * 2
    np.testing.assert_array_equal(bench.relief(sizes.relief), seen[0])


def test_config4_inputs_are_bench_py_inputs(monkeypatch):
    seen = _stop_at_asarray(monkeypatch, 2)  # isotopes, then labels
    with pytest.raises(_Stop):
        jax_bench.bench_config4()
    labels, n_rois, iso = bench.config4_inputs()
    assert n_rois == 121 and int(labels.max()) == 121
    assert iso.dtype == seen[0].dtype == np.float32
    np.testing.assert_array_equal(iso, seen[0])
    np.testing.assert_array_equal(labels, seen[1])


def _jax_oracle_iou(p: np.ndarray, labels: np.ndarray) -> float:
    """bench.py's ``_oracle_iou`` with the JAX package's oracle and metric."""
    from scipy import ndimage as ndi

    binary = p < 0.5
    omark = jax_ond.label(jax_ond.local_maxima(ndi.distance_transform_edt(binary)).astype(np.uint8))
    return jax_boundary_iou(labels, jax_ond.watershed(p, omark, mask=binary))


def test_fallback_boundary_iou_equals_the_jax_packages():
    """The 128² fallback relief: the port's IoUs (its refine against its
    oracle) equal the JAX package's refine labels scored by the JAX
    package's oracle, smooth and at 16 levels, at tolerance 0."""
    prob = bench.relief(bench.FALLBACK.relief)
    want = [_jax_oracle_iou(p, jax_refine.refine_boundaries(p).labels)
            for p in (prob, bench.quantize16(prob))]
    iou, iou_q16, mps = bench.watershed_boundary_iou(torch.device("cpu"), bench.FALLBACK)
    assert [iou, iou_q16] == want
    assert 0.5 < min(want) and mps > 0


def test_bench_verb_on_the_cpu_prints_the_fallback_record():
    """``cli.main(["bench", "--device", "cpu"])`` in a fresh interpreter: one
    JSON line on stdout in bench.py's fallback shape, exact mask parity, no
    kernel launched, and no jax module loaded."""
    code = (
        "import sys\n"
        "from particle_col_image_segmentation_tpu_torch import cli\n"
        "rc = cli.main(['bench', '--device', 'cpu'])\n"
        "loaded = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'particle_col_image_segmentation_tpu'))\n"
        "print('LOADED', loaded, file=sys.stderr)\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stderr.strip().splitlines()[-1] == "LOADED []"
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    theirs = _dict_literal_keys(REPO / "bench.py", "main")
    assert sorted(rec) == sorted(theirs["record"] + ADDED_KEYS + ["fallback_smoke", "reason"])
    assert rec["value"] is rec["vs_baseline"] is rec["configs"] is None
    assert rec["platform"] == "cpu" and rec["mask_exact_parity"] is True
    assert rec["metric"] == "fused_segmentation_throughput" and rec["unit"] == "MP/s/chip"
    assert list(rec["fallback_smoke"]) == theirs["configs"]
    for k, v in rec["fallback_smoke"].items():
        assert isinstance(v, (int, float)) and math.isfinite(v), k
    assert rec["fallback_smoke"]["3_boundary_iou"] == rec["watershed_boundary_iou"]
    assert rec["launches"] == {**{f"K{i}": 0 for i in range(1, 13)}, "blur": 0, "maxima": 0}
    assert rec["cpu_live_mps"] > 0 and rec["platform_copy_gbps"] > 0


# the wrappers chip_smoke.py counted K1-K11 with before the table moved into
# the package, K12's, the blur kernel's and the plateau maxima pair's
SMOKE_TABLE = {
    "K1": [ops.median_label_filter_cuda, ops.median_label_filter_rows_padded_cuda],
    "K2": [ops.ccl_cuda],
    "K3": [ops.compact_labels_cuda],
    "K4": [ops.region_counts_cuda, ops.region_sums_cuda, ops.bin_histogram_cuda],
    "K5": [ops.region_table_cuda], "K6": [ops.table_lookup_cuda],
    "K7": [ops.centroid_sums_cuda], "K8": [ops.particle_fill_step_cuda],
    "K9": [ops.edt_sq_cuda], "K10": [watershed_tiles.watershed_cost_pass_cuda],
    "K11": [watershed_tiles.watershed_label_pass_cuda],
    "K12": [watershed_tiles.tunnel_init_cuda, watershed_tiles.claim_labels_tunnel_cuda],
    "blur": [ops.gaussian_blur_cuda],
    "maxima": [ops.plateau_maxima_cuda],
}


def test_launch_counter_table_lists_the_smokes_wrappers():
    table = _kernels.launch_counter_table()
    assert table == SMOKE_TABLE
    # every wrapper that counts a launch is in the table
    counted = set()
    for path in sorted((PORT / "ops").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "count_launch"):
                counted.add(node.args[0].id)
    assert counted == {fn.__name__ for fns in table.values() for fn in fns}
    # the smoke reads the package's table and keeps no copy
    assert not hasattr(chip_smoke, "launch_counters")
    reset_counts, read_counts = _kernels.launch_counters()
    saved = {fn: fn.launches for fns in table.values() for fn in fns}
    try:
        reset_counts()
        _kernels.count_launch(ops.region_counts_cuda)
        _kernels.count_launch(ops.region_sums_cuda)
        _kernels.count_launch(watershed_tiles.watershed_label_pass_cuda)
        assert read_counts() == {**{k: 0 for k in table}, "K4": 2, "K11": 1}
        reset_counts()
        assert set(read_counts().values()) == {0}
    finally:
        for fn, n in saved.items():
            fn.launches = n
