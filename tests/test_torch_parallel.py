"""Parity: the PyTorch port's data axis — ``parallel/mesh.py``,
``run_batch(mesh=…)``, ``refine_boundaries_sharded`` and the ``batch`` and
``refine`` verbs' ``--data-parallel`` / ``--space-parallel`` — against the
JAX package on the CPU, and the thread-safety of the kernel layer.

A mesh here names the CPU several times (``["cpu"] * n``): each mesh
position gets a worker thread of its own and runs the plain versions, as
the JAX suite's eight virtual CPU devices do.  Inputs are made with numpy
from a seed.  Stats, labels, counts, areas and centroids are integers or
come from integer sums, so the tolerance is exact equality; nearest-
neighbour distances are float32 bit patterns equal to JAX's, as in
``test_torch_refine.py`` (the port rounds them as XLA's fused multiply-add
does), and the CSVs, which round them, byte for byte.
"""

import ast
import ctypes
import dataclasses
import logging
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import types

import h5py
import numpy as np
import pytest
import torch

from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.models import batch as jax_batch
from particle_col_image_segmentation_tpu.models import refine as jax_refine
from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from particle_col_image_segmentation_tpu.utils.manifest import RunManifest
from particle_col_image_segmentation_tpu_torch import _kernels
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.config import config_from_fields
from particle_col_image_segmentation_tpu_torch.models import batch as torch_batch
from particle_col_image_segmentation_tpu_torch.models import refine as torch_refine
from particle_col_image_segmentation_tpu_torch.parallel import (
    DATA_AXIS,
    SPACE_AXIS,
    make_mesh,
    run_per_device,
)

from fixtures import synthetic_label_plane
from test_torch_batch import _assert_stats_equal, _h5_tree
from test_torch_refine import JCFG, TCFG, _assert_results_equal, cells, tunnel_stack

REPO = pathlib.Path(__file__).resolve().parent.parent
TILES = sorted((REPO / "particle_col_image_segmentation_tpu_torch" / "ops").glob("*_tiles.py"))
CFG = AnalysisConfig(max_regions=64)  # the speckle plane's 96 regions overflow it
TCFG_BATCH = config_from_fields(CFG)


def cpu_mesh(n_data, n_space=1):
    return make_mesh(n_data=n_data, n_space=n_space, devices=["cpu"] * (n_data * n_space))


# ---- make_mesh ----


@pytest.mark.parametrize("kw", [dict(n_space=16), dict(n_space=3), dict(n_data=4, n_space=4)],
                         ids=["empty", "drops-remainder", "oversubscribed"])
def test_make_mesh_rejects_degenerate_shapes_as_jax(kw):
    """The JAX suite's cases on its eight devices, and the same message."""
    with pytest.raises(ValueError) as want:
        jax_make_mesh(**kw)
    with pytest.raises(ValueError) as got:
        make_mesh(**kw, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)


def test_make_mesh_shape_subset_and_repeated_devices(caplog):
    logger = logging.getLogger("pcis")  # the port's loggers do not propagate
    logger.addHandler(caplog.handler)
    try:
        m = make_mesh(n_data=4, n_space=1, devices=["cpu"] * 8)  # explicit subset
    finally:
        logger.removeHandler(caplog.handler)
    assert "mesh 4×1 uses 4 of 8 devices" in caplog.text
    assert m.shape == {DATA_AXIS: 4, SPACE_AXIS: 1}
    assert m.shape == dict(jax_make_mesh(n_data=4, n_space=1).shape)
    assert m.flat == (torch.device("cpu"),) * 4
    m = make_mesh(n_data=2, n_space=3, devices=[f"cuda:{i % 2}" for i in range(6)])
    assert m.shape == {DATA_AXIS: 2, SPACE_AXIS: 3}
    assert m.devices[1] == (torch.device("cuda:1"), torch.device("cuda:0"), torch.device("cuda:1"))
    assert m.flat == tuple(torch.device(f"cuda:{i % 2}") for i in range(6))
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.devices = ()


def test_make_mesh_defaults_to_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = make_mesh()
    assert m.shape == {DATA_AXIS: 3, SPACE_AXIS: 1}
    assert m.flat == tuple(torch.device("cuda", i) for i in range(3))
    assert make_mesh(n_space=3).shape == {DATA_AXIS: 1, SPACE_AXIS: 3}
    with pytest.raises(ValueError, match="mesh 4×1 needs 4 devices, have 3"):
        make_mesh(n_data=4)  # a mesh larger than the visible cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        make_mesh()


# ---- the workers ----


def test_run_per_device_orders_results_and_reraises_naming_the_device():
    seen, fail = [], []

    def fn(i, x):
        seen.append(threading.current_thread().name)
        if i in fail:
            raise OSError(f"boom {x}")
        return i * x

    assert run_per_device(fn, ["cpu"] * 4, [(i, 10) for i in range(4)]) == [0, 10, 20, 30]
    assert len(set(seen)) == 4  # a thread a device
    seen.clear()
    assert run_per_device(fn, ["cpu"], [(1, 7)]) == [7]
    assert seen == [threading.current_thread().name]  # one device: the caller's thread
    fail[:] = [2, 3]
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    logging.getLogger("pcis.mesh").addHandler(handler)
    try:
        with pytest.raises(OSError, match="boom 10") as e:
            run_per_device(fn, ["cpu"] * 4, [(i, 10) for i in range(4)])
    finally:
        logging.getLogger("pcis.mesh").removeHandler(handler)
    # the device is named in the log on every Python, and as a note from 3.11
    assert logged == ["raised by the data-axis worker 2 on cpu: OSError('boom 10')"]
    assert e.value.__notes__ == ["raised by the data-axis worker 2 on cpu"]
    assert not [t for t in threading.enumerate() if t.name.startswith("pcis-data-")]
    with pytest.raises(ValueError, match="3 argument tuples for 2 devices"):
        run_per_device(fn, ["cpu"] * 2, [(0, 1)] * 3)


def test_count_launch_adds_up_under_threads():
    """Eight threads, a switch interval of 1 µs: every launch is counted."""
    def wrapper():
        pass

    wrapper.launches = 0
    n, per = 8, 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_kernels.count_launch(wrapper)
                                                    for _ in range(per)])
                   for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n * per


def test_kernel_library_builds_once_under_threads(monkeypatch, tmp_path):
    """Four threads ask for the kernel library at once, with nvcc, the
    linker and the loader faked (this host has no nvcc): one build, one
    load, one library for all."""
    popens, runs, loads = [], [], []

    class FakePopen:
        def __init__(self, cmd, **kw):
            popens.append(cmd)
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"obj")
            self.returncode = 0

        def communicate(self):
            threading.Event().wait(0.01)  # widen the window a second build would use
            return "ptxas info", None

    def fake_run(cmd, **kw):
        runs.append(cmd)
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            object.__setattr__(self, name, fn)
            return fn

    def fake_cdll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(_kernels.subprocess, "run", fake_run)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", fake_cdll)
    start = threading.Barrier(4)
    got = [None] * 4

    def ask(i):
        start.wait()
        got[i] = _kernels.library()

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(popens) == len(_kernels._sources()) and len(runs) == 1 and len(loads) == 1
    assert all(g is got[0] for g in got) and got[0].build_log.startswith("ptxas info")
    assert got[0].pcis_watershed_cost.argtypes == _kernels._SIGNATURES["pcis_watershed_cost"][1]
    assert [p.name for p in tmp_path.iterdir()] == [f"libpcis_kernels_{_kernels._digest()}.so"]
    assert _kernels.library() is got[0] and len(loads) == 1


def _launch_entry_points():
    """The C entry points that launch on a stream (the rest size scratch,
    report caps or name errors)."""
    return {name for name, (restype, argtypes) in _kernels._SIGNATURES.items()
            if restype is ctypes.c_int and argtypes}


def _launches_outside_device_guards(tree):
    """(launch sites, names launched, sites not inside ``with
    torch.cuda.device(...)``) of one module's AST."""
    sites, names, bad = 0, set(), []

    def guard(item):
        call = item.context_expr
        return (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and ast.unparse(call.func) == "torch.cuda.device")

    def visit(node, guarded):
        nonlocal sites
        if isinstance(node, ast.With) and any(guard(i) for i in node.items):
            guarded = True
        if isinstance(node, ast.Call):
            f = node.func
            by_name = (isinstance(f, ast.Attribute) and f.attr in _launch_entry_points())
            by_getattr = (isinstance(f, ast.Call) and isinstance(f.func, ast.Name)
                          and f.func.id == "getattr" and ast.unparse(f.args[0]) == "lib")
            if by_name or by_getattr:
                sites += 1
                if by_name:
                    names.add(f.attr)
                if not guarded:
                    bad.append(f"line {node.lineno}: {ast.unparse(f)}")
        if isinstance(node, ast.Constant) and node.value in _launch_entry_points():
            names.add(node.value)  # the name a getattr launch looks up
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(tree, False)
    return sites, names, bad


def test_every_kernel_launch_sits_inside_a_device_guard():
    """Each ``lib.pcis_*`` launch in ``ops/*_tiles.py`` runs under ``with
    torch.cuda.device(...)``: the kernels launch on the current device, so
    on a host with several cards a launch outside the guard would target
    cuda:0 with another card's pointers (a one-card machine cannot show it)."""
    total, launched = 0, set()
    for path in TILES:
        sites, names, bad = _launches_outside_device_guards(ast.parse(path.read_text()))
        assert bad == [], f"{path.name}: {bad}"
        total += sites
        launched |= names
    # K1-K11, K8 by two routes, K4's histogram, the blur, K12's two, the maxima pair
    assert total == 17
    assert launched == _launch_entry_points()
    # the walk catches a launch outside the guard
    sites, _, bad = _launches_outside_device_guards(ast.parse(
        "with torch.cuda.device(x.device):\n    lib.pcis_compact(1)\nlib.pcis_edt_sq(2)\n"
        "getattr(lib, fn)(3)\n"))
    assert sites == 3 and bad == ["line 3: lib.pcis_edt_sq", "line 4: getattr(lib, fn)"]


# ---- run_batch(mesh=…) ----


def _batch_planes():
    """Nine synthetic 64² planes, a speckle plane past max_regions (64) and a
    plane whose decode fails: in batches of 4 the last holds one real plane,
    so on 2 and 4 devices whole chunks are padding."""
    planes = {f"plane{i}": synthetic_label_plane(seed=40 + i, shape=(64, 64)) for i in range(9)}
    planes["speckle"] = np.random.default_rng(0).integers(1, 4, (64, 64)).astype(np.uint8)
    return planes


def _load_with_a_bad_file(planes):
    def load(key):
        if key == "bad":
            raise OSError("truncated file")
        return planes[key]
    return load


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_run_batch_on_a_mesh_matches_jax_and_the_single_device_run(tmp_path, n_data):
    planes = _batch_planes()
    paths = list(planes)[:4] + ["bad"] + list(planes)[4:]  # 11 paths, 10 decode
    load = _load_with_a_bad_file(planes)
    kw = dict(batch_size=4, particle_val=2, cell_vals=(1,))
    want = dict(jax_batch.run_batch(paths, load, CFG, mesh=jax_make_mesh(n_data=4), **kw))
    single = dict(torch_batch.run_batch(paths, load, TCFG_BATCH, device="cpu", **kw))
    manifest = RunManifest(str(tmp_path / "m.jsonl"))
    got = dict(torch_batch.run_batch(paths, load, TCFG_BATCH, mesh=cpu_mesh(n_data),
                                     manifest=manifest, **kw))
    assert list(got) == [p for p in paths if p != "bad"]  # plane order kept
    _assert_stats_equal(got, want)
    _assert_stats_equal(got, single)
    assert got["speckle"].overflow and got["speckle"].num_regions == 96
    assert sum(s.overflow for s in got.values()) == 1 and all(s.converged for s in got.values())
    # the resume retries the failed decode and the overflowed plane only
    assert {p for p in paths if manifest.is_done(p)} == set(planes) - {"speckle"}
    fixed = {**planes, "bad": planes["plane0"]}
    again = dict(torch_batch.run_batch(paths, fixed.__getitem__, TCFG_BATCH, mesh=cpu_mesh(n_data),
                                       manifest=manifest, **kw))
    assert list(again) == ["bad", "speckle"]
    assert manifest.is_done("bad") and not manifest.is_done("speckle")


def test_run_batch_mesh_errors():
    planes = _batch_planes()
    with pytest.raises(ValueError, match="batch_size 6 is not a multiple of the mesh's data axis \\(4\\)"):
        list(torch_batch.run_batch(list(planes), planes.__getitem__, TCFG_BATCH, batch_size=6,
                                   mesh=cpu_mesh(4)))
    with pytest.raises(ValueError, match="plane height 64 is not a multiple of the mesh's space axis \\(3\\)"):
        list(torch_batch.run_batch(list(planes), planes.__getitem__, TCFG_BATCH, batch_size=4,
                                   mesh=cpu_mesh(2, 3)))
    with pytest.raises(OSError, match="truncated"):
        list(torch_batch.run_batch(["plane0", "bad"], _load_with_a_bad_file(planes), TCFG_BATCH,
                                   batch_size=2, mesh=cpu_mesh(2), on_error="raise"))
    # a worker's failure reaches the caller, naming its device
    fn = torch_batch.make_fused_segment_fn(cpu_mesh(2), TCFG_BATCH)
    good = torch.from_numpy(planes["plane0"][None])
    with pytest.raises(Exception) as e:
        fn([good, good[0, 0]])
    assert e.value.__notes__ == ["raised by the data-axis worker 1 on cpu"]
    out = fn([good, good])
    assert len(out) == 2 and torch.equal(out[0][0], out[1][0])


def test_loader_splits_padded_batches_over_devices():
    from particle_col_image_segmentation_tpu_torch.io.loader import batched_device_iterator

    planes = {f"p{i}": np.full((8, 8), i, np.uint8) for i in range(5)}
    batches = list(batched_device_iterator(planes.__getitem__, list(planes), batch_size=4,
                                           devices=["cpu"] * 2, with_paths=True))
    assert [(c, paths) for _, c, paths in batches] == [(4, ("p0", "p1", "p2", "p3")), (1, ("p4",))]
    assert [[int(t[:, 0, 0].sum()) for t in chunks] for chunks, _, _ in batches] == [[1, 5], [8, 8]]
    assert all(t.shape == (2, 8, 8) for chunks, _, _ in batches for t in chunks)
    with pytest.raises(ValueError, match="does not split over 3 devices"):
        next(batched_device_iterator(planes.__getitem__, list(planes), 4, devices=["cpu"] * 3))


# ---- refine_boundaries_sharded ----


def test_refine_sharded_pads_z_and_matches_jax_stack():
    """Z = 3 on two devices (the last plane repeated, its result dropped),
    [Z, H, W, C] input; a capped EDT in the config does not apply here."""
    stack = np.stack([cells(0), cells(1), np.ones((128, 128), np.float32)])
    probs = np.repeat(stack[..., None], 4, axis=-1)
    want = jax_refine.refine_boundaries_stack(probs, JCFG)
    got = torch_refine.refine_boundaries_sharded(
        probs, dataclasses.replace(TCFG, edt_cap=9), mesh=cpu_mesh(2))
    assert [r.num_cells for r in got] == [13, 27, 1]
    for g, w in zip(got, want, strict=True):
        _assert_results_equal(g, w)


def test_refine_sharded_single_plane_matches_jax():
    probs = np.stack([np.zeros_like(cells(1))] * 3 + [cells(1)])  # [C, H, W], channel 3
    want = jax_refine.refine_boundaries(probs, JCFG)
    got = torch_refine.refine_boundaries_sharded(probs, TCFG, mesh=cpu_mesh(2), stack=False)
    assert len(got) == 1 and got[0].num_cells == 27
    _assert_results_equal(got[0], want)
    with pytest.raises(ValueError, match="single \\[H, W, C\\] plane"):
        torch_refine.refine_boundaries_sharded(probs.transpose(1, 2, 0), TCFG, mesh=cpu_mesh(2),
                                               stack=True)


def test_refine_sharded_tunnel_runs_data_parallel_and_matches_jax_stack():
    """tunnel_basins spreads the planes over every mesh device, the space
    axis included; without it the space axis runs the spatial refine, equal
    to JAX's refine of the stack without the tunnel."""
    jcfg = dataclasses.replace(JCFG, tunnel_basins=True)
    tcfg = config_from_fields(jcfg)
    stack = tunnel_stack()
    want = jax_refine.refine_boundaries_stack(stack, jcfg)
    for mesh in (cpu_mesh(1, 2), cpu_mesh(2, 2)):
        got = torch_refine.refine_boundaries_sharded(stack, tcfg, mesh=mesh, stack=True)
        for g, w in zip(got, want, strict=True):
            _assert_results_equal(g, w)
    untunnelled = torch_refine.refine_boundaries_sharded(stack, TCFG, mesh=cpu_mesh(1, 2),
                                                         stack=True)
    for g, w in zip(untunnelled, jax_refine.refine_boundaries_stack(stack, JCFG), strict=True):
        _assert_results_equal(g, w)
    tight = dataclasses.replace(TCFG, watershed_max_iters=1)
    with pytest.raises(RuntimeError, match="plane\\(s\\) \\[0, 1\\]"):
        torch_refine.refine_boundaries_sharded(stack[:2], tight, mesh=cpu_mesh(2), stack=True)


def test_check_tunnel_chunk_fits_as_jax(monkeypatch):
    """JAX's cases: a tiny device raises naming the alternatives, a small
    plane fits it; against the 16 GiB of a device that reports no memory a
    2048² plane fits and a 16-plane chunk of 16384² does not."""
    check = torch_refine._check_tunnel_chunk_fits
    check((2048, 2048), 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="exceeds one device"):
        check((16384, 16384), 16, torch.device("cpu"))
    monkeypatch.setattr(torch_refine, "_DEFAULT_DEVICE_BYTES", 1024**2)  # a 1 MiB device
    with pytest.raises(ValueError, match="tunnel_basins.*Alternatives"):
        check((512, 512), 1, torch.device("cpu"))
    check((64, 64), 1, torch.device("cpu"))
    # refine_boundaries_sharded checks before it dispatches
    with pytest.raises(ValueError, match="2 plane\\(s\\) of 128x128"):
        torch_refine.refine_boundaries_sharded(
            tunnel_stack(), dataclasses.replace(TCFG, tunnel_basins=True), mesh=cpu_mesh(2),
            stack=True)


# ---- the verbs ----


def _h5(path, arr):
    with h5py.File(path, "w") as f:
        f.create_dataset("exported_data", data=arr)
    return str(path)


def test_cli_batch_data_parallel_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """Each package on its own copy of the tree (the CSV names planes by
    path, so each runs from its copy's parent with the same relative path)."""
    _h5_tree(tmp_path / "jax" / "exp")
    shutil.copytree(tmp_path / "jax" / "exp", tmp_path / "torch" / "exp")
    args = ["batch", "exp", "--batch-size", "2", "--max-regions", "1023", "--data-parallel", "2"]
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_cli(args + ["--csv", "out.csv"]) == 0
    jax_out = capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "torch")
    assert torch_cli(args + ["--csv", "out.csv", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    got = (tmp_path / "torch" / "out.csv").read_bytes()
    assert got == (tmp_path / "jax" / "out.csv").read_bytes()
    assert got.count(b",ok") == 5
    # --data-parallel 1: the mesh path on one device writes the same file
    assert torch_cli(args[:-1] + ["1", "--csv", "one.csv", "--device", "cpu"]) == 0
    assert (tmp_path / "torch" / "one.csv").read_bytes() == got


@pytest.mark.parametrize("route", ["stack-data-parallel", "plane-space-parallel-tunnel"])
def test_cli_refine_mesh_matches_jax_cli(tmp_path, capsys, route):
    """``refine --stack --data-parallel 2`` against the JAX CLI's ``refine
    --stack``; ``refine --space-parallel 2 --tunnel-basins`` on one plane
    against the JAX CLI's ``refine --tunnel-basins`` (the JAX package's own
    sharded refine is not called: the data axis is held to its single-device
    results)."""
    if route.startswith("stack"):
        arr = np.stack([cells(0), cells(1), cells(0)[::-1]])[..., None].repeat(4, axis=-1)
        jax_flags, mesh_flags = ["--stack"], ["--data-parallel", "2"]
    else:
        arr = np.stack([np.zeros((128, 128), np.float32)] * 3
                       + [(np.round(cells(1) * 15.0) / 15.0).astype(np.float32)])
        jax_flags, mesh_flags = ["--tunnel-basins"], ["--space-parallel", "2"]
    src = _h5(tmp_path / "probs.h5", arr)
    assert jax_cli(["refine", src, "--csv", str(tmp_path / "jax.csv"),
                    "--out", str(tmp_path / "jax.h5"), *jax_flags]) == 0
    jax_out = capsys.readouterr().out.splitlines()[0]
    assert torch_cli(["refine", src, "--device", "cpu", "--csv", str(tmp_path / "torch.csv"),
                      "--out", str(tmp_path / "torch.h5"), *jax_flags, *mesh_flags]) == 0
    assert capsys.readouterr().out.splitlines()[0] == jax_out
    got = (tmp_path / "torch.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes() and got.count(b"\n") > 3
    with h5py.File(tmp_path / "jax.h5") as fj, h5py.File(tmp_path / "torch.h5") as ft:
        np.testing.assert_array_equal(ft["exported_data"][()], fj["exported_data"][()])


@pytest.mark.parametrize("argv,message", [
    (["analyze", "{tree}", "--space-parallel", "2", "--batch-planes", "2"],
     "--batch-planes batches whole planes per device and cannot combine with --space-parallel"),
    (["batch", "{tree}", "--batch-size", "3", "--data-parallel", "2"],
     "--batch-size must be a multiple of --data-parallel \\(got 3 and 2\\)"),
    (["refine", "{h5}", "--space-parallel", "2"], None),
    (["refine", "{h5}", "--space-parallel", "2", "--data-parallel", "2"], None),
    (["batch", "{tree}", "--pack-transfer"],
     "--pack-transfer is not supported: the PyTorch port drops the JAX package's relay"),
], ids=["analyze-space-batch-planes", "batch-size", "refine-space", "refine-space-and-data",
        "batch-pack-transfer"])
def test_cli_rejects_the_unported_spatial_path(tmp_path, capsys, argv, message):
    """The mesh flags' usage errors.  ``refine --space-parallel`` without
    ``--tunnel-basins`` was one of them until the spatial refine was ported:
    those cases (``message`` None) now run the verb, and its CSV equals the
    JAX CLI's ``refine``."""
    _h5_tree(tmp_path / "exp")
    h5 = _h5(tmp_path / "p.h5", cells(0))
    argv = [a.format(tree=tmp_path / "exp", h5=h5) for a in argv] + ["--device", "cpu"]
    if message is None:
        assert torch_cli(argv + ["--csv", str(tmp_path / "torch.csv")]) == 0
        assert jax_cli(["refine", h5, "--csv", str(tmp_path / "jax.csv")]) == 0
        got = (tmp_path / "torch.csv").read_bytes()
        assert got == (tmp_path / "jax.csv").read_bytes() and got.count(b"\n") > 3
        return
    with pytest.raises(SystemExit) as e:
        torch_cli(argv)
    assert e.value.code == 2
    assert re.search(message, capsys.readouterr().err)


def test_cli_mesh_follows_the_device(monkeypatch):
    from particle_col_image_segmentation_tpu_torch import cli

    assert cli._mesh(torch.device("cpu"), 2, 3).flat == (torch.device("cpu"),) * 6
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli._mesh(torch.device("cuda"), 2, 1).flat == (torch.device("cuda:0"),
                                                           torch.device("cuda:1"))
    assert cli._mesh(torch.device("cuda:1"), 3, 1).flat == tuple(
        torch.device("cuda", i) for i in (1, 2, 3))
    with pytest.raises(ValueError, match="mesh 2×2 needs 4 devices, have 3"):
        cli._mesh(torch.device("cuda:1"), 2, 2)
