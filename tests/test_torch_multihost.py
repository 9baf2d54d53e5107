"""Multi-process runs of the port: ``parallel.mesh.initialize_multihost`` on
``torch.distributed`` (gloo over 127.0.0.1), ``process_allgather``, and the
band-sharded segment of each process's mesh rows.

Two CPU processes name two devices each (``["cpu", "cpu"]``), which gives one
global 2×2 mesh: planes over the processes, rows over each process's two
positions.  Each runs ``make_sharded_segment_fn`` on the global batch and
gathers its rows' outputs; the gathered outputs must equal the JAX package's
``fused_segment_batch`` and its ``make_sharded_segment_fn`` on a
one-process 2×2 CPU mesh at tolerance 0.

This file is also the worker:
``python tests/test_torch_multihost.py <coordinator|-> <process id> <planes.npy> <out.npz> [n devices]``
imports only the port; ``-`` as the coordinator initializes from torchrun's
environment variables.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np

if __name__ != "__main__":  # the worker imports nothing of the tests or of JAX
    import pytest
    import torch

    from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
    from particle_col_image_segmentation_tpu_torch.models import batch as torch_batch
    from particle_col_image_segmentation_tpu_torch.models import experiment, refine
    from particle_col_image_segmentation_tpu_torch.parallel import mesh as mesh_mod
    from particle_col_image_segmentation_tpu_torch.parallel import sharded

    from fixtures import synthetic_label_plane

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SEEDS = (300, 301, 302, 303)  # JAX's worker's two planes, and two more
MAX_REGIONS = 1023
FIELDS = ("den", "lab", "particle_ct", "n_comp", "filled", "overlap_px", "converged",
          "seg", "area", "class_id")
TIMEOUT_S = 120


def _worker(coord: str, pid: str, npy: str, out: str, n_dev: int) -> None:
    from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
    from particle_col_image_segmentation_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        SPACE_AXIS,
        initialize_multihost,
        process_allgather,
    )
    from particle_col_image_segmentation_tpu_torch.parallel.sharded import (
        make_sharded_segment_fn,
    )

    devices = ["cpu"] * n_dev
    if coord == "-":
        mesh = initialize_multihost(devices=devices)
    else:
        mesh = initialize_multihost(coord, 2, int(pid), devices=devices, timeout=20)
    rank = torch.distributed.get_rank()
    assert torch.distributed.get_world_size() == 2
    assert mesh.shape == {DATA_AXIS: 2, SPACE_AXIS: 2}, mesh.shape
    assert mesh.processes == (0, 1) and mesh.local_rows() == (rank,), mesh
    batch = np.load(npy)
    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    res = {}
    for with_tables in (False, True):
        outs = make_sharded_segment_fn(mesh, cfg, with_tables=with_tables)(batch)
        assert all(o.shape[0] == len(batch) // 2 for o in outs), [o.shape for o in outs]
        for name, a in zip(FIELDS, process_allgather(outs, tiled=True)):
            res[f"{name}_{with_tables}"] = a
    np.savez(out, **res)
    print(f"MULTIHOST-PASS-{rank}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import torch  # noqa: F401 — after the path, as the port needs it

    _worker(*sys.argv[1:5], int(sys.argv[5]) if len(sys.argv) > 5 else 2)
    sys.exit(0)


# ---- the parent ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batch() -> np.ndarray:
    return np.stack([synthetic_label_plane(seed=s, shape=(64, 64)) for s in SEEDS])


def _run_pair(tmp_path, mode: str, n_devs=(2, 2), ranks=(0, 1)):
    """Start one worker a rank; returns [(returncode, output, npz path)]."""
    npy = str(tmp_path / "planes.npy")
    np.save(npy, _batch())
    port = _free_port()
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    base.pop("WORLD_SIZE", None)
    procs = []
    for pid in ranks:
        env = dict(base)
        coord = f"127.0.0.1:{port}"
        if mode == "torchrun":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(pid), LOCAL_RANK=str(pid))
            coord = "-"
        out = str(tmp_path / f"out{pid}.npz")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, coord, str(pid), npy, out, str(n_devs[pid])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
        ), out))
    results = []
    try:
        for p, out in procs:
            text, _ = p.communicate(timeout=TIMEOUT_S)
            results.append((p.returncode, text, out))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
    return results


_JAX_SHARDED = """
import sys, numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from particle_col_image_segmentation_tpu.config import AnalysisConfig
from particle_col_image_segmentation_tpu.parallel.mesh import make_mesh
from particle_col_image_segmentation_tpu.parallel.sharded import make_sharded_segment_fn
batch = np.load(sys.argv[1])
mesh = make_mesh(n_data=2, n_space=2)
res = {}
for wt in (False, True):
    outs = make_sharded_segment_fn(mesh, AnalysisConfig(max_regions=%d), with_tables=wt)(
        jnp.asarray(batch))
    res.update({f"{n}_{wt}": np.asarray(o) for n, o in zip(%r, outs)})
np.savez(sys.argv[2], **res)
""" % (MAX_REGIONS, FIELDS)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's ``make_sharded_segment_fn`` on a one-process 2×2 CPU mesh, in
    an interpreter of its own with the compilation cache off."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    npy, out = str(tmp / "planes.npy"), str(tmp / "jax.npz")
    np.save(npy, _batch())
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX_SHARDED, npy, out], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("mode", ["explicit", "torchrun"])
def test_two_processes_gather_the_sharded_segment_equal_to_jax(tmp_path, mode, jax_sharded):
    import jax.numpy as jnp

    from particle_col_image_segmentation_tpu.config import AnalysisConfig as JaxConfig
    from particle_col_image_segmentation_tpu.models.batch import fused_segment_batch

    results = _run_pair(tmp_path, mode)
    for pid, (rc, text, _) in enumerate(results):
        assert rc == 0 and f"MULTIHOST-PASS-{pid}" in text, text[-3000:]
    seg, num, areas, classes, particle_px, _, _, conv = (
        np.asarray(o) for o in fused_segment_batch(jnp.asarray(_batch()),
                                                   JaxConfig(max_regions=MAX_REGIONS)))
    one_device = {"seg": seg, "n_comp": num, "area": areas, "class_id": classes,
                  "particle_ct": particle_px, "converged": conv}
    for _, _, out in results:
        got = dict(np.load(out))
        assert sorted(got) == sorted(jax_sharded)
        for key, want in jax_sharded.items():
            assert got[key].shape == want.shape, key
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        for with_tables in (False, True):
            for name, want in one_device.items():
                if name in ("seg", "area", "class_id") and not with_tables:
                    continue
                g = got[f"{name}_{with_tables}"]
                if name == "class_id":  # empty slots: 0 here and in JAX's sharded step,
                    live = areas > 0    # INT32_MIN in its one-device pass
                    g, want = g[live], want[live]
                np.testing.assert_array_equal(g, want, err_msg=name)
        assert got["converged_True"].all()


def test_a_missing_peer_raises_within_the_timeout(tmp_path):
    """Rank 0 alone with ``num_processes=2``: the group does not form, and
    initialization raises (never a quiet one-process run) in seconds."""
    t0 = time.perf_counter()
    (rc, text, out), = _run_pair(tmp_path, "explicit", ranks=(0,))
    assert rc != 0 and "MULTIHOST-PASS" not in text, text[-3000:]
    assert not os.path.exists(out)
    assert time.perf_counter() - t0 < TIMEOUT_S


def test_unequal_device_counts_raise_in_every_process(tmp_path):
    results = _run_pair(tmp_path, "explicit", n_devs=(2, 1))
    for rc, text, _ in results:
        assert rc != 0 and "unequal device counts [2, 1]" in text, text[-3000:]


def test_one_process_without_arguments_or_environment_stays_local(monkeypatch):
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for args in ((), (None, 1, 0)):
        mesh = mesh_mod.initialize_multihost(*args, devices=["cpu", "cpu"])
        assert not torch.distributed.is_initialized()
        assert mesh.shape == {"data": 1, "space": 2} and mesh.processes == (0,)
        assert mesh.local() is mesh and mesh.local_rows() == (0,)
    # one process: process_allgather is JAX's (numpy, a new axis untiled)
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    for tiled in (False, True):
        for value in (x, np.int32(7)):
            got = mesh_mod.process_allgather(torch.from_numpy(np.asarray(value)), tiled=tiled)
            want = multihost_utils.process_allgather(jnp.asarray(value), tiled=tiled)
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, np.asarray(want))
            assert got.shape == np.asarray(want).shape
    pair = mesh_mod.process_allgather((torch.ones(2), None, {"a": x}), tiled=True)
    assert pair[1] is None and pair[2]["a"].shape == (3, 4)


def _two_process_mesh():
    return mesh_mod.Mesh((tuple(map(torch.device, ["cpu", "cpu"])),) * 2, processes=(0, 1))


@pytest.mark.parametrize("rank", [0, 1])
def test_a_process_runs_only_its_own_rows(monkeypatch, rank):
    """The same global mesh and batch in the process of each rank: it runs
    that rank's row alone and returns that row's planes, equal to those
    planes of the one-process 2×2 run."""
    monkeypatch.setattr(mesh_mod, "process_index", lambda: rank)
    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    mesh = _two_process_mesh()
    assert mesh.spans_processes and mesh.local_rows() == (rank,)
    assert mesh.local().devices == mesh.devices[rank:rank + 1]
    batch = _batch()
    each, calls = sharded._each, []
    monkeypatch.setattr(sharded, "_each", lambda fn, devs, args: (
        calls.append(len(devs)) or each(fn, devs, args)))
    got = sharded.make_sharded_segment_fn(mesh, cfg, with_tables=True)(batch)
    assert set(calls) == {2}  # one row's two positions
    monkeypatch.setattr(sharded, "_each", each)
    one = mesh_mod.make_mesh(n_data=2, n_space=2, devices=["cpu"] * 4)
    want = sharded.make_sharded_segment_fn(one, cfg, with_tables=True)(batch)
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), w[2 * rank:2 * rank + 2].numpy(), err_msg=name)
    chunks = [torch.from_numpy(batch[2 * rank:2 * rank + 2])]
    fused = torch_batch.make_fused_segment_fn(
        mesh_mod.Mesh(((torch.device("cpu"),),) * 2, processes=(0, 1)), cfg)(chunks)
    assert len(fused) == 1
    np.testing.assert_array_equal(fused[0][0].numpy(), want[7][2 * rank:2 * rank + 2].numpy())


def _pipelines():
    mesh = _two_process_mesh()
    cfg = AnalysisConfig(max_regions=MAX_REGIONS)
    return {
        "run_batch": lambda: list(torch_batch.run_batch(["a"], None, cfg, mesh=mesh)),
        "run_analysis": lambda: experiment.run_analysis("/nonexistent", cfg, False, mesh=mesh),
        "refine_boundaries_sharded": lambda: refine.refine_boundaries_sharded(
            np.zeros((2, 8, 8), np.float32), mesh=mesh, stack=True),
    }


@pytest.mark.parametrize("name", list(_pipelines()))
def test_the_pipelines_refuse_a_mesh_across_processes(name):
    with pytest.raises(ValueError, match="span processes.*make_sharded_segment_fn"):
        _pipelines()[name]()
