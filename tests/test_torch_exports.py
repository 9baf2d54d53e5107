"""The port's last small counterparts and its subpackages' re-exports, against
the JAX package: ``labels.classmaps.particle_value`` / ``strain_values``,
``io.loader.prefetch_map``, ``ops.scans.directional_distance`` (int32,
capped, exact against JAX's associative scan), and the names each
subpackage's ``__init__`` exports, which must import neither h5py nor
matplotlib where the JAX package's do not.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from particle_col_image_segmentation_tpu.io import loader as jax_loader
from particle_col_image_segmentation_tpu.labels import classmaps as jax_classmaps
from particle_col_image_segmentation_tpu.ops import scans as jax_scans
from particle_col_image_segmentation_tpu_torch.io import loader
from particle_col_image_segmentation_tpu_torch.labels import classmaps
from particle_col_image_segmentation_tpu_torch.ops import scans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("report", "models", "io", "utils", "labels", "parallel", "viz", "oracle")


@pytest.mark.parametrize("cell_types", [
    {1: "3D05", 2: "Particle", 3: "Background"},
    {1: "3D05", 2: "6B07", 3: "C3M10", 4: "Particle", 5: "Background"},
    {1: "Particle", 2: "Background"},
    {1: "6B07", 2: "Background"},
])
def test_particle_value_and_strain_values_equal_jax(cell_types):
    assert classmaps.strain_values(cell_types) == jax_classmaps.strain_values(cell_types)
    if "Particle" in cell_types.values():
        assert classmaps.particle_value(cell_types) == jax_classmaps.particle_value(cell_types)
        return
    messages = []
    for fn in (classmaps.particle_value, jax_classmaps.particle_value):
        with pytest.raises(ValueError) as e:
            fn(cell_types)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _load(path):
    if path.endswith("bad"):
        raise OSError(f"cannot decode {path}")
    return np.full((2, 3), int(path.split("/")[-1].rstrip("bad") or 0), np.uint8)


@pytest.mark.parametrize("prefetch", [1, 3, 8])
def test_prefetch_map_equals_jax(prefetch):
    paths = [f"p/{i}" for i in range(7)]
    got = list(loader.prefetch_map(_load, paths, 2, prefetch))
    want = list(jax_loader.prefetch_map(_load, paths, 2, prefetch))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    bad = paths[:3] + ["p/3bad"] + paths[4:]
    skipped = list(loader.prefetch_map(_load, bad, 2, prefetch, on_error="skip"))
    assert [int(x[0, 0]) for x in skipped] == [int(x[0, 0]) for x in jax_loader.prefetch_map(
        _load, bad, 2, prefetch, on_error="skip")] == [0, 1, 2, 4, 5, 6]
    for mod in (loader, jax_loader):
        with pytest.raises(OSError, match="cannot decode p/3bad"):
            list(mod.prefetch_map(_load, bad, 2, prefetch))


def _features():
    rng = np.random.default_rng(17)
    return {
        "sparse": rng.random((3, 37, 90)) < 0.02,
        "dense": rng.random((3, 37, 90)) < 0.5,
        "empty": np.zeros((2, 20, 30), bool),
        "full": np.ones((2, 20, 30), bool),
        "2-D": rng.random((70, 41)) < 0.05,
    }


@pytest.mark.parametrize("cap", [0, 1, 5, 64])
@pytest.mark.parametrize("case", list(_features()))
def test_directional_distance_equals_jax(case, cap):
    f = _features()[case]
    for axis in (-1, -2):
        got = scans.directional_distance(torch.from_numpy(f), axis, cap)
        want = np.asarray(jax_scans.directional_distance(jnp.asarray(f), axis, cap))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[torch.from_numpy(f)] == 0).all() and int(got.max()) <= cap


_IMPORTS = """
import importlib, json, sys
mods = {}
for sub in sys.argv[2:]:
    before = set(sys.modules)
    m = importlib.import_module(sys.argv[1] + "." + sub)
    mods[sub] = {"heavy": sorted({k.split(".")[0] for k in set(sys.modules) - before}
                                 & {"h5py", "matplotlib", "jax"}),
                 "names": sorted(n for n in vars(m) if not n.startswith("_")
                                 and not hasattr(getattr(m, n), "__path__")
                                 and getattr(getattr(m, n), "__module__", "").startswith(sys.argv[1]))}
print(json.dumps(mods))
"""


def _fresh_imports(package: str) -> dict:
    """{subpackage: (heavy modules its import pulled in, the names it
    exports)}, each subpackage in a fresh interpreter."""
    out = {}
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for sub in SUBPACKAGES:
        res = subprocess.run([sys.executable, "-c", _IMPORTS, package, sub], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        out[sub] = json.loads(res.stdout.splitlines()[-1])[sub]
    return out


def test_subpackages_reexport_jax_names_and_import_nothing_heavy_jax_does_not():
    port = _fresh_imports("particle_col_image_segmentation_tpu_torch")
    jax_side = _fresh_imports("particle_col_image_segmentation_tpu")
    for sub in SUBPACKAGES:
        assert "jax" not in port[sub]["heavy"], sub
        assert set(port[sub]["heavy"]) <= set(jax_side[sub]["heavy"]), (sub, port[sub])
        if sub != "viz":  # kept lazy: the figures import matplotlib
            missing = set(jax_side[sub]["names"]) - set(port[sub]["names"])
            assert not missing, (sub, missing)
    assert port["viz"]["names"] == [] and "matplotlib" in jax_side["viz"]["heavy"]
    assert {"initialize_multihost", "process_allgather"} <= set(port["parallel"]["names"])
