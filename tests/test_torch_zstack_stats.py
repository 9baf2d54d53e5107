"""Config #2's entry on the port's path, ``models.zstack.zstack_stats_device``,
against the benchmark's plain reference (``benchmark/reference/zstack.py``)
and against the JAX package's jitted graph, on the CPU.

Inputs are the benchmark's z-stacks (``benchmark/traffic/zstacks.py``) at
small shapes, drawn from the test's seed.  The tolerance is 0: thresholds
and the blurred stack are compared as float32 bit patterns, labels, tables
and counts as integers.  The reference computed one precision lower
(``control=True``, bfloat16) must differ from the program.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import threshold as jax_threshold
from particle_col_image_segmentation_tpu.ops.filters import gaussian_blur as jax_blur
from particle_col_image_segmentation_tpu_torch.models import zstack_stats_device

from benchmark import harness

OPTIONS = {"sigma": 1.0, "bins": 256, "max_regions": 4095, "min_area": 1}
SEEDS = (3, 29, 2**31 + 17)
SHAPES = ((4, 128, 128), (3, 97, 130))


def _stack(shape, seed: int) -> torch.Tensor:
    """A uint16 [P, H, W] z-stack of the benchmark's recipe, shrunk to
    ``shape`` (one particle, cells at about the cell's density a pixel),
    its layout and its order drawn from ``seed``."""
    P, H, W = shape
    p = json.loads((harness.ROOT / "benchmark" / "traffic" / "stack.b50.json").read_text())
    p.update(layout_seed=seed, batch=P, plane=[H, W], staged=1, particles=1,
             particle_r=[10, 20], particle_margin=24, cells=H * W // 140)
    return harness.load_module(harness.ROOT, "traffic", p["generator"]).make(p, seed, "cpu")[0]


def _reference():
    return harness.load_module(harness.ROOT, "reference", "zstack")


def _bits(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.float32
    return t.view(torch.int32).numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_zstack_stats_equal_the_plain_reference(shape, seed):
    x = _stack(shape, seed)
    got = zstack_stats_device(x)
    want, held = _reference().compute(x, OPTIONS, full=True)
    np.testing.assert_array_equal(_bits(got.thresholds), want["threshold_bits"])
    for name in ("count", "num_fg", "num_total", "converged"):
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64), want[name],
                                      err_msg=name)
    np.testing.assert_array_equal(_bits(got.den), _bits(held["den"]))
    for name in ("seg", "areas", "classes"):
        g, w = getattr(got, name), held[name]
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w), name
    assert (got.num_fg > 0).all() and got.converged.all()


@jax.jit
def _jax_zstack(x):
    """bench.py's jitted graph of config #2, its thresholds beside it."""
    den = jax_blur(x.astype(jnp.float32), sigma=1.0)
    return (den, jax_threshold.otsu_threshold_batch(den),
            jax_threshold.threshold_and_count_batch(den, max_regions=4095))


@pytest.mark.parametrize("seed", SEEDS)
def test_zstack_stats_equal_the_jax_packages_jitted_graph(seed):
    assert jax.config.jax_enable_x64 is False
    x = _stack(SHAPES[1], seed)
    got = zstack_stats_device(x)
    den, thresholds, (_, _, count, num_fg, num_total, _) = _jax_zstack(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(_bits(got.thresholds), np.asarray(thresholds).view(np.int32))
    np.testing.assert_array_equal(_bits(got.den), np.asarray(den).view(np.int32))
    for name, want in (("count", count), ("num_fg", num_fg), ("num_total", num_total)):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_one_precision_lower_differs(seed):
    x = _stack(SHAPES[0], seed)
    got = zstack_stats_device(x)
    want, held = _reference().compute(x, OPTIONS, control=True, full=True)
    differ = (int((_bits(got.thresholds) != want["threshold_bits"]).sum())
              + int((got.den != held["den"]).sum()))
    assert differ > 0
