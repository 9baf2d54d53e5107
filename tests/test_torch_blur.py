"""Parity: the port's Gaussian blur in its contracted form (``fma=True``)
against ``jax.jit`` of the JAX package's ``gaussian_blur``, and the blur
kernel wrapper's refusals.

XLA's CPU code contracts the jitted blur's tap chain into fused
multiply-adds; eager JAX rounds every product and sum.  The port's default
form equals eager JAX (``test_torch_threshold.py``
``test_gaussian_blur_matches_jax``); ``fma=True`` must equal the jitted
blur.  Inputs are made with numpy from a seed, normal operands only (XLA's
CPU flushes subnormals, the port does not).  Tolerance 0: float32 bit
patterns.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops.filters import gaussian_blur as jax_blur
from particle_col_image_segmentation_tpu_torch.ops import (
    MAX_HALF,
    blur_plain,
    gaussian_blur,
    gaussian_blur_cuda,
    gaussian_taps,
)

from chip_smoke import blur_inputs, config2_stacks

jit_blur = jax.jit(jax_blur, static_argnums=1)

# 2.5 and 2.6: half-widths 5 and 6, the last of the blur kernel's register
# ring and the first of its shared window (csrc/blur.cu)
SIGMAS = [0.5, 1.0, 1.5, 2.3, 2.5, 2.6, 4.0]
SHAPES = [(61, 77), (3, 37, 53), (2, 5, 130), (1, 1, 1)]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float32, a.dtype
    return a.view(np.int32)


def _image(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "float32":  # normal values in [1, 1000)
        return (1 + rng.random(shape) * 999).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("dtype", ["uint16", "uint8", "float32"])
@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_blur_fma_matches_jax_jit(shape, sigma, dtype):
    img = _image(shape, dtype, seed=len(shape) + int(10 * sigma))
    got = gaussian_blur(torch.from_numpy(img), sigma, fma=True)
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jit_blur(jnp.asarray(img), sigma)))


def _stacks():
    """Two of config #2's stacks (bench.py's recipe, seed 2) at [3,96,130]."""
    return [s[:, :96].copy() for s in config2_stacks(2, 130, discs=6, planes=3)]


def test_blur_forms_differ_on_config2_stacks():
    """The two forms round differently on many pixels of config #2's
    stacks: the default equals eager JAX, ``fma=True`` the jitted blur, and
    neither equals the other's reference."""
    for stack in _stacks():
        x = torch.from_numpy(stack)
        op, fused = gaussian_blur(x, 1.0).numpy(), gaussian_blur(x, 1.0, fma=True).numpy()
        eager, jitted = jax_blur(jnp.asarray(stack), 1.0), jit_blur(jnp.asarray(stack), 1.0)
        np.testing.assert_array_equal(_bits(op), _bits(eager))
        np.testing.assert_array_equal(_bits(fused), _bits(jitted))
        differ = int((_bits(op) != _bits(fused)).sum())
        assert differ > stack.size // 20, differ
        assert (_bits(np.asarray(eager)) != _bits(np.asarray(jitted))).any()


@pytest.mark.parametrize("fma", [False, True])
def test_blur_plain_is_gaussian_blur_on_the_cpu(fma):
    """``blur_plain`` (the kernel's plain version) on the small inputs the
    smoke holds the kernel to, at σ 32 (the kernel's widest) too, is the
    CPU's ``gaussian_blur``: replicate padding on planes narrower and
    shorter than the kernel's half, uint16 and float32."""
    for case, u16, f32, _ in blur_inputs():
        for a in (u16, f32):
            x = torch.from_numpy(a)
            for sigma in (1.0, 2.3, MAX_HALF / 2):
                got = blur_plain(x.to(torch.float32), gaussian_taps(sigma), fma)
                want = gaussian_blur(x, sigma, fma=fma)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), case


def test_gaussian_blur_cpu_matches_jax_jit_at_the_kernels_widest_sigma():
    img = _image((2, 40, 150), "uint16", seed=5)
    got = gaussian_blur(torch.from_numpy(img), MAX_HALF / 2, fma=True)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(jit_blur(jnp.asarray(img), MAX_HALF / 2)))


def test_gaussian_taps():
    k = gaussian_taps(1.0)
    assert k.dtype == np.float32 and len(k) == 5 and not k.flags.writeable
    assert np.array_equal(k, k[::-1]) and abs(float(k.sum()) - 1) < 1e-6
    assert len(gaussian_taps(MAX_HALF / 2)) == 2 * MAX_HALF + 1


def test_gaussian_blur_cuda_refuses_what_the_kernel_does_not_take():
    """The wrapper raises on a CPU tensor (contiguous or not), a dtype the
    kernel does not read, a tensor of fewer than two dimensions or none
    of its pixels, and a σ past its limit; it never falls back."""
    x = torch.zeros((4, 6), dtype=torch.float32)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        gaussian_blur_cuda(x, 1.0)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        gaussian_blur_cuda(torch.zeros((6, 4)).t(), 1.0, fma=True)
    for dtype in (torch.uint8, torch.int32, torch.float64, torch.float16):
        with pytest.raises(ValueError, match="expected uint16 or float32"):
            gaussian_blur_cuda(x.to(dtype), 1.0)
    for shape in ((5,), (0, 4), (3, 0, 4)):
        with pytest.raises(ValueError, match="non-empty"):
            gaussian_blur_cuda(torch.zeros(shape), 1.0)
    for sigma in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="finite and > 0"):
            gaussian_blur_cuda(x, sigma)
    with pytest.raises(ValueError, match=f"> {MAX_HALF}, the tile's limit"):
        gaussian_blur_cuda(x, MAX_HALF / 2 + 0.01, fma=True)
    assert gaussian_blur_cuda.launches == 0
