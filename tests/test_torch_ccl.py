"""Parity: the PyTorch port's CCL and compaction (the plain versions behind
K2 and K3) against the JAX package's fixpoint, its band-sweep Pallas kernel
and the NumPy oracle.

Inputs are made with numpy from a seed and handed to both packages.  Labels
are integers, so the tolerance is exact equality.  The Pallas kernels run in
interpret mode at the shapes and tiles ``test_ops_core.py`` uses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from particle_col_image_segmentation_tpu.ops import ccl as jax_ccl
from particle_col_image_segmentation_tpu.ops.ccl_tiles import ccl_sweeps
from particle_col_image_segmentation_tpu.oracle import ndimage as ond
from particle_col_image_segmentation_tpu_torch.ops.ccl import (
    compact_labels,
    compact_labels_auto,
    connected_components,
    connected_components_auto,
    label_image,
)
from particle_col_image_segmentation_tpu_torch.ops.ccl_tiles import (
    ccl_cuda,
    compact_labels_cuda,
)

from fixtures import random_class_plane, synthetic_label_plane
from chip_smoke import k3_raw, scipy_min_index
from test_torch_cuda import ODD_WIDTHS, ccl_plane


def _case(case):
    """The structured, speckle, binary and stripe planes of test_ops_core."""
    if case == "structured":
        return synthetic_label_plane(seed=1, shape=(128, 128))
    if case == "speckle":
        return random_class_plane((128, 128), 4, seed=2)
    if case == "binary":
        return (random_class_plane((128, 128), 2, seed=3) == 1).astype(np.uint8)
    img = np.full((128, 128), 3, np.uint8)  # full-height stripe
    img[:, 60:64] = 1
    return img


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("background", [None, 0])
@pytest.mark.parametrize("case", ["structured", "speckle", "binary", "stripe"])
def test_connected_components_matches_jax(case, background, connectivity):
    img = _case(case)
    got = connected_components(
        torch.from_numpy(img), background=background, connectivity=connectivity
    ).numpy()
    assert got.dtype == np.int32
    want = np.asarray(jax_ccl.connected_components(
        jnp.asarray(img), background=background, connectivity=connectivity
    ))
    np.testing.assert_array_equal(got, want)
    if connectivity == 8:
        sweeps = ccl_sweeps(jnp.asarray(img), background=background, tile=32,
                            interpret=True)
        np.testing.assert_array_equal(got, np.asarray(sweeps))


@pytest.mark.parametrize("case", ["structured", "speckle", "binary"])
def test_compact_labels_batched_matches_jax(case):
    imgs = np.stack([_case(case)[:64], _case(case)[64:]])
    bg = 0 if case == "binary" else None
    raw = connected_components(torch.from_numpy(imgs), background=bg, num_classes=4)
    seg, num = compact_labels(raw, 4096)
    assert seg.shape == imgs.shape and num.shape == (2,)
    raw_j = jnp.asarray(raw.numpy())
    seg_j, num_j = jax.vmap(lambda r: jax_ccl.compact_labels(r, 4096))(raw_j)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(num.numpy(), np.asarray(num_j))
    seg_s, num_s = jax_ccl.compact_labels_sweeps(raw_j, 4096, tile=8, interpret=True)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_s))
    np.testing.assert_array_equal(num.numpy(), np.asarray(num_s))


@pytest.mark.parametrize("shape", [(2, 37, 53), (3, 16, 17), (1, 1, 1), (5, 9, 1), (64, 3, 5)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_labels_on_raw_that_is_not_ccl_output_matches_jax(shape, seed):
    """K3's contract beyond CCL output: raw in [-5, H*W+5) with forward
    references, non-root targets, values past the plane, -1 background and
    int32 extremes, against the JAX compact_labels plane by plane.  The
    JAX band sweeps propagate a root's rank through its component, so they
    hold only for CCL output (test_compact_labels_batched_matches_jax)."""
    raw = k3_raw(shape, seed=seed)
    pick = np.random.default_rng(seed).random(shape)
    raw[pick < 0.05] = -(2**31)
    raw[(pick >= 0.05) & (pick < 0.1)] = 2**31 - 1
    raw[(pick >= 0.1) & (pick < 0.15)] = -1
    seg, num = compact_labels(torch.from_numpy(raw), 4096)
    seg_j, num_j = jax.vmap(lambda r: jax_ccl.compact_labels(r, 4096))(jnp.asarray(raw))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(num.numpy(), np.asarray(num_j))
    flat = raw.reshape(shape[0], -1)
    roots = flat == np.arange(flat.shape[1])
    assert num.tolist() == roots.sum(1).tolist()
    seg2, num2 = compact_labels(torch.from_numpy(raw[0]), 4096)
    np.testing.assert_array_equal(seg2.numpy(), seg.numpy()[0])
    assert int(num2) == int(num[0])


def test_max_iters_flag_per_plane():
    """A plane that exhausts max_iters reports converged=False (labels then
    equal JAX's partial fixpoint round for round); an easy plane in the same
    batch reports True."""
    H = W = 64
    snake = np.zeros((H, W), np.uint8)
    for i in range(0, H, 2):
        snake[i, :] = 1
        snake[i + 1, W - 1 if (i // 2) % 2 == 0 else 0] = 1
    easy = np.ones((H, W), np.uint8)
    imgs = np.stack([snake, easy])
    got, conv = connected_components(
        torch.from_numpy(imgs), background=0, max_iters=3, with_flag=True
    )
    want, conv_j = jax_ccl.connected_components(
        jnp.asarray(imgs), background=0, max_iters=3, with_flag=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert conv.tolist() == np.asarray(conv_j).tolist() == [False, True]
    _, conv = connected_components(
        torch.from_numpy(imgs), background=0, max_iters=64, with_flag=True
    )
    assert conv.tolist() == [True, True]


@pytest.mark.parametrize("background", [None, 0])
def test_label_image_matches_oracle(background):
    img = random_class_plane((48, 64), 3, seed=9) - 1
    seg, num = label_image(torch.from_numpy(img), background=background)
    ref, ref_n = ond.label(
        img, background=-1 if background is None else background, return_num=True
    )
    assert int(num) == ref_n
    np.testing.assert_array_equal(seg.numpy(), ref)


def test_auto_takes_plain_on_cpu_and_wrappers_refuse_cpu():
    img = torch.from_numpy(random_class_plane((2, 32, 40), 3, seed=5))
    counts = (ccl_cuda.launches, compact_labels_cuda.launches)
    raw, conv = connected_components_auto(img, with_flag=True)
    assert torch.equal(raw, connected_components(img))
    assert conv.dtype == torch.bool and conv.tolist() == [True, True]
    seg, num, conv = compact_labels_auto(raw, 4096, with_flag=True)
    want_seg, want_num = compact_labels(raw, 4096)
    assert torch.equal(seg, want_seg) and torch.equal(num, want_num)
    assert conv.tolist() == [True, True]
    assert (ccl_cuda.launches, compact_labels_cuda.launches) == counts
    with pytest.raises(ValueError, match="CUDA"):
        ccl_cuda(img)
    with pytest.raises(ValueError, match="CUDA"):
        compact_labels_cuda(raw, 4096)


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("case", ["single", "serpentine", "checker", "checker2", "stripes_h",
                                  "stripes_v", "noise", "int32_extremes"])
def test_plain_ccl_on_k2_adversarial_inputs_matches_jax(case, connectivity):
    """The inputs K2's card tests and chip_smoke.py judge it on, at 96²:
    the plain fixpoint equals the JAX one and the scipy-derived min-index
    labels.  int32 extremes lie outside [0, num_classes), where both
    fixpoints link runs but no other neighbours (any two equal values link
    in K2), so there only the two packages are held together."""
    img, background = ccl_plane(case, 96, 96, seed=1)
    got, conv = connected_components(torch.from_numpy(img), background=background,
                                     connectivity=connectivity, max_iters=4096, with_flag=True)
    want, wconv = jax_ccl.connected_components(
        jnp.asarray(img), background=background, connectivity=connectivity,
        max_iters=4096, with_flag=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(conv) and bool(wconv)
    if case != "int32_extremes":
        np.testing.assert_array_equal(got.numpy(), scipy_min_index(img, background, connectivity))


@pytest.mark.parametrize("W", ODD_WIDTHS)
def test_plain_ccl_odd_widths_matches_jax_and_scipy(W):
    for case in ("majority", "serpentine", "noise_bg0"):
        img, background = ccl_plane(case, 70, W, seed=W)
        for connectivity in (8, 4):
            got = connected_components(torch.from_numpy(img), background=background,
                                       connectivity=connectivity, max_iters=4096).numpy()
            want = jax_ccl.connected_components(jnp.asarray(img), background=background,
                                                connectivity=connectivity, max_iters=4096)
            np.testing.assert_array_equal(got, np.asarray(want))
            np.testing.assert_array_equal(got, scipy_min_index(img, background, connectivity))
