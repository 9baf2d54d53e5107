"""The hand-written CUDA kernels K1-K4 against their plain PyTorch versions,
on the card.  Every test here needs a Hopper card and skips where there is
none; on one, run them with

    python -m pytest tests/test_torch_cuda.py -q

Outputs are integers, so the tolerance is exact equality.  Inputs are made
with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from particle_col_image_segmentation_tpu_torch.ops import (
    ccl_cuda,
    compact_labels,
    compact_labels_cuda,
    connected_components,
    median_label_filter,
    median_label_filter_cuda,
    region_counts,
    region_counts_cuda,
)

from fixtures import random_class_plane, synthetic_label_plane

pytestmark = pytest.mark.cuda

SHAPES = [(64, 128), (2, 37, 53), (3, 97, 130), (1, 3, 5)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    planes = [synthetic_label_plane(seed=seed + b, shape=(192, 192))[:shape[-2], :shape[-1]]
              for b in range(int(np.prod(shape[:-2])))]
    img = np.stack(planes).reshape(shape).copy()
    img[rng.random(shape) < 0.05] = 1  # salt
    return img


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("size", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", SHAPES)
def test_median_kernel(dev, shape, size):
    x = torch.from_numpy(_planes(shape, seed=1)).to(dev)
    before = median_label_filter_cuda.launches
    _equal([median_label_filter_cuda(x, size, 8)], [median_label_filter(x, size, 8)])
    assert median_label_filter_cuda.launches == before + 1
    wide = torch.from_numpy(np.random.default_rng(2).integers(0, 12, shape).astype(np.uint8)).to(dev)
    _equal([median_label_filter_cuda(wide, size, 5)], [median_label_filter(wide, size, 5)])


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("background", [None, 0, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_ccl_and_compact_kernels(dev, shape, background, connectivity):
    x = torch.from_numpy(_planes(shape, seed=3)).to(dev)
    before = (ccl_cuda.launches, compact_labels_cuda.launches)
    raw = ccl_cuda(x, background=background, connectivity=connectivity)
    want, conv = connected_components(
        x, background=background, connectivity=connectivity, max_iters=4096,
        with_flag=True,
    )
    assert bool(conv.all())
    _equal([raw], [want])
    _equal(compact_labels_cuda(raw, 16383), compact_labels(raw, 16383))
    assert (ccl_cuda.launches, compact_labels_cuda.launches) == (before[0] + 1, before[1] + 1)


def test_ccl_kernel_int32_values_and_spiral(dev):
    vals = torch.from_numpy(random_class_plane((3, 70, 90), 6, seed=4).astype(np.int32)).to(dev)
    _equal([ccl_cuda(vals)], [connected_components(vals, max_iters=4096)])
    H = W = 96  # one snake winding through the whole plane
    snake = np.zeros((H, W), np.uint8)
    for i in range(0, H, 2):
        snake[i, :] = 1
        snake[i + 1, W - 1 if (i // 2) % 2 == 0 else 0] = 1
    s = torch.from_numpy(snake).to(dev)
    _equal([ccl_cuda(s, background=0)],
           [connected_components(s, background=0, max_iters=4096)])


@pytest.mark.parametrize("max_regions", [16383, 20000, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_region_counts_kernel(dev, shape, max_regions):
    x = torch.from_numpy(_planes(shape, seed=5)).to(dev)
    seg, _ = compact_labels(connected_components(x, max_iters=4096), max_regions)
    before = region_counts_cuda.launches
    _equal(region_counts_cuda(seg, x, max_regions), region_counts(seg, x, max_regions))
    assert region_counts_cuda.launches == before + 1


def test_region_counts_kernel_drops_and_saturates(dev):
    rng = np.random.default_rng(6)
    seg = torch.from_numpy(rng.integers(-3, 40, (2, 64, 256)).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(-16384, 16384, (2, 64, 256)).astype(np.int32)).to(dev)
    _equal(region_counts_cuda(seg, vals, 30), region_counts(seg, vals, 30))
    big = torch.zeros((2, 512, 512), dtype=torch.int32, device=dev)
    big_vals = torch.full((2, 512, 512), 16383, dtype=torch.int32, device=dev)
    big_vals[1] = -16384
    _equal(region_counts_cuda(big, big_vals, 4), region_counts(big, big_vals, 4))


def test_wrappers_check_their_inputs(dev):
    x = torch.zeros((2, 16, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        median_label_filter_cuda(x.to(torch.int32))
    with pytest.raises(ValueError, match="num_classes"):
        median_label_filter_cuda(x, 5, 9)
    with pytest.raises(ValueError, match="size"):
        median_label_filter_cuda(x, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ccl_cuda(x.transpose(1, 2))
    with pytest.raises(ValueError, match="int32"):
        compact_labels_cuda(x, 8)
    with pytest.raises(ValueError, match="shapes"):
        region_counts_cuda(x.to(torch.int32), x[:1], 8)
