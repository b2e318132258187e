"""The resize+argmax kernel (``csrc/resize_argmax.cu``) against the plain
``posterior_maps`` on the card.

Every test here needs the card (marker ``cuda``; each skips when
``torch.cuda.is_available()`` is false). Each holds the kernel's posteriors
and labels bit for bit to ``posterior_maps_plain`` on the same CUDA tensors:
at VGA and stride 2 on the bench forest's posteriors with the offline (-1000)
and online (0) fills, on frame sizes the stride does not divide, with every
grid point masked, with constructed ties and with non-finite values, and at
the kernel's largest layers and classes. Through ``run_batch_stacked`` the
kernel counts one launch a frame, and a batch's results equal those of the
plain version; what the kernel does not take raises on the card instead of
running the plain version. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_resize_argmax_cuda.py -q

The dispatch and the contract on the CPU are in ``tests/test_torch_pipeline.py``.
This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch.bench import (
    CLASS_COUNTS,
    FIXTURE,
    FOCAL,
    STRIDE,
    make_depth,
)
from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
from rovinasemanticsegmentation_tpu_torch.ops import resize_argmax_cuda
from rovinasemanticsegmentation_tpu_torch.pipelines import single_frame

pytestmark = pytest.mark.cuda

H, W = 480, 640


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().view(torch.int32).numpy()  # NaN-safe bit comparison


def _check(post, mask, grid, counts, fill, h, w):
    """The kernel against the plain version: one frame counted, posteriors
    and labels bit-equal. -> the kernel's labels."""
    launch, got_post, got_lbl = resize_argmax_cuda.launcher(
        post, mask, grid, counts, fill, h, w)
    before = resize_argmax_cuda.launches.value
    launch()
    torch.cuda.synchronize()
    assert resize_argmax_cuda.launches.value == before + 1
    want_post, want_lbl = single_frame.posterior_maps_plain(
        post, mask, grid, counts, fill, h, w)
    for g, p, c in zip(got_lbl, got_post, counts):
        assert g.shape == (h, w) and g.dtype == torch.int8
        assert p.shape == (h, w, c) and p.dtype == torch.float32
    for g, p in zip(got_post, want_post):
        np.testing.assert_array_equal(_bits(g), _bits(p))
    for g, p in zip(got_lbl, want_lbl):
        np.testing.assert_array_equal(g.cpu().numpy(), p.cpu().numpy())
    return got_lbl


def _pipeline(dev, fill):
    forest = load_forest(FIXTURE, class_counts=CLASS_COUNTS)
    return single_frame.SingleFramePipeline(FeatureConfig(), forest, STRIDE,
                                            dev, fill_value=fill)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    rgb = np.stack([rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                    for _ in range(n)])
    depth = np.stack([make_depth(rng, H, W) for _ in range(n)])
    k = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]])
    return (rgb, depth, np.stack([np.linalg.inv(k)] * n),
            np.stack([np.eye(3)] * n), np.zeros((n, 3)))


def _random(dev, h, w, stride, counts=(8, 9), cmax=9, seed=0, masked=0.3):
    rng = np.random.default_rng(seed)
    gh, gw = -(-h // stride), -(-w // stride)
    post = rng.normal(scale=3.0, size=(gh * gw, len(counts), cmax))
    mask = rng.random(gh * gw) >= masked
    return (torch.from_numpy(post.astype(np.float32)).to(dev),
            torch.from_numpy(mask).to(dev), (gh, gw))


@pytest.mark.parametrize("fill", [-1000.0, 0.0])
def test_vga_bench_forest_bit_equal(dev, fill):
    """The bench forest's posteriors of two VGA keyframes at stride 2."""
    pipe = _pipeline(dev, fill)
    post, masks = pipe.stacked_posteriors(*_frames(2))
    grid = pipe.grid_shape(H, W)
    p = grid[0] * grid[1]
    for i, mask in enumerate(masks):
        assert 0 < int(mask.sum()) < p
        labels = _check(post[i * p:(i + 1) * p], mask, grid, CLASS_COUNTS,
                        fill, H, W)
        assert all(np.unique(lbl.cpu().numpy()).size > 2 for lbl in labels)


@pytest.mark.parametrize("fill", [-1000.0, 0.0])
@pytest.mark.parametrize("h,w,stride", [(479, 637, 2), (479, 637, 3),
                                        (61, 83, 5), (33, 130, 1)])
def test_sizes_the_stride_does_not_divide(dev, h, w, stride, fill):
    post, mask, grid = _random(dev, h, w, stride, seed=h + w + stride)
    _check(post, mask, grid, (8, 9), fill, h, w)


def test_every_grid_point_masked(dev):
    post, _, grid = _random(dev, H, W, STRIDE, seed=1)
    mask = torch.zeros(grid[0] * grid[1], dtype=torch.bool, device=dev)
    for lbl in _check(post, mask, grid, (8, 9), -1000.0, H, W):
        assert (lbl == -1).all()


def test_ties_take_the_first_maximum(dev):
    """Small integers: many pixels have equal maxima among their classes."""
    rng = np.random.default_rng(2)
    gh, gw = 240, 320
    post = torch.from_numpy(
        rng.integers(-2, 2, (gh * gw, 2, 9)).astype(np.float32)).to(dev)
    mask = torch.ones(gh * gw, dtype=torch.bool, device=dev)
    labels = _check(post, mask, (gh, gw), (8, 9), -1000.0, H, W)
    full, _ = single_frame.posterior_maps_plain(post, mask, (gh, gw), (8, 9),
                                                -1000.0, H, W)
    for f, lbl in zip(full, labels):
        f = f.cpu().numpy()
        tied = ((f == f.max(axis=-1, keepdims=True)).sum(axis=-1) > 1)
        assert tied.mean() > 0.05  # ~8% of the pixels: ~25000 ties a layer
        np.testing.assert_array_equal(lbl.cpu().numpy()[tied],
                                      np.argmax(f, axis=-1)[tied])


def test_non_finite_values(dev):
    post, mask, grid = _random(dev, 95, 131, 2, seed=3)
    flat = post.view(-1)
    flat[::7] = -float("inf")
    flat[::53] = float("nan")
    labels = _check(post, mask, grid, (8, 9), -1000.0, 95, 131)
    assert (labels[1] == -1).any()


@pytest.mark.parametrize("counts,cmax", [
    ((resize_argmax_cuda.MAX_CLASSES,) * resize_argmax_cuda.MAX_LAYERS, 32),
    ((5,), 12), ((3, 1), 9),
])
def test_layers_and_classes(dev, counts, cmax):
    """The largest layers and classes (2 x 32: shared memory above 48 KB),
    one layer, and classes fewer than the rows hold."""
    post, mask, grid = _random(dev, 97, 301, 2, counts=counts, cmax=cmax,
                               seed=len(counts))
    _check(post, mask, grid, counts, -1000.0, 97, 301)


def test_run_batch_stacked_counts_one_launch_a_frame(dev, monkeypatch):
    pipe = _pipeline(dev, -1000.0)
    frames = _frames(3, seed=5)
    before = resize_argmax_cuda.launches.value
    got = pipe.run_batch_stacked(*frames)
    torch.cuda.synchronize()
    assert resize_argmax_cuda.launches.value == before + 3
    monkeypatch.setattr(single_frame, "posterior_maps",
                        single_frame.posterior_maps_plain)
    want = pipe.run_batch_stacked(*frames)
    assert resize_argmax_cuda.launches.value == before + 3
    for g, p in zip(got, want):
        for a, b in zip(g.posteriors, p.posteriors):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for a, b in zip(g.labels, p.labels):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,counts,cmax,match", [
    (torch.float64, (8, 9), 9, "float32"),
    (torch.float32, (33, 9), 33, "classes"),
    (torch.float32, (3, 3, 3), 9, "classes"),
])
def test_what_the_kernel_does_not_take_raises_on_the_card(dev, dtype, counts,
                                                          cmax, match):
    """``posterior_maps`` does not run the plain version on the card."""
    post, mask, grid = _random(dev, 61, 83, 2, counts=counts, cmax=cmax)
    before = resize_argmax_cuda.launches.value
    with pytest.raises(ValueError, match=match):
        single_frame.posterior_maps(post.to(dtype), mask, grid, counts,
                                    -1000.0, 61, 83)
    assert resize_argmax_cuda.launches.value == before
