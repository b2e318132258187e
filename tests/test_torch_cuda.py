"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is
false. On a machine with an NVIDIA GPU (which need not have JAX; the
repository's ``conftest.py`` imports it, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch.models.forest import (
    TreeArrays,
    build_forest,
    forest_from_numpy,
)
from rovinasemanticsegmentation_tpu_torch.ops import forest_cuda, patches_cuda
from rovinasemanticsegmentation_tpu_torch.ops.patches import (
    extract_patches_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _random_forest(rng, num_trees, depth, num_features, class_counts):
    """A complete-depth random forest in the reference Forest layout."""
    trees = []
    c_max = max(class_counts)
    for _ in range(num_trees):
        n_inner = 2 ** depth - 1
        n = 2 * n_inner + 1
        left = np.zeros(n, np.int32)
        left[:n_inner] = 2 * np.arange(n_inner) + 1
        hist = rng.normal(size=(n, len(class_counts), c_max)).astype(np.float32)
        hist *= (left == 0)[:, None, None]
        trees.append(TreeArrays(
            split_feature=rng.integers(0, num_features, n).astype(np.int32)
            * (left != 0),
            threshold=(rng.normal(size=n) * (left != 0)).astype(np.float32),
            left_child=left,
            leaf_hist=hist,
        ))
    return build_forest(trees, class_counts)


@pytest.mark.parametrize("stride,h,w,b,r", [
    (1, 40, 52, 15, 5), (2, 61, 80, 77, 11), (3, 50, 64, 77, 11),
    (5, 96, 128, 77, 11),
])
def test_patches_kernel_bit_exact(dev, stride, h, w, b, r):
    rng = np.random.default_rng(stride)
    lab = torch.from_numpy(
        rng.integers(0, 256, (h + 2 * b, w + 2 * b, 3), dtype=np.uint8)
    ).to(dev)
    gh, gw = -(-h // stride), -(-w // stride)
    depth = rng.uniform(0.05, 9.0, (gh, gw)).astype(np.float32)
    depth[rng.random((gh, gw)) < 0.1] = 0.0
    depth_t = torch.from_numpy(depth).to(dev)
    before = patches_cuda.launches.value
    got = patches_cuda.extract_patches(lab, depth_t, b, r, stride)
    assert patches_cuda.launches.value == before + 1
    want = extract_patches_plain(lab, depth_t, b, r, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("trees,depth,feats", [(4, 10, 366), (3, 6, 700),
                                                (1, 0, 5)])
def test_forest_kernel_equal(dev, trees, depth, feats):
    rng = np.random.default_rng(depth)
    forest = forest_from_numpy(
        _random_forest(rng, trees, depth, feats, [8, 9]), dev
    )
    x = rng.normal(size=(3001, feats)).astype(np.float32)
    x[::5, :] = np.nan  # NaN goes left
    thr = forest.records[0, 0, 1].view(torch.float32).item()
    x[1::5, int(forest.records[0, 0, 0].item()) & ((1 << forest.feat_bits) - 1)] = thr
    xt = torch.from_numpy(x).to(dev)
    before = forest_cuda.launches.value
    leaves, post = forest_cuda.forest_predict(xt, forest)
    assert forest_cuda.launches.value == before + 1
    want_leaves, want_post = forest_cuda.forest_predict_plain(xt, forest)
    torch.cuda.synchronize()
    assert torch.equal(leaves, want_leaves)
    assert torch.equal(post, want_post)


def test_kernels_reject_bad_inputs(dev):
    lab = torch.zeros((40, 40, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        patches_cuda.extract_patches(
            lab, torch.ones((4, 4), dtype=torch.float64, device=dev), 15, 5, 2
        )
    rng = np.random.default_rng(0)
    forest = forest_from_numpy(_random_forest(rng, 2, 3, 10, [3]), dev)
    with pytest.raises(ValueError):
        forest_cuda.forest_predict(torch.zeros((5, 10)), forest)  # CPU input
