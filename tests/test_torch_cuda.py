"""The CUDA kernels against their plain PyTorch versions, the dense CRF's
lattice build and mean field against the CPU's, and the run-to-run
equality of the unary accumulation and of ``DenseCRF.map``, on the card.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is
false. On a machine with an NVIDIA GPU (which need not have JAX; the
repository's ``conftest.py`` imports it, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch.fusion.unaries import (
    accumulate_unaries,
)
from rovinasemanticsegmentation_tpu_torch.models.crf import (
    DenseCRF2D,
    PottsCompatibility,
    potts_mean_field_multi_t,
)
from rovinasemanticsegmentation_tpu_torch.models.forest import (
    TreeArrays,
    build_forest,
    find_leaves_plain,
    forest_from_numpy,
    permute_forest_features,
    usage_permutation,
)
from rovinasemanticsegmentation_tpu_torch.models.lattice import (
    build_lattice_device,
    lattice_filter_t,
)
from rovinasemanticsegmentation_tpu_torch.ops import forest_cuda, patches_cuda
from rovinasemanticsegmentation_tpu_torch.ops import forest_staged_cuda
from rovinasemanticsegmentation_tpu_torch.ops import patches_planar_cuda
from rovinasemanticsegmentation_tpu_torch.ops.patches import (
    extract_patches_plain,
    extract_patches_separable_plain,
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


@pytest.mark.parametrize("stride,h,w,b,r", [
    (1, 40, 52, 15, 5), (2, 61, 80, 77, 11), (3, 50, 64, 77, 11),
    (5, 96, 128, 77, 11), (2, 33, 45, 21, 7),
])
def test_planar_patches_kernel_bit_exact(dev, stride, h, w, b, r):
    rng = np.random.default_rng(10 + stride)
    lab = torch.from_numpy(
        rng.integers(0, 256, (h + 2 * b, w + 2 * b, 3), dtype=np.uint8)
    ).to(dev)
    gh, gw = -(-h // stride), -(-w // stride)
    depth = rng.uniform(0.05, 9.0, (gh, gw)).astype(np.float32)
    depth[rng.random((gh, gw)) < 0.1] = 0.0
    depth_t = torch.from_numpy(depth).to(dev)
    before = patches_planar_cuda.launches.value
    got = patches_planar_cuda.extract_patches_planar(lab, depth_t, b, r, stride)
    assert patches_planar_cuda.launches.value == before + 1
    want = extract_patches_plain(lab, depth_t, b, r, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, patches_cuda.extract_patches(lab, depth_t, b, r,
                                                         stride))
    assert torch.equal(got, extract_patches_separable_plain(lab, depth_t, b,
                                                            r, stride))


@pytest.mark.parametrize("hot,tile_points,trees,feats", [
    (366, 32, 4, 366),  # whole rows staged, 16-byte vector loads
    (128, 32, 4, 366),
    (0, 16, 4, 366),  # nothing staged: every lookup from device memory
    (366, 7, 4, 366),  # odd tile: rows start unaligned
    (256, 64, 4, 366),  # 64 KB of shared memory: above the 48 KB default
    (700, 16, 3, 700),  # D > 512: feat_bits = 10
])
def test_staged_descent_kernel_equal(dev, hot, tile_points, trees, feats):
    rng = np.random.default_rng(hot + tile_points)
    forest = forest_from_numpy(
        _random_forest(rng, trees, 10, feats, [8, 9]), dev
    )
    x = rng.normal(size=(3001, feats)).astype(np.float32)  # ragged last tile
    x[::5, :] = np.nan  # NaN goes left
    thr = forest.records[0, 0, 1].view(torch.float32).item()
    fmask = (1 << forest.feat_bits) - 1
    x[1::5, int(forest.records[0, 0, 0].item()) & fmask] = thr  # x == thr
    perm, remap = usage_permutation(forest, feats)
    forest_p = permute_forest_features(forest, remap)
    xp = torch.from_numpy(np.ascontiguousarray(x[:, perm])).to(dev)
    before = forest_staged_cuda.launches.value
    got = forest_staged_cuda.find_leaves_staged(xp, forest_p, hot, tile_points)
    assert forest_staged_cuda.launches.value == before + 1
    want_b, _ = forest_cuda.forest_predict(torch.from_numpy(x).to(dev), forest)
    want_plain = find_leaves_plain(xp, forest_p.records, forest_p.max_depth,
                                   forest_p.feat_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want_plain)
    assert torch.equal(got, want_b)


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
    x = torch.zeros((5, 10), device=dev)
    staged = forest_staged_cuda.find_leaves_staged
    for hot, tile_points in ((11, 32), (-1, 32), (10, 0), (10, 600)):
        with pytest.raises(ValueError):
            staged(x, forest, hot, tile_points)
    with pytest.raises(ValueError):
        staged(torch.zeros((5, 10)), forest, 10)  # CPU input
    with pytest.raises(ValueError):  # more shared memory than a block has
        staged(torch.zeros((5, 600), device=dev), forest, 600, 128)
    planar = patches_planar_cuda.extract_patches_planar
    depth = torch.ones((4, 4), device=dev)
    with pytest.raises(ValueError):
        planar(lab, depth.double(), 15, 5, 2)
    with pytest.raises(ValueError):  # image too small for a 20-pixel border
        planar(lab, depth, 20, 5, 2)
    with pytest.raises(ValueError):  # R = 60 needs too much shared memory
        planar(torch.zeros((40, 40, 3), dtype=torch.uint8, device=dev),
               depth, 5, 60, 2)


def _room_features(n, seed):
    """``[xyz * 0.5 ; rgb * 4]`` features of a room-scale coloured cloud."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3.0, -1.5, 0.5], [3.0, 1.5, 6.0], (n, 3))
    rgb = rng.uniform(0.0, 1.0, (n, 3))
    return torch.from_numpy(
        np.concatenate([pts * 0.5, rgb * 4.0], axis=1).astype(np.float32)
    )


@pytest.mark.parametrize("n,bucket", [(30000, 1 << 14), (2000, 1 << 9)])
def test_device_lattice_build_equals_cpu(dev, n, bucket):
    """Every output equal, including an overflowing build (2000 points in
    512 slots)."""
    feats = _room_features(n, n)
    got = build_lattice_device(feats.to(dev), bucket)
    want = build_lattice_device(feats, bucket)
    assert (int(want[-1]) > bucket) == (n == 2000)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


def test_mean_field_on_card_within_contract(dev):
    n, bucket, blocks = 30000, 1 << 14, (8, 9)
    feats = _room_features(n, 1)
    lattice = build_lattice_device(feats, bucket)[:8]
    rng = np.random.default_rng(2)
    energy = torch.from_numpy(
        (rng.normal(size=(sum(blocks), n)) * 3.0).astype(np.float32)
    )

    def marginals(device):
        lat = [t.to(device) for t in lattice]
        ones = torch.ones((1, n), device=device)
        norm = 1.0 / torch.sqrt(lattice_filter_t(ones, *lat, bucket)[0] + 1e-20)
        return potts_mean_field_multi_t(energy.to(device), *lat, norm, 10.0,
                                        blocks, bucket, 10)

    got = marginals(dev).cpu()
    want = marginals("cpu")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_accumulate_unaries_same_on_every_run(dev):
    """About 4800 pixels on each point: a scatter-add with float atomics
    would sum them in another order on each run."""
    rng = np.random.default_rng(5)
    h, w, c, n = 480, 640, 17, 64
    post = torch.from_numpy(rng.uniform(-5.0, 0.0, (h, w, c)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, n, (h, w)).astype(np.int32))
    start = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    runs = [accumulate_unaries(start.to(dev), post.to(dev), idx.to(dev), n)
            for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    torch.testing.assert_close(runs[0].cpu(),
                               accumulate_unaries(start, post, idx, n),
                               rtol=1e-6, atol=1e-5)


def test_dense_crf_map_same_on_every_run(dev):
    rng = np.random.default_rng(6)
    w, h, m = 80, 64, 6
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    unary = rng.normal(size=(w * h, m)).astype(np.float32)

    def crf(device):
        c = DenseCRF2D(w, h, m, device)
        c.set_unary_energy(unary)
        c.add_pairwise_gaussian(3, 3, PottsCompatibility(3))
        c.add_pairwise_bilateral(20, 20, 13, 13, 13, rgb, PottsCompatibility(10))
        return c

    on_card = crf(dev)
    labels = [on_card.map(5) for _ in range(3)]
    for lbl in labels[1:]:
        np.testing.assert_array_equal(lbl, labels[0])
    q = [on_card.inference(5) for _ in range(2)]
    assert q[0].device.type == "cuda" and torch.equal(q[0], q[1])
    torch.testing.assert_close(q[0].cpu(), crf("cpu").inference(5),
                               rtol=2e-4, atol=2e-5)
