"""The CUDA kernels against their plain PyTorch versions, the dense CRF's
mean field against the CPU's (its lattice build:
``test_torch_lattice_cuda.py``), and the run-to-run equality of the unary
accumulation and of ``DenseCRF.map``, on the card.

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
    usage_permutation_rows,
)
from rovinasemanticsegmentation_tpu_torch.models.lattice import (
    build_lattice_device,
    lattice_filter_t,
)
from rovinasemanticsegmentation_tpu_torch.ops import forest_cuda, patches_cuda
from rovinasemanticsegmentation_tpu_torch.ops import forest_staged_cuda
from rovinasemanticsegmentation_tpu_torch.ops import patches_separable_cuda
from rovinasemanticsegmentation_tpu_torch.ops.feature_rows import (
    RowLayout,
    permute_rows,
    tail_view,
    unpack_rows,
)
from rovinasemanticsegmentation_tpu_torch.ops.patches import (
    extract_patches_plain,
    extract_patches_separable_into_plain,
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


@pytest.mark.parametrize("stride,row0", [(1, 0), (2, 3), (5, 17)])
def test_patches_kernel_into_packed_rows(dev, stride, row0):
    """Kernel A writes a frame's patches into 384-byte packed rows from
    ``row0`` as its plain version does, and leaves the other rows alone."""
    rng = np.random.default_rng(10 + stride)
    h, w, b, r = 61, 80, 77, 11
    lab = torch.from_numpy(
        rng.integers(0, 256, (h + 2 * b, w + 2 * b, 3), dtype=np.uint8)
    ).to(dev)
    gh, gw = -(-h // stride), -(-w // stride)
    depth = rng.uniform(0.05, 9.0, (gh, gw)).astype(np.float32)
    depth[rng.random((gh, gw)) < 0.1] = 0.0
    depth_t = torch.from_numpy(depth).to(dev)
    rows = torch.full((row0 + gh * gw + 3, 384), 0xAB, dtype=torch.uint8,
                      device=dev)
    want = rows.clone()
    patches_cuda.extract_patches_into(lab, depth_t, b, r, stride, rows, row0)
    patches_cuda.extract_patches_into_plain(lab, depth_t, b, r, stride, want,
                                            row0)
    torch.cuda.synchronize()
    assert torch.equal(rows, want)


@pytest.mark.parametrize("points", [1, 63, 64, 65, 3001])
def test_forest_kernel_on_packed_rows(dev, points):
    """Kernel B on packed rows (patch bytes, float32 tail with NaNs) gives
    the plain version's leaves and posteriors on the same float rows, for
    full, partial and single tiles."""
    rng = np.random.default_rng(points)
    layout = RowLayout.packed(363, 3)
    forest_np = _random_forest(rng, 4, 8, 366, [8, 9])
    patch_split = forest_np.split_feature < 363
    forest_np.threshold[patch_split] = rng.integers(
        0, 256, int(patch_split.sum()))  # integer thresholds: x == thr occurs
    forest = forest_from_numpy(forest_np, dev)
    patch = rng.integers(0, 256, (points, 363), dtype=np.uint8)
    tail = rng.normal(size=(points, 3)).astype(np.float32)
    tail[::7, 1] = np.nan  # NaN goes left
    rows = torch.zeros((points, layout.row_bytes), dtype=torch.uint8)
    rows[:, :363] = torch.from_numpy(patch)
    tail_view(rows, layout)[:, :3] = torch.from_numpy(tail)
    feats = torch.from_numpy(
        np.concatenate([patch.astype(np.float32), tail], axis=1)).to(dev)
    leaves, post = forest_cuda.forest_predict_rows(rows.to(dev), layout, forest)
    want_leaves, want_post = forest_cuda.forest_predict_plain(feats, forest)
    torch.cuda.synchronize()
    assert torch.equal(leaves, want_leaves)
    assert torch.equal(post, want_post)


@pytest.mark.parametrize("stride,h,w,b,r", [
    (1, 40, 52, 15, 5), (2, 61, 80, 77, 11), (3, 50, 64, 77, 11),
    (5, 96, 128, 77, 11), (2, 33, 45, 21, 7),
])
def test_separable_patches_kernel_bit_exact(dev, stride, h, w, b, r):
    rng = np.random.default_rng(10 + stride)
    lab = torch.from_numpy(
        rng.integers(0, 256, (h + 2 * b, w + 2 * b, 3), dtype=np.uint8)
    ).to(dev)
    gh, gw = -(-h // stride), -(-w // stride)
    depth = rng.uniform(0.05, 9.0, (gh, gw)).astype(np.float32)
    depth[rng.random((gh, gw)) < 0.1] = 0.0
    depth_t = torch.from_numpy(depth).to(dev)
    before = patches_separable_cuda.launches.value
    got = patches_separable_cuda.extract_patches_separable(lab, depth_t, b, r, stride)
    assert patches_separable_cuda.launches.value == before + 1
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


@pytest.mark.parametrize("hot,tile_points,points", [
    (64, 64, 3001),  # the hot prefix and the tail: two copies per row
    (128, 64, 65),
    (0, 32, 3001),  # the tail only
    (363, 64, 3001),  # the whole row: one copy per tile
    (64, 7, 3001),  # 28 threads: warp 0 is partial
    (300, 16, 1),
])
def test_staged_descent_kernel_on_packed_rows(dev, hot, tile_points, points):
    """C'' on usage-permuted packed rows (patch bytes with integer
    thresholds, so x == thr occurs; a float tail with NaNs) gives kernel B's
    leaves on the unpermuted rows and the plain descent's."""
    rng = np.random.default_rng(hot + points)
    layout = RowLayout.packed(363, 3)
    forest_np = _random_forest(rng, 4, 10, 366, [8, 9])
    patch_split = forest_np.split_feature < 363
    forest_np.threshold[patch_split] = rng.integers(
        0, 256, int(patch_split.sum()))
    forest = forest_from_numpy(forest_np, dev)
    rows = torch.zeros((points, layout.row_bytes), dtype=torch.uint8)
    rows[:, :363] = torch.from_numpy(
        rng.integers(0, 256, (points, 363), dtype=np.uint8))
    tail = rng.normal(size=(points, 3)).astype(np.float32)
    tail[::7, 1] = np.nan  # NaN goes left
    tail_view(rows, layout)[:, :3] = torch.from_numpy(tail)
    rows = rows.to(dev)
    perm, remap = usage_permutation_rows(forest, layout)
    forest_p = permute_forest_features(forest, remap)
    rows_p = permute_rows(rows, layout, perm)
    before = forest_staged_cuda.launches.value
    got = forest_staged_cuda.find_leaves_staged_rows(rows_p, layout, forest_p,
                                                     hot, tile_points)
    assert forest_staged_cuda.launches.value == before + 1
    want_b, _ = forest_cuda.forest_predict_rows(rows, layout, forest)
    want_plain = find_leaves_plain(unpack_rows(rows_p, layout),
                                   forest_p.records, forest_p.max_depth,
                                   forest_p.feat_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want_plain)
    assert torch.equal(got, want_b)


def _blocks_over_cap(depth, patch, stride):
    """The blocks of D'' (4 x 8 grid points) whose image footprint exceeds
    the wrapper's cap, from the same float32 half-size division."""
    gh, gw = depth.shape
    d = np.maximum(depth, np.float32(1e-6))
    half = np.minimum(np.floor(np.float32(patch) / (np.float32(2) * d)), patch)
    half = np.where(depth > 0, half, -1).astype(np.int64)
    ty, tx = patches_separable_cuda.TILE_ROWS, patches_separable_cuda.TILE_COLS
    n = 0
    for y0 in range(0, gh, ty):
        for x0 in range(0, gw, tx):
            tile = half[y0:y0 + ty, x0:x0 + tx]
            hmax = int(tile.max())
            fh = (tile.shape[0] - 1) * stride + 2 * hmax + 1
            fw = (tile.shape[1] - 1) * stride + 2 * hmax + 1
            n += hmax >= 0 and 4 * fh * fw > patches_separable_cuda.FOOTPRINT_CAP
    return n


@pytest.mark.parametrize("stride,row0,row_bytes,near,far", [
    (1, 0, 384, 0.6, 9.0), (2, 3, 384, 0.6, 9.0), (5, 17, 384, 0.6, 9.0),
    (2, 1, 363, 0.6, 9.0),  # rows not in 16-byte units
    (2, 5, 384, 0.6, 1.1),  # every block reads its taps from device memory
    (2, 0, 384, 2.0, 9.0),  # every footprint fits
])
def test_separable_patches_kernel_into_packed_rows(dev, stride, row0, row_bytes,
                                                near, far):
    """D'' writes a frame's patches into rows from ``row0`` as kernel A and
    the plain versions do, leaves the other rows alone, and counts the blocks
    whose footprint exceeds the cap: at depths from 0.6 m to 9 m some blocks
    read their taps from shared memory and some from device memory."""
    rng = np.random.default_rng(20 + stride)
    h, w, b, r = 61, 80, 77, 11
    lab = torch.from_numpy(
        rng.integers(0, 256, (h + 2 * b, w + 2 * b, 3), dtype=np.uint8)
    ).to(dev)
    gh, gw = -(-h // stride), -(-w // stride)
    depth = rng.uniform(near, far, (gh, gw)).astype(np.float32)
    depth[rng.random((gh, gw)) < 0.1] = 0.0
    depth_t = torch.from_numpy(depth).to(dev)
    rows = torch.full((row0 + gh * gw + 3, row_bytes), 0xAB,
                      dtype=torch.uint8, device=dev)
    want_a, want_plain = rows.clone(), rows.clone()
    launch, over_cap = patches_separable_cuda.launcher(
        lab, depth_t, b, r, stride, rows, row0)
    before = patches_separable_cuda.launches.value
    launch()
    assert patches_separable_cuda.launches.value == before + 1
    patches_cuda.extract_patches_into(lab, depth_t, b, r, stride, want_a, row0)
    extract_patches_separable_into_plain(lab, depth_t, b, r, stride,
                                         want_plain, row0)
    torch.cuda.synchronize()
    assert torch.equal(rows, want_plain)
    assert torch.equal(rows, want_a)
    blocks = -(-gh // 4) * -(-gw // 8)
    n_over = _blocks_over_cap(depth, b, stride)
    assert int(over_cap.item()) == n_over
    if (near, far) == (0.6, 9.0):
        assert 0 < n_over < blocks
    else:
        assert n_over == (blocks if far < 2.0 else 0)


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
    separable = patches_separable_cuda.extract_patches_separable
    depth = torch.ones((4, 4), device=dev)
    with pytest.raises(ValueError):
        separable(lab, depth.double(), 15, 5, 2)
    with pytest.raises(ValueError):  # image too small for a 20-pixel border
        separable(lab, depth, 20, 5, 2)
    with pytest.raises(ValueError):  # R = 60 needs too much shared memory
        separable(torch.zeros((40, 40, 3), dtype=torch.uint8, device=dev),
               depth, 5, 60, 2)


def _room_features(n, seed):
    """``[xyz * 0.5 ; rgb * 4]`` features of a room-scale coloured cloud."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3.0, -1.5, 0.5], [3.0, 1.5, 6.0], (n, 3))
    rgb = rng.uniform(0.0, 1.0, (n, 3))
    return torch.from_numpy(
        np.concatenate([pts * 0.5, rgb * 4.0], axis=1).astype(np.float32)
    )


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


def _training_data(n=3000, d=20, seed=0):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, d)) * 8).astype(np.float32)
    y = np.stack([(x[:, 0] > 0) + 2 * (x[:, 3] > 2),
                  (x[:, 1] + x[:, 2] > 0).astype(np.int64)], 1).astype(np.int32)
    return x, y


@pytest.mark.parametrize("mode", [{}, {"split_bins": 64},
                                  {"device_growth": False},
                                  {"use_class_frequency": True}])
def test_trainer_on_card_equals_cpu(dev, mode):
    """Same draws, integer counts: the card grows the CPU's trees. Unweighted,
    the logs of the integer counts come from one table rounded on the host,
    so the objectives are equal and so are the trees. Weighted (single label,
    ``use_class_frequency``), both sides call ``torch.log2`` on the weighted
    counts, which CUDA does not round correctly: a tree may then differ from
    a near-tie on (``train/compare.py``), and the equal trees' leaf
    histograms agree as before."""
    import warnings

    from rovinasemanticsegmentation_tpu_torch.train import compare
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        ForestTrainer,
        TrainerConfig,
    )

    x, y = _training_data()
    counts = [4, 2]
    if mode.get("use_class_frequency"):
        y, counts = y[:, :1], [4]
    cfg = TrainerConfig(num_trees=2, max_depth=12, min_split_examples=10,
                        seed=3, **mode)
    on_card = ForestTrainer(cfg, dev).learn(torch.from_numpy(x).to(dev), y,
                                            class_counts=counts, progress=False)
    on_cpu = ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                             progress=False)
    if mode.get("use_class_frequency"):
        for what in compare.near_ties(on_card, on_cpu, x, y, cfg):
            warnings.warn(f"near-tie, trees differ from there: {what}")
    else:
        assert on_card.node_counts == on_cpu.node_counts
        for f in ("split_feature", "threshold", "left_child"):
            np.testing.assert_array_equal(getattr(on_card, f),
                                          getattr(on_cpu, f))
    for t in range(cfg.num_trees):
        if compare.first_difference(on_card, on_cpu, t) is None:
            np.testing.assert_allclose(on_card.leaf_hist[t],
                                       on_cpu.leaf_hist[t], rtol=1e-6,
                                       atol=2.4e-7)


@pytest.mark.parametrize("mode", [{}, {"split_bins": 64},
                                  {"use_class_frequency": True,
                                   "num_bootstrap_examples": 40}])
def test_fused_forest_on_card_equals_tree_loop(dev, mode):
    """On the card too, ``learn``'s one level loop grows each tree as the
    tree loop does, bit for bit; with class-frequency weights on 40-row
    bootstraps some trees come out unweighted, and on the card the two
    entropy forms round differently."""
    from rovinasemanticsegmentation_tpu_torch.models.forest import build_forest
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        ForestTrainer,
        TrainerConfig,
    )

    x, y = _training_data(seed=5)
    counts = [4, 2]
    if mode.get("use_class_frequency"):
        y, counts = np.where(np.arange(len(y))[:, None] % 50 == 0, y[:, :1], 0), [4]
    cfg = TrainerConfig(num_trees=6, max_depth=12, min_split_examples=4,
                        seed=6, **mode)
    trainer = ForestTrainer(cfg, dev)
    fused = trainer.learn(torch.from_numpy(x).to(dev), y, class_counts=counts,
                          progress=False)
    data = trainer.prepare(torch.from_numpy(x).to(dev), y, class_counts=counts)
    loop = build_forest([trainer.grow_tree(data, t) for t in range(6)], counts,
                        multi_label=data.multi_label)
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        np.testing.assert_array_equal(getattr(fused, f), getattr(loop, f))


def test_trainer_on_card_same_on_every_run(dev):
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        ForestTrainer,
        TrainerConfig,
    )

    x, y = _training_data(seed=1)
    xd = torch.from_numpy(x).to(dev)
    cfg = TrainerConfig(num_trees=3, max_depth=15, min_split_examples=5,
                        seed=4)
    a, b = (ForestTrainer(cfg, dev).learn(xd, y, class_counts=[4, 2],
                                          progress=False) for _ in range(2))
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_boosted_votes_on_card_equal_cpu(dev):
    from rovinasemanticsegmentation_tpu_torch.train.boosting import (
        BoostedForestTrainer,
    )
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        TrainerConfig,
    )

    x, y = _training_data(n=1500, seed=2)
    cfg = TrainerConfig(num_trees=3, max_depth=5, min_split_examples=5, seed=2)
    on_card = BoostedForestTrainer(cfg, dev).learn(x, y[:, 0], class_counts=[4])
    on_cpu = BoostedForestTrainer(cfg, "cpu").learn(x, y[:, 0], class_counts=[4])
    np.testing.assert_array_equal(on_card.weights, on_cpu.weights)
    before = forest_cuda.launches.value
    votes = on_card.class_log_posterior(torch.from_numpy(x).to(dev))
    assert forest_cuda.launches.value == before + 1
    np.testing.assert_array_equal(
        votes.cpu().numpy(),
        on_cpu.class_log_posterior(torch.from_numpy(x)).numpy())


def _lattice_gradients(device, feats, values, weights):
    """d/d(features, values) of sum(weights * K(values)) on the features'
    lattice (the device build on the card, the NumPy build on the CPU)."""
    from rovinasemanticsegmentation_tpu_torch.models.crf_learning import (
        geometry_for,
    )
    from rovinasemanticsegmentation_tpu_torch.models.lattice import (
        differentiable_barycentric,
        lattice_filter_diff,
    )

    geom = geometry_for(feats.to(device), torch.device(device), use_native=False)
    f = feats.to(device).clone().requires_grad_(True)
    v = values.to(device).clone().requires_grad_(True)
    bary = differentiable_barycentric(f, geom.rem0, geom.rank)
    out = lattice_filter_diff(v, bary, geom)
    (weights.to(device) * out).sum().backward()
    return f.grad, v.grad


def test_lattice_filter_gradients_repeat_on_card(dev):
    """The differentiable filter's gradients use sorted prefix sums and
    gathers only: the same bits on every run, and the CPU's within float32
    rounding of two summation orders."""
    feats = _room_features(20000, 3)
    rng = np.random.default_rng(4)
    values = torch.from_numpy(rng.normal(size=(20000, 4)).astype(np.float32))
    weights = torch.from_numpy(rng.normal(size=(20000, 4)).astype(np.float32))
    runs = [_lattice_gradients(dev, feats, values, weights) for _ in range(3)]
    for gf, gv in runs[1:]:
        assert torch.equal(gf, runs[0][0]) and torch.equal(gv, runs[0][1])
    want_f, want_v = _lattice_gradients("cpu", feats, values, weights)
    for got, want in zip(runs[0], (want_f, want_v)):
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err <= 1e-4


def test_kernel_learner_gradient_repeats_on_card(dev):
    from rovinasemanticsegmentation_tpu_torch.models.crf_learning import (
        FullKernelCrfLearner,
        intersection_over_union,
    )

    rng = np.random.default_rng(7)
    n, c = 12000, 4
    unary = rng.normal(size=(n, c)).astype(np.float32)
    base = _room_features(n, 8).numpy() * 3.0
    gt = rng.integers(-1, c, n).astype(np.int32)
    mat = np.eye(6) * 0.5
    mat[0, 3] = 0.05

    def learner(device):
        return FullKernelCrfLearner(unary, base, gt, 3, intersection_over_union,
                                    device=device)

    on_card = learner(dev)
    runs = [on_card._neg_obj_and_grad(1.5, mat) for _ in range(2)]
    assert runs[0][:2] == runs[1][:2] and np.array_equal(runs[0][2], runs[1][2])
    v, gw, gm = learner("cpu")._neg_obj_and_grad(1.5, mat)
    assert runs[0][0] == pytest.approx(v, rel=1e-4)
    # The lattice follows the transformed features' last bit, which the two
    # sides' float32 matmuls round differently (chip_smoke.py phase 13).
    g_card = np.append(runs[0][2].ravel(), runs[0][1])
    g_cpu = np.append(gm.ravel(), gw)
    assert np.abs(g_card - g_cpu).max() <= 5e-3 * np.abs(g_cpu).max()


def _vga_points():
    from rovinasemanticsegmentation_tpu_torch.ops.geometry import backproject
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        make_bench_forest as recipe,
    )

    _, depth, _ = next(recipe.frames())
    return backproject(torch.from_numpy(depth.astype(np.int32)),
                       recipe.calibration().intrinsic_inverse, np.eye(3),
                       np.zeros(3), 0.5, 15.0)


@pytest.mark.parametrize("stride,size", [(None, 10.0), (2, 10.0), (5, 10.0),
                                         (2, 6.5)])
def test_normals_on_card_match_cpu(dev, stride, size):
    """Float64 integral images: masks equal, angles within 2 float32 ulps."""
    from rovinasemanticsegmentation_tpu_torch.ops import normals

    pts = _vga_points()

    def angles(p):
        if stride is None:
            return normals.normal_angles(p, normal_smoothing_size=size)
        return normals.normal_angles_grid(p, stride, normal_smoothing_size=size)

    got, want = angles(pts.to(dev)).cpu(), angles(pts)
    assert torch.equal(got == -2.0, want == -2.0)
    valid = want != -2.0
    assert valid.sum() > 1000
    assert (got[valid] - want[valid]).abs().max() <= 2.4e-7


@pytest.mark.parametrize("saturation", [None, 10.0])
def test_chamfer_on_card_equals_cpu(dev, saturation):
    from rovinasemanticsegmentation_tpu_torch.ops import normals

    rng = np.random.default_rng(9)
    change = torch.from_numpy(rng.random((480, 640)) < 0.003)
    got = normals.chamfer_distance_map(change.to(dev), saturation)
    assert torch.equal(got.cpu(), normals.chamfer_distance_map(change, saturation))


@pytest.mark.parametrize("out", [(11, 11), (21, 27), (240, 320)])
def test_resize_u8_on_card_equals_cpu(dev, out):
    from rovinasemanticsegmentation_tpu_torch.ops.resize import resize_bilinear_u8

    img = torch.from_numpy(
        np.random.default_rng(10).integers(0, 256, (480, 640, 3), dtype=np.uint8))
    got = resize_bilinear_u8(img.to(dev), *out)
    assert torch.equal(got.cpu(), resize_bilinear_u8(img, *out))


def test_dryrun_on_card(dev):
    """The multi-rank dry run with 8 ranks sharing the card over gloo."""
    from rovinasemanticsegmentation_tpu_torch.parallel.dryrun import dryrun

    dryrun(8, "cuda")


def test_tree_parallel_on_card_equals_sequential(dev):
    from rovinasemanticsegmentation_tpu_torch.parallel.tree_parallel import (
        learn_forest_parallel,
    )
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        ForestTrainer,
        TrainerConfig,
    )

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2000, 16)).astype(np.float32)
    y = ((x[:, 0] > 0) + 2 * (x[:, 3] > 0.5)).astype(np.int32)
    cfg = TrainerConfig(num_trees=4, max_depth=8, min_split_examples=5, seed=3)
    par = learn_forest_parallel(cfg, x, y, class_counts=[4],
                                devices=[dev, dev, dev])
    seq = ForestTrainer(cfg, dev).learn(x, y, class_counts=[4], progress=False)
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        np.testing.assert_array_equal(getattr(par, f), getattr(seq, f))
