"""The packed feature row (``ops/feature_rows.py``) on the CPU.

The frame path writes each frame's features as packed 8-bit rows (kernel A's
patch bytes, then the float32 tail) and the descent reads them there. Held
here, at strides 1, 2 and 5 with the patch, height and normal features each
on and off: unpacked rows equal ``extract_features``' float rows bit for
bit; the plain descent over packed rows equals the one over float rows; and
``SingleFramePipeline`` (which takes the packed path) equals the JAX
``_single_frame_impl``.
"""

import itertools

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.features.extractor import (
    FeatureConfig as JFeatureConfig,
)
from rovinasemanticsegmentation_tpu.models.forest import random_forest
from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
    SingleFramePipeline as JSingleFramePipeline,
)
from rovinasemanticsegmentation_tpu_torch.features.extractor import (
    FeatureConfig,
    extract_feature_rows,
    extract_features,
    feature_row_layout,
    patch_inputs,
)
from rovinasemanticsegmentation_tpu_torch.models.forest import (
    TreeArrays,
    build_forest,
    forest_from_numpy,
)
from rovinasemanticsegmentation_tpu_torch.ops import patches_cuda
from rovinasemanticsegmentation_tpu_torch.ops.feature_rows import (
    RowLayout,
    tail_view,
    unpack_rows,
)
from rovinasemanticsegmentation_tpu_torch.ops.forest_cuda import (
    forest_predict,
    forest_predict_rows,
)
from rovinasemanticsegmentation_tpu_torch.ops.patches import (
    extract_patches_plain,
)
from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
    SingleFramePipeline,
)
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration

from test_torch_ops import smooth_depth_mm

torch.set_num_threads(2)

H, W = 40, 48
PATCH = dict(patch_size=15, patch_size_reduce=5)
STRIDES = (1, 2, 5)
TOGGLES = list(itertools.product((True, False), repeat=3))  # patch, height, normal
FILL = 0xAB  # rows outside the frame's block must keep it


def _calib():
    return Calibration(
        intrinsic=np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]),
        rotation=np.eye(3),
        translation=np.array([0.05, 0.0, 0.5]),
    )


def _frame(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            smooth_depth_mm(rng, H, W))


def _inputs():
    rgb, depth = _frame()
    c = _calib()
    return (
        torch.from_numpy(rgb),
        torch.from_numpy(depth.astype(np.int32)),
        torch.from_numpy(c.intrinsic_inverse),
        torch.from_numpy(c.rotation),
        torch.from_numpy(c.translation),
    )


def _config(patch, height, normal):
    return FeatureConfig(**PATCH, use_color_patch=patch, use_height=height,
                         use_normal=normal)


def _rows_and_floats(stride, config, row0=3, extra=4):
    """(the frame's block of rows, the whole buffer, float features, mask)."""
    inputs = _inputs()
    feats, mask = extract_features(*inputs, config, stride)
    layout = feature_row_layout(config)
    p = feats.shape[0]
    rows = torch.full((row0 + p + extra, layout.row_bytes), FILL,
                      dtype=torch.uint8)
    got_mask = extract_feature_rows(*inputs, config, stride, rows, row0)
    assert torch.equal(got_mask, mask)
    return rows[row0 : row0 + p], rows, feats, mask


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("patch,height,normal", TOGGLES)
def test_packed_rows_unpack_to_float_features(stride, patch, height, normal):
    config = _config(patch, height, normal)
    layout = feature_row_layout(config)
    block, rows, feats, mask = _rows_and_floats(stride, config)
    assert layout.num_features == feats.shape[1]
    assert layout.row_bytes % 16 == 0
    assert torch.equal(_bits(unpack_rows(block, layout)), _bits(feats))
    assert not block[~mask].any(), "a masked row is not all zero bytes"
    k = layout.num_features - layout.patch_bytes
    assert not block[:, layout.patch_bytes : layout.tail_off].any()
    assert not tail_view(block, layout)[:, k:].any(), "padding not zero"
    assert (rows[:3] == FILL).all() and (rows[3 + block.shape[0] :] == FILL).all()


def _forest_on(feats, mask, seed=0):
    """A forest whose thresholds are feature values that occur, so that
    ``x == thr`` (and an integer patch value as threshold) happens."""
    rng = np.random.default_rng(seed)
    forest = random_forest(rng, 3, 8, feats.shape[1], [3, 4], max_nodes=201)
    seen = feats[mask].numpy()
    rows = rng.integers(0, seen.shape[0], forest.split_feature.shape)
    forest.threshold[:] = seen[rows, forest.split_feature]
    return forest_from_numpy(forest, "cpu")


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("patch,height,normal", TOGGLES)
def test_plain_descent_on_packed_rows_equals_float_rows(stride, patch, height,
                                                        normal):
    config = _config(patch, height, normal)
    layout = feature_row_layout(config)
    block, _, feats, mask = _rows_and_floats(stride, config)
    forest = _forest_on(feats, mask)
    want_leaves, want_post = forest_predict(feats, forest)
    leaves, post = forest_predict_rows(block, layout, forest)
    assert torch.equal(leaves, want_leaves)
    assert torch.equal(post, want_post)
    assert len(torch.unique(want_leaves)) > 10  # the forest splits the points


def _tiny_forest():
    """Root: patch byte 2 >= 100 (right) else leaf 1; node 2: tail feature 1
    >= -1e30, NaN goes left to leaf 3, a number right to leaf 4."""
    tree = TreeArrays(
        split_feature=np.array([2, 0, 7, 0, 0], np.int32),
        threshold=np.array([100.0, 0, -1e30, 0, 0], np.float32),
        left_child=np.array([1, 0, 3, 0, 0], np.int32),
        leaf_hist=np.arange(5 * 2, dtype=np.float32).reshape(5, 1, 2),
    )
    return forest_from_numpy(build_forest([tree], [2]), "cpu")


def test_packed_threshold_ties_and_nan_follow_ieee():
    layout = RowLayout.packed(patch_bytes=6, num_tail=2)  # features 0..7
    assert (layout.tail_off, layout.row_bytes) == (8, 16)
    rows = torch.zeros((4, layout.row_bytes), dtype=torch.uint8)
    rows[:, 2] = torch.tensor([99, 100, 100, 101], dtype=torch.uint8)
    tail = tail_view(rows, layout)
    tail[:, 1] = torch.tensor([0.0, float("nan"), 5.0, float("nan")])
    forest = _tiny_forest()
    leaves, post = forest_predict_rows(rows, layout, forest)
    # 99 < 100 -> leaf 1; 100 == thr goes right; NaN >= x is false -> left.
    assert leaves[:, 0].tolist() == [1, 3, 4, 3]
    want_leaves, want_post = forest_predict(unpack_rows(rows, layout), forest)
    assert torch.equal(leaves, want_leaves) and torch.equal(post, want_post)


def test_float_layout_is_the_float_matrix():
    x = torch.randn(5, 7)
    layout = RowLayout.float32(7)
    assert (layout.patch_bytes, layout.tail_off, layout.row_bytes) == (0, 0, 28)
    assert torch.equal(unpack_rows(x.view(torch.uint8), layout), x)


def test_patches_into_plain_writes_block_and_zero_tail():
    rgb, depth, *_ = _inputs()
    config = FeatureConfig(**PATCH)
    padded, dgrid = patch_inputs(rgb, depth, config, 2)
    want = extract_patches_plain(padded, dgrid, 15, 5, 2)
    p, pc = dgrid.numel(), 75
    rows = torch.full((p + 9, 96), FILL, dtype=torch.uint8)
    patches_cuda.extract_patches_into(padded, dgrid, 15, 5, 2, rows, 9)
    assert torch.equal(rows[9:, :pc], want.reshape(p, pc))
    assert not rows[9:, pc:].any() and (rows[:9] == FILL).all()
    with pytest.raises(ValueError, match="outside"):
        patches_cuda.extract_patches_into(padded, dgrid, 15, 5, 2, rows, 10)
    with pytest.raises(ValueError, match="cannot hold"):
        patches_cuda.extract_patches_into(
            padded, dgrid, 15, 5, 2, torch.zeros((p, 64), dtype=torch.uint8), 0)


def test_forest_predict_rows_checks_layout():
    forest = _tiny_forest()
    layout = RowLayout.packed(6, 2)
    with pytest.raises(ValueError, match="rows must be"):
        forest_predict_rows(torch.zeros((3, 32), dtype=torch.uint8), layout,
                            forest)
    with pytest.raises(ValueError, match="only"):
        forest_predict_rows(torch.zeros((3, 16), dtype=torch.uint8),
                            RowLayout.packed(6, 0), forest)


@pytest.fixture(scope="module")
def pipeline_forest():
    rng = np.random.default_rng(1)
    forest = random_forest(rng, 3, 9, 78, [3, 4], max_nodes=301)
    inputs = _inputs()
    feats, mask = extract_features(*inputs, FeatureConfig(**PATCH), 2)
    seen = feats[mask].numpy()
    pick = rng.integers(0, seen.shape[0], forest.split_feature.shape)
    forest.threshold[:] = seen[pick, forest.split_feature]
    return forest


@pytest.mark.parametrize("stride", STRIDES)
def test_pipeline_on_packed_rows_matches_jax(stride, pipeline_forest):
    rgb, depth = _frame()
    calib = _calib()
    jp = JSingleFramePipeline(JFeatureConfig(**PATCH), pipeline_forest, stride,
                              use_pallas=True)
    tp = SingleFramePipeline(FeatureConfig(**PATCH), pipeline_forest, stride,
                             "cpu")
    got, want = tp.run(rgb, depth, calib), jp.run(rgb, depth, calib)
    for p_got, p_want in zip(got.posteriors, want.posteriors):
        np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want),
                                   rtol=1e-5, atol=1e-4)
    for l_got, l_want in zip(got.labels, want.labels):
        agree = (l_got.numpy() == np.asarray(l_want)).mean()
        assert agree >= 0.999, f"labels agree on {agree:.4%} of pixels"
