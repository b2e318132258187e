"""PyTorch port vs JAX reference: the single-frame slice end to end.

Both packages run the same frames and the same trained-like forest at a
small size (40x48 frames, patch 15 -> 5, stride 2, 78 features). JAX takes
its Pallas descent in interpret mode (``use_pallas=True``); the port runs on
the CPU, so its kernel wrappers take their plain versions.
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.features.extractor import (
    FeatureConfig as JFeatureConfig,
    FeatureExtractor as JFeatureExtractor,
)
from rovinasemanticsegmentation_tpu.models.forest import random_forest
from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
    SingleFramePipeline as JSingleFramePipeline,
)
from rovinasemanticsegmentation_tpu.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.features.extractor import (
    FeatureConfig,
    FeatureExtractor,
)
from rovinasemanticsegmentation_tpu_torch.models.forest import forest_from_numpy
from rovinasemanticsegmentation_tpu_torch.ops.forest_cuda import forest_predict
from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
    SingleFramePipeline,
    posterior_maps,
)

from test_torch_ops import smooth_depth_mm

torch.set_num_threads(2)

H, W, STRIDE = 40, 48, 2
CFG = dict(patch_size=15, patch_size_reduce=5)


def _calib(shift=0.0):
    return Calibration(
        intrinsic=np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]),
        rotation=np.eye(3),
        translation=np.array([shift, 0.0, 0.5]),
    )


def _frame(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return rgb, smooth_depth_mm(rng, H, W)


@pytest.fixture(scope="module")
def setup():
    """Frames and a forest whose thresholds span each feature's range."""
    frames = [_frame(s) for s in (1, 2)]
    calibs = [_calib(0.0), _calib(0.1)]
    batch = JFeatureExtractor(JFeatureConfig(**CFG)).extract(
        frames[0][0], frames[0][1], calibs[0], STRIDE
    )
    feats = np.asarray(batch.features)[np.asarray(batch.mask)]
    rng = np.random.default_rng(0)
    forest = random_forest(rng, 3, 9, feats.shape[1], [3, 4], max_nodes=301)
    lo, hi = feats.min(axis=0), feats.max(axis=0)
    f = forest.split_feature
    forest.threshold[:] = rng.uniform(lo[f], hi[f]).astype(np.float32)
    return frames, calibs, forest


def _assert_close_results(got, want):
    for res_got, res_want in zip(got, want):
        for p_got, p_want in zip(res_got.posteriors, res_want.posteriors):
            np.testing.assert_allclose(
                p_got.numpy(), np.asarray(p_want), rtol=1e-5, atol=1e-4
            )
        for l_got, l_want in zip(res_got.labels, res_want.labels):
            agree = (l_got.numpy() == np.asarray(l_want)).mean()
            assert agree >= 0.999, f"labels agree on {agree:.4%} of pixels"


def test_run_matches_jax(setup):
    frames, calibs, forest = setup
    jp = JSingleFramePipeline(
        JFeatureConfig(**CFG), forest, STRIDE, use_pallas=True
    )
    tp = SingleFramePipeline(FeatureConfig(**CFG), forest, STRIDE, "cpu")
    rgb, depth = frames[0]
    _assert_close_results(
        [tp.run(rgb, depth, calibs[0])], [jp.run(rgb, depth, calibs[0])]
    )


def test_run_batch_stacked_matches_jax(setup):
    frames, calibs, forest = setup
    stacks = (
        np.stack([f[0] for f in frames]),
        np.stack([f[1] for f in frames]),
        np.stack([c.intrinsic_inverse for c in calibs]),
        np.stack([c.rotation for c in calibs]),
        np.stack([c.translation for c in calibs]),
    )
    jp = JSingleFramePipeline(
        JFeatureConfig(**CFG), forest, STRIDE, use_pallas=True
    )
    tp = SingleFramePipeline(FeatureConfig(**CFG), forest, STRIDE, "cpu")
    got = tp.run_batch_stacked(*stacks)
    _assert_close_results(got, jp.run_batch_stacked(*stacks))
    # The batch equals per-frame runs.
    for i, res in enumerate(got):
        single = tp.run(frames[i][0], frames[i][1], calibs[i])
        for a, b in zip(res.posteriors, single.posteriors):
            assert torch.equal(a, b)


def test_port_forest_on_jax_features_gives_equal_labels(setup):
    frames, calibs, forest = setup
    rgb, depth = frames[1]
    jp = JSingleFramePipeline(
        JFeatureConfig(**CFG), forest, STRIDE, use_pallas=True
    )
    want = jp.run(rgb, depth, calibs[1])
    batch = JFeatureExtractor(JFeatureConfig(**CFG)).extract(
        rgb, depth, calibs[1], STRIDE
    )
    tf = forest_from_numpy(forest, "cpu")
    _, post = forest_predict(torch.from_numpy(np.asarray(batch.features)), tf)
    _, labels = posterior_maps(
        post, torch.from_numpy(np.asarray(batch.mask)), batch.grid_shape,
        tf.class_counts, jp.fill_value, H, W,
    )
    for got, ref in zip(labels, want.labels):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_feature_extractor_matches_jax(setup):
    frames, calibs, _ = setup
    rgb, depth = frames[0]
    want = JFeatureExtractor(JFeatureConfig(**CFG)).extract(
        rgb, depth, calibs[0], STRIDE
    )
    got = FeatureExtractor(FeatureConfig(**CFG), "cpu").extract(
        rgb, depth, calibs[0], STRIDE
    )
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xs, np.asarray(want.xs))
    np.testing.assert_array_equal(got.ys, np.asarray(want.ys))
    assert got.grid_shape == want.grid_shape
    gf, wf = got.features.numpy(), np.asarray(want.features)
    n_patch = 5 * 5 * 3
    np.testing.assert_array_equal(gf[:, :n_patch + 1], wf[:, :n_patch + 1])
    np.testing.assert_allclose(gf[:, n_patch + 1], wf[:, n_patch + 1],
                               rtol=1e-6, atol=1e-6)  # height, as backproject
    np.testing.assert_allclose(gf[:, -1], wf[:, -1], atol=1e-4, rtol=0)
