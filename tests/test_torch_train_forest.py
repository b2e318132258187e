"""PyTorch port vs JAX: whole forests trained on the same data.

The same numpy data goes through the JAX ``ForestTrainer`` and the port's
(on the CPU) in host growth, device growth with the exact search, and device
growth with the binned search, single- and multi-label. Trees are equal
(``split_feature``, ``left_child``, ``threshold``) except where a node's two
best candidates are a near-tie (``tests/forest_parity.py``: within 8 float32
ulp in float64, reported as a warning), and the leaf histograms agree
within rtol 1e-5.
"""

import warnings

import numpy as np
import pytest

from rovinasemanticsegmentation_tpu.train import forest_trainer as J
from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T

from forest_parity import assert_leaf_hist_close, assert_same_or_near_tie

MODES = {
    "host": dict(device_growth=False),
    "exact": dict(device_growth=True),
    "binned": dict(device_growth=True, split_bins=16),
}


def _data(seed, multi, n=400, d=10):
    """Two informative features, label noise, and (odd seeds) small-integer
    values with many exact ties, as the Lab patch bytes have."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if seed % 2:
        x = np.round(x * 3).astype(np.float32)
    y0 = (x[:, 0] > 0) + 2 * (x[:, 3] > 0.3)
    y0 = np.where(rng.random(n) < 0.15, rng.integers(0, 4, n), y0)
    if not multi:
        return x, y0[:, None].astype(np.int32), [4]
    y1 = ((x[:, 1] + x[:, 2]) > 0).astype(np.int32) + (x[:, 5] > 1)
    return x, np.stack([y0, y1], 1).astype(np.int32), [4, 3]


def _both(x, y, counts, **kw):
    cfg_t = T.TrainerConfig(**kw)
    fj = J.ForestTrainer(J.TrainerConfig(**kw)).learn(
        x, y, class_counts=counts, progress=False)
    ft = T.ForestTrainer(cfg_t, "cpu").learn(x, y, class_counts=counts,
                                             progress=False)
    return fj, ft, cfg_t


def _assert_forests_equal(a, b):
    assert a.node_counts == b.node_counts
    assert a.class_counts == b.class_counts and a.multi_label == b.multi_label
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forest_equals_jax(mode, multi, seed):
    x, y, counts = _data(seed, multi)
    fj, ft, cfg = _both(x, y, counts, num_trees=2, max_depth=7,
                        min_split_examples=5, seed=seed, **MODES[mode])
    for what in assert_same_or_near_tie(fj, ft, x, y, cfg):
        warnings.warn(f"near-tie, trees differ from there: {what}")
    assert_leaf_hist_close(fj, ft, rtol=1e-5)
    assert ft.max_depth <= 8 and ft.multi_label == multi


def test_class_frequency_weighted_forest_equals_jax():
    x, y, counts = _data(4, False)
    fj, ft, cfg = _both(x, y, counts, num_trees=2, max_depth=6,
                        min_split_examples=5, seed=4, use_class_frequency=True)
    assert_same_or_near_tie(fj, ft, x, y, cfg)
    assert_leaf_hist_close(fj, ft)


def test_refit_reaches_leaves_below_max_depth(tmp_path):
    """Leaves sit at depth max_depth + 1. The port's refit descends the
    tree's own depth; JAX's fused refit descends max_depth rounded up to a
    multiple of 8, which misses them when max_depth is one (a fault of the
    reference package), so the port is held against JAX's per-tree path."""
    x, y, counts = _data(3, False, n=600)
    kw = dict(num_trees=1, max_depth=8, min_split_examples=2, seed=0)
    ft = T.ForestTrainer(T.TrainerConfig(**kw), "cpu").learn(
        x, y, class_counts=counts, progress=False)
    assert ft.max_depth == 9
    fj = J.ForestTrainer(J.TrainerConfig(**kw)).learn(
        x, y, class_counts=counts, progress=False,
        checkpoint_path=str(tmp_path / "jax.npz"))
    _assert_same_structure(fj, ft)
    assert_leaf_hist_close(fj, ft)


def _assert_same_structure(a, b):
    assert a.node_counts == b.node_counts
    for f in ("split_feature", "threshold", "left_child"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


