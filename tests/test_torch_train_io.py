"""PyTorch port: the trainer's own contracts and its files.

The trainer's tree loop equals per-tree growth; a resumed run equals an
uninterrupted one (and the reference package resumes the port's
checkpoint); the trainer takes device tensors; forest files and npz
checkpoints of either package load in the other with equal arrays;
``random_forest`` draws as the reference package's does; the training
augmentations equal JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.models import forest as jforest
from rovinasemanticsegmentation_tpu.ops import color as jcolor
from rovinasemanticsegmentation_tpu.train import forest_trainer as J
from rovinasemanticsegmentation_tpu.utils import checkpoint as jckpt
from rovinasemanticsegmentation_tpu_torch.models import forest as tforest
from rovinasemanticsegmentation_tpu_torch.ops import color as tcolor
from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T
from rovinasemanticsegmentation_tpu_torch.utils import checkpoint as tckpt

from test_torch_train_forest import (
    MODES,
    _assert_forests_equal,
    _assert_same_structure,
    _data,
)


@pytest.mark.parametrize("mode", ["exact", "binned"])
def test_forest_equals_per_tree_growth(mode, tmp_path):
    """``learn``'s tree loop, with and without checkpoints, equals each tree
    grown alone by ``grow_tree_device`` from its bootstrap sample and seed
    (``default_rng((seed, t))``: indices first, then the seed, as JAX draws
    them) and refit on the full data."""
    x, y, counts = _data(5, True)
    cfg = T.TrainerConfig(num_trees=3, max_depth=6, min_split_examples=5,
                          seed=9, **MODES[mode])
    forest = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                               progress=False)
    checkpointed = T.ForestTrainer(cfg, "cpu").learn(
        x, y, class_counts=counts, progress=False,
        checkpoint_path=str(tmp_path / "c.npz"))
    _assert_forests_equal(forest, checkpointed)

    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    xb = bnd = None
    if cfg.split_bins:
        xb, bnd = T.build_feature_bins(xt, num_bins=cfg.split_bins)
    freqs = torch.zeros(2, max(counts))
    for l, c in enumerate(counts):
        freqs[l, :c] = torch.from_numpy(T._inverted_class_frequency(y[:, l], c))
    for t in range(cfg.num_trees):
        rng = np.random.default_rng((cfg.seed, t))
        idx = torch.from_numpy(T._bootstrap(rng, cfg, len(x), len(x)))
        cw = T._weights_or_none(
            T._tree_class_weights(cfg, y[idx.numpy()], len(idx), max(counts)))
        tables = T.grow_tree_device(
            xt[idx], yt[idx], T._tree_seed(rng), cw, cfg, max(counts),
            xb=None if xb is None else xb[idx], boundaries=bnd)
        sf, th, lc, _ = tables.numpy()
        raw = T._leaf_histograms_all(xt, yt, freqs, tables, max(counts))
        view = forest.tree_view(t)
        np.testing.assert_array_equal(view.split_feature, sf)
        np.testing.assert_array_equal(view.threshold, th)
        np.testing.assert_array_equal(view.left_child, lc)
        np.testing.assert_array_equal(
            view.leaf_hist,
            T._smooth_histograms(raw.numpy(), lc, counts, cfg.smoothing))


@pytest.mark.parametrize("device_growth", [False, True])
def test_resume_equals_uninterrupted_run(device_growth, tmp_path):
    x, y, counts = _data(2, False)
    cfg = T.TrainerConfig(num_trees=3, max_depth=5, min_split_examples=5,
                          seed=7, device_growth=device_growth)
    ckpt = str(tmp_path / "train.npz")
    full = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                             progress=False)
    one = T.TrainerConfig(**{**cfg.__dict__, "num_trees": 1})
    T.ForestTrainer(one, "cpu").learn(x, y, class_counts=counts,
                                      progress=False, checkpoint_path=ckpt)
    meta, partial = tckpt.TrainingCheckpoint.load(ckpt)
    assert meta.completed_trees == 1 and partial.num_trees == 1
    resumed = T.ForestTrainer(cfg, "cpu").learn(
        x, y, class_counts=counts, progress=False, checkpoint_path=ckpt)
    _assert_forests_equal(resumed, full)
    # The reference package resumes the port's checkpoint to the same forest.
    fj = J.ForestTrainer(J.TrainerConfig(**cfg.__dict__)).learn(
        x, y, class_counts=counts, progress=False,
        checkpoint_path=str(tmp_path / "train.npz"))
    _assert_same_structure(fj, full)


def test_trainer_takes_device_tensors_and_refuses_a_missing_card():
    x, y, counts = _data(0, False, n=200)
    cfg = T.TrainerConfig(num_trees=1, max_depth=4, min_split_examples=5)
    a = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                          progress=False)
    b = T.ForestTrainer(cfg, "cpu").learn(torch.from_numpy(x),
                                          torch.from_numpy(y),
                                          class_counts=counts, progress=False)
    _assert_forests_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.ForestTrainer(cfg)


@pytest.mark.parametrize("multi", [False, True])
def test_forest_files_load_in_both_packages(multi, tmp_path):
    x, y, counts = _data(1, multi)
    cfg = T.TrainerConfig(num_trees=2, max_depth=5, min_split_examples=5)
    ft = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                           progress=False)
    tforest.save_forest(str(tmp_path / "port.dat"), ft)
    for use_native in (True, False):
        _assert_forests_equal(
            jforest.load_forest(str(tmp_path / "port.dat"), use_native=use_native),
            ft)
    fj = J.ForestTrainer(J.TrainerConfig(**cfg.__dict__)).learn(
        x, y, class_counts=counts, progress=False)
    jforest.save_forest(str(tmp_path / "jax.dat"), fj)
    _assert_forests_equal(tforest.load_forest(str(tmp_path / "jax.dat")), fj)
    tforest.save_forest(str(tmp_path / "again.dat"), fj)
    assert (tmp_path / "again.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


def test_checkpoint_converters_match(tmp_path):
    f = tforest.random_forest(np.random.default_rng(3), 2, 4, 20, [3, 2])
    tckpt.save_forest_npz(str(tmp_path / "f.npz"), f)
    _assert_forests_equal(jckpt.load_forest_npz(str(tmp_path / "f.npz")), f)
    back = tckpt.convert_npz_to_reference(str(tmp_path / "f.npz"),
                                          str(tmp_path / "f.dat"))
    _assert_forests_equal(jforest.load_forest(str(tmp_path / "f.dat")), back)
    again = tckpt.convert_reference_to_npz(str(tmp_path / "f.dat"),
                                           str(tmp_path / "g.npz"))
    _assert_forests_equal(tckpt.load_forest_npz(str(tmp_path / "g.npz")), again)


@pytest.mark.parametrize("max_nodes", [None, 40])
def test_random_forest_draws_like_jax(max_nodes):
    args = (3, 5, 30, [4, 3])
    a = tforest.random_forest(np.random.default_rng(8), *args, max_nodes=max_nodes)
    b = jforest.random_forest(np.random.default_rng(8), *args, max_nodes=max_nodes)
    _assert_forests_equal(a, b)
    assert a.max_depth == b.max_depth


def test_augmentations_equal():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    depth = rng.integers(0, 9000, (6, 9)).astype(np.int32)
    for delta in (-20, 0, 20, 300):
        np.testing.assert_array_equal(
            tcolor.adjust_brightness(torch.from_numpy(rgb), delta).numpy(),
            np.asarray(jcolor.adjust_brightness(jnp.asarray(rgb), delta)))
    for img in (rgb, depth):
        np.testing.assert_array_equal(tcolor.hflip(torch.from_numpy(img)).numpy(),
                                      np.asarray(jcolor.hflip(jnp.asarray(img))))


def test_near_tie_rule_accepts_equal_partitions_and_rejects_other_splits():
    """``train/compare.py``: a root threshold moved inside the same gap of
    the sorted values is a tie (same partition, same objective); the root
    split on another feature is not."""
    from dataclasses import replace

    from rovinasemanticsegmentation_tpu_torch.train import compare

    x, y, counts = _data(1, True)
    cfg = T.TrainerConfig(num_trees=1, max_depth=4, min_split_examples=5,
                          seed=2)
    forest = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                               progress=False)
    assert compare.near_ties(forest, forest, x, y, cfg) == []
    f, thr = int(forest.split_feature[0, 0]), float(forest.threshold[0, 0])
    col = np.sort(x[:, f])
    below = col[col < thr].max()
    moved = forest.threshold.copy()
    moved[0, 0] = np.float32(below + 0.25 * (thr - below))
    tie = replace(forest, threshold=moved)
    (what,) = compare.near_ties(forest, tie, x, y, cfg)
    assert "0.00 float32 ulp apart" in what
    other = forest.split_feature.copy()
    other[0, 0] = (f + 1) % x.shape[1]
    with pytest.raises(AssertionError, match="not a near-tie"):
        compare.near_ties(forest, replace(forest, split_feature=other), x, y,
                          cfg)
