"""PyTorch port vs JAX: boosting, the evaluation tools and ``cli.train``.

``BoostedForestTrainer`` on the same data draws the same resamples and grows
the same stumps and trees, so its tree weights, votes and files equal
JAX's; the tools give JAX's numbers on a JAX-trained forest and meet
``tests/test_boosting_tools.py``'s expectations; ``cli.train --device cpu``
writes the forest that the JAX ``cli.train`` writes, under the near-tie rule,
and ``cli.test_multi`` evaluates it as the JAX evaluation does. Here the
descent is ``forest_predict``'s plain version (CPU tensors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.cli.evaluate import (
    run_evaluation as jax_run_evaluation,
)
from rovinasemanticsegmentation_tpu.cli.train import main as jax_train_main
from rovinasemanticsegmentation_tpu.features.dataset import model_path_for
from rovinasemanticsegmentation_tpu.models import forest as jforest
from rovinasemanticsegmentation_tpu.models import tools as jtools
from rovinasemanticsegmentation_tpu.train import boosting as jboost
from rovinasemanticsegmentation_tpu.train import forest_trainer as J
from rovinasemanticsegmentation_tpu.utils.config import Config
from rovinasemanticsegmentation_tpu_torch.cli import test_multi as cli_test_multi
from rovinasemanticsegmentation_tpu_torch.cli import train as cli_train
from rovinasemanticsegmentation_tpu_torch.models import forest as tforest
from rovinasemanticsegmentation_tpu_torch.models import tools as ttools
from rovinasemanticsegmentation_tpu_torch.train import boosting as tboost
from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T

from forest_parity import assert_leaf_hist_close, assert_same_or_near_tie
from test_cli import build_dataset


@pytest.fixture(scope="module")
def separable():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(800, 6)).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int32) + 2 * (x[:, 2] > 0)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def boosted_pair(separable):
    x, y = separable
    kw = dict(num_trees=3, max_depth=4, min_split_examples=5, seed=2)
    jb = jboost.BoostedForestTrainer(J.TrainerConfig(**kw)).learn(
        x, y, class_counts=[4])
    tb = tboost.BoostedForestTrainer(T.TrainerConfig(**kw), "cpu").learn(
        x, y, class_counts=[4])
    return jb, tb


def test_boosted_trees_and_weights_equal_jax(boosted_pair):
    jb, tb = boosted_pair
    for f in ("split_feature", "threshold", "left_child"):
        np.testing.assert_array_equal(getattr(tb.forest, f),
                                      getattr(jb.forest, f))
    assert_leaf_hist_close(jb.forest, tb.forest)
    np.testing.assert_array_equal(tb.weights, jb.weights)
    assert (tb.weights > 0).all()


def test_boosted_votes_equal_jax(boosted_pair, separable):
    x, y = separable
    jb, tb = boosted_pair
    want = np.asarray(jb.class_log_posterior(jnp.asarray(x)))
    got = tb.class_log_posterior(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tb.classify(torch.from_numpy(x)),
                                  jb.classify(jnp.asarray(x)))
    assert (tb.classify(torch.from_numpy(x)) == y).mean() > 0.6


def test_boosted_files_load_in_both_packages(boosted_pair, separable, tmp_path):
    x, _ = separable
    jb, tb = boosted_pair
    tboost.save_boosted_forest(str(tmp_path / "t.dat"), tb)
    jboost.save_boosted_forest(str(tmp_path / "j.dat"), jb)
    read_by_jax = jboost.load_boosted_forest(str(tmp_path / "t.dat"))
    np.testing.assert_array_equal(read_by_jax.weights, tb.weights)
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        np.testing.assert_array_equal(getattr(read_by_jax.forest, f),
                                      getattr(tb.forest, f))
    loaded = tboost.load_boosted_forest(str(tmp_path / "j.dat"))
    np.testing.assert_array_equal(loaded.weights, jb.weights)
    np.testing.assert_array_equal(
        loaded.classify(torch.from_numpy(x)), jb.classify(jnp.asarray(x)))


def test_host_growth_boosts_like_jax(separable):
    """Depth-1 trees with host growth. (Depth-0 stumps of this data hold
    whole classes in a leaf, so two classes' weighted counts are equal in
    exact arithmetic and float32 rounding alone picks the vote: JAX sums the
    weight per example, the port multiplies the count once.)"""
    x, y = separable
    kw = dict(num_trees=5, max_depth=1, min_split_examples=5, seed=3,
              device_growth=False)
    jb = jboost.BoostedForestTrainer(J.TrainerConfig(**kw)).learn(
        x, y, class_counts=[4])
    tb = tboost.BoostedForestTrainer(T.TrainerConfig(**kw), "cpu").learn(
        x, y, class_counts=[4])
    np.testing.assert_array_equal(tb.weights, jb.weights)
    np.testing.assert_array_equal(tb.forest.threshold, jb.forest.threshold)


@pytest.fixture(scope="module")
def jax_forest(separable):
    x, y = separable
    return J.ForestTrainer(J.TrainerConfig(
        num_trees=3, max_depth=7, min_split_examples=5, seed=0)).learn(
        x, y, class_counts=[4], progress=False)


def test_tools_equal_jax(jax_forest, separable):
    x, y = separable
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    acc = ttools.accuracy(jax_forest, xt, y)
    assert acc == jtools.accuracy(jax_forest, xj, y)
    assert acc > 0.95
    cm = ttools.confusion_matrix(jax_forest, xt, y)
    np.testing.assert_array_equal(cm, jtools.confusion_matrix(jax_forest, xj, y))
    np.testing.assert_allclose(cm.sum(axis=1), 1.0, rtol=1e-6)
    assert np.trace(cm) / 4 == pytest.approx(acc, abs=0.05)
    corr = ttools.tree_correlation(jax_forest, xt)
    np.testing.assert_array_equal(corr, jtools.tree_correlation(jax_forest, xj))
    np.testing.assert_allclose(np.diag(corr), 1.0)
    assert (corr >= 0).all() and (corr <= 1).all() and corr[0, 1] == corr[1, 0]


def test_tools_on_a_port_trained_forest(separable):
    x, y = separable
    forest = T.ForestTrainer(T.TrainerConfig(
        num_trees=3, max_depth=7, min_split_examples=5, seed=0), "cpu").learn(
        x, y, class_counts=[4], progress=False)
    labels = ttools.ensemble_labels(forest, torch.from_numpy(x))
    assert labels.shape == (800,) and (labels == y).mean() > 0.95


@pytest.mark.parametrize("shared", [True, False])
def test_cli_train_writes_the_jax_forest(tmp_path, capsys, shared):
    path = build_dataset(tmp_path, names=("img0", "img1"), shared=shared)
    conf = Config(path)
    model = model_path_for(conf)
    # max_depth 7: JAX's fused refit misses depth-9 leaves at max_depth 8
    # (see test_torch_train_forest.py::test_refit_reaches_leaves_below_max_depth).
    jax_train_main(["--conf", path, "--max_depth", "7"])
    want = jforest.load_forest(model)
    jax_accs = jax_run_evaluation(conf, multi=shared, write_results=False)
    cli_train.main(["--conf", path, "--device", "cpu", "--max_depth", "7"])
    got = tforest.load_forest(model)
    assert got.class_counts == want.class_counts
    assert got.multi_label == want.multi_label == shared

    x, y, counts, _ = cli_train.extract_training_data(conf, "cpu", verbose=False)
    assert x.shape[1] == 78 and len(x) > 100
    cfg = T.TrainerConfig(**{**T.TrainerConfig.from_config(conf).__dict__,
                             "max_depth": 7})
    assert_same_or_near_tie(want, got, x.numpy(), y, cfg)
    assert_leaf_hist_close(want, got, rtol=1e-5)

    if shared:
        accs = cli_test_multi.main(["--conf", path, "--device", "cpu"])
        for a, b in zip(accs, jax_accs):
            np.testing.assert_array_equal(a.confusion, b.confusion)
    capsys.readouterr()
