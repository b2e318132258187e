"""PyTorch port: the fused forest, every tree of a forest in one level loop.

``ForestTrainer.learn`` without a checkpoint grows all trees in one level
loop and refits them in one descent, as JAX's fused forest
(``grow_forest_device``) does. Its trees are bit-equal to the port's tree
loop (``grow_tree`` per tree) in every mode, host growth included; against JAX's fused ``learn``
they follow the parity rules of ``tests/forest_parity.py`` (equal except
near-ties, leaf histograms within rtol 1e-5); at ``max_depth`` 8 they are
held against JAX's per-tree path, whose refit reaches the leaves at depth 9
that JAX's fused refit misses. The dry run's part 4 runs here at two trees.
"""

import warnings

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.train import forest_trainer as J
from rovinasemanticsegmentation_tpu_torch.models.forest import build_forest
from rovinasemanticsegmentation_tpu_torch.parallel import dryrun
from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T

from forest_parity import assert_leaf_hist_close, assert_same_or_near_tie
from test_torch_train_forest import MODES, _assert_forests_equal, _data

CASES = {
    "exact-single": (0, False, dict(device_growth=True)),
    "exact-multi": (1, True, dict(device_growth=True)),
    "binned-single": (2, False, dict(device_growth=True, split_bins=16)),
    "binned-multi": (3, True, dict(device_growth=True, split_bins=16)),
    "class-frequency": (4, False, dict(use_class_frequency=True)),
    "class-frequency-binned": (5, False, dict(use_class_frequency=True,
                                              split_bins=16)),
    "no-bootstrap": (6, True, dict(use_bootstrap=False)),
    "uneven-depths": (7, False, dict(max_depth=30, min_split_examples=2)),
    "host-growth": (8, True, dict(device_growth=False)),
}


def _loop_and_fused(x, y, counts, cfg):
    """(the tree loop's forest, the fused one) on the CPU."""
    trainer = T.ForestTrainer(cfg, "cpu")
    data = trainer.prepare(x, y, class_counts=counts)
    loop = [trainer.grow_tree(data, t) for t in range(cfg.num_trees)]
    fused = trainer.grow_trees(data, range(cfg.num_trees))
    return (build_forest(loop, counts, multi_label=data.multi_label),
            build_forest(fused, counts, multi_label=data.multi_label))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_forest_equals_tree_loop(case):
    seed, multi, kw = CASES[case]
    x, y, counts = _data(seed, multi)
    cfg = T.TrainerConfig(**{"num_trees": 4, "max_depth": 7,
                             "min_split_examples": 5, "seed": seed, **kw})
    loop, fused = _loop_and_fused(x, y, counts, cfg)
    _assert_forests_equal(fused, loop)
    learned = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                                progress=False)
    _assert_forests_equal(learned, loop)
    if case == "uneven-depths":
        depths = {int(np.max(d)) for d in _depths(fused)}
        assert len(depths) > 1, depths


def _depths(forest):
    out = []
    for t in range(forest.num_trees):
        lc = forest.tree_view(t).left_child
        depth = np.zeros(len(lc), np.int64)
        for v in np.nonzero(lc)[0]:
            depth[lc[v]] = depth[lc[v] + 1] = depth[v] + 1
        out.append(depth)
    return out


def test_fused_forest_with_a_tree_of_all_ones_weights():
    """Class-frequency weights of a bootstrap sample of one class are all 1,
    so that tree takes the unweighted search; the fused forest keeps each
    tree's form. Bootstraps of 12 rows of a set that is 92% class 0 give
    such a tree beside weighted ones."""
    rng = np.random.default_rng(0)
    n = 400
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.where(rng.random(n) < 0.92, 0, 1 + (x[:, 0] > 0)).astype(np.int32)
    for seed in range(50):
        cfg = T.TrainerConfig(num_trees=4, max_depth=6, min_split_examples=2,
                              num_bootstrap_examples=12,
                              use_class_frequency=True, seed=seed)
        weighted = []
        for t in range(cfg.num_trees):
            idx = np.random.default_rng((seed, t)).integers(0, n, size=12)
            w = T._tree_class_weights(cfg, y[idx, None], 12, 3)
            weighted.append(T._weights_or_none(w) is not None)
        if 0 < sum(weighted) < cfg.num_trees:
            break
    else:
        pytest.fail("no seed gives a forest with an all-ones tree")
    loop, fused = _loop_and_fused(x, y[:, None], [3], cfg)
    _assert_forests_equal(fused, loop)
    assert max(loop.node_counts) > 1


@pytest.mark.parametrize("binned", [False, True], ids=["exact", "binned"])
def test_level_loop_keeps_each_trees_entropy(binned, monkeypatch):
    """Two trees, one unweighted and one weighted, both searching, in one
    level loop: each equals the tree grown alone. The CPU's float32 ``log2``
    of an integer is the log table's, so the unweighted form and the
    weighted one with weights of 1 agree here; on the card they need not.
    The table is perturbed so that the two forms grow different trees."""
    table = T._log2_table
    monkeypatch.setattr(T, "_log2_table", lambda n, device: table(n, device)
                        + 0.05 * torch.sin(torch.arange(n + 1.0, device=device)))
    x, y, counts = _data(9, False)
    cfg = T.TrainerConfig(max_depth=6, min_split_examples=5,
                          split_bins=16 if binned else 0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    xb = bnd = None
    if binned:
        xb, bnd = T.build_feature_bins(xt, num_bins=16)
    rng = np.random.default_rng(1)
    rows = [torch.from_numpy(rng.integers(0, len(x), len(x))) for _ in range(2)]
    weights = [None, torch.tensor([1.0, 3.5, 0.5, 2.0])]
    seeds = [11, 12]

    def grow(ts):
        draws = T.device_draws([seeds[t] for t in ts], 1, x.shape[1], 4, "cpu")
        return T._grow(xt, yt, [rows[t] for t in ts], draws,
                       [weights[t] for t in ts], cfg, 4, xb=xb, boundaries=bnd)

    both = grow([0, 1])
    for t in range(2):
        alone = grow([t])[0]
        for a, b in zip(both[t].numpy(), alone.numpy()):
            np.testing.assert_array_equal(a, b)
        assert alone.num_nodes > 7
    weights[0] = torch.ones(4)
    assert not all(np.array_equal(a, b) for a, b in zip(
        grow([0])[0].numpy(), both[0].numpy()))


@pytest.mark.parametrize("binned", [False, True], ids=["exact", "binned"])
def test_searches_in_chunks_of_slots_grow_the_same_forest(binned, monkeypatch):
    """A level's K slots searched a few at a time (the chunk bounds that
    keep a forest's level stream in memory) give the same forest."""
    x, y, counts = _data(11, True)
    cfg = T.TrainerConfig(num_trees=3, max_depth=6, min_split_examples=5,
                          split_bins=16 if binned else 0)
    whole = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                              progress=False)
    monkeypatch.setattr(T, "_EXACT_CHUNK", 4 * 3 * len(x) * 3)  # 3 slots
    monkeypatch.setattr(T, "_BINNED_CHUNK", 1)  # 1 slot
    chunked = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                                progress=False)
    _assert_forests_equal(chunked, whole)


def test_one_level_loop_for_the_whole_forest(monkeypatch):
    """The fused forest draws (and reads back its split counts) once per
    level of the forest: as many levels as its deepest tree, not their sum."""
    calls = []
    device_draws = T.device_draws

    def counted(*args):
        draw = device_draws(*args)

        def wrapped(depth, live):
            calls.append(len(live))
            return draw(depth, live)

        return wrapped

    monkeypatch.setattr(T, "device_draws", counted)
    x, y, counts = _data(7, False)
    cfg = T.TrainerConfig(num_trees=4, max_depth=30, min_split_examples=2)
    trainer = T.ForestTrainer(cfg, "cpu")
    data = trainer.prepare(x, y, class_counts=counts)
    per_tree = []
    for t in range(cfg.num_trees):
        calls.clear()
        trainer.grow_tree(data, t)
        per_tree.append(len(calls))
    calls.clear()
    trainer.grow_trees(data, range(cfg.num_trees))
    assert len(calls) == max(per_tree) < sum(per_tree)
    assert calls[0] == cfg.num_trees and calls[-1] < cfg.num_trees


@pytest.mark.parametrize("mode", ["exact", "binned"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_fused_forest_follows_jax_fused_forest(mode, multi):
    x, y, counts = _data(10 + multi, multi)
    kw = dict(num_trees=4, max_depth=7, min_split_examples=5, seed=3,
              **MODES[mode])
    cfg = T.TrainerConfig(**kw)
    fj = J.ForestTrainer(J.TrainerConfig(**kw)).learn(
        x, y, class_counts=counts, progress=False)
    ft = T.ForestTrainer(cfg, "cpu").learn(x, y, class_counts=counts,
                                           progress=False)
    for what in assert_same_or_near_tie(fj, ft, x, y, cfg):
        warnings.warn(f"near-tie, trees differ from there: {what}")
    assert_leaf_hist_close(fj, ft, rtol=1e-5)


def test_fused_refit_reaches_depth_nine_leaves(tmp_path):
    """At max_depth 8 the fused refit descends each tree's own depth, so it
    equals JAX's per-tree path (reached with a checkpoint), whose refit does
    too; JAX's fused refit would stop at depth 8."""
    x, y, counts = _data(3, False, n=600)
    kw = dict(num_trees=3, max_depth=8, min_split_examples=2, seed=0)
    ft = T.ForestTrainer(T.TrainerConfig(**kw), "cpu").learn(
        x, y, class_counts=counts, progress=False)
    assert ft.max_depth == 9
    fj = J.ForestTrainer(J.TrainerConfig(**kw)).learn(
        x, y, class_counts=counts, progress=False,
        checkpoint_path=str(tmp_path / "jax.npz"))
    assert_same_or_near_tie(fj, ft, x, y, T.TrainerConfig(**kw))
    assert_leaf_hist_close(fj, ft)


def test_dryrun_part_4_on_the_cpu():
    inp = dryrun.crf_inputs()
    fused = dryrun.check_fused_forest(inp["xs"], inp["ys"], "cpu")
    assert fused.num_trees == 2
