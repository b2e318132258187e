"""The published training recipe: the port against the benchmark's plain
reference (``port_bench/reference/train.py``), and the train CLI against
the function it calls.

On seeded tiny sets on the CPU: the 6 augmented variants of two 61x83
images at stride 5 give the reference's rows and labels bit for bit; the
forest's trees, grown together by ``ForestTrainer.learn``, equal the
reference's trees grown alone node for node, with leaf histograms within
1e-6 (4 trees at depth 8 on the extracted rows, and a multi-label case at
depth 30 on 2000 rows with tied values); the reference's copy of the
threefry stream draws ``train/random.py``'s numbers; ``tree_mismatch``
counts each kind of difference; and ``cli.train`` writes the rows and the
forest of ``extract_training_rows`` and ``learn`` on a tiny on-disk
dataset.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from port_bench.drivers import train as bench_train
from port_bench.reference import frame as ref_frame
from port_bench.reference import train as ref_train
from rovinasemanticsegmentation_tpu_torch.cli import train as cli_train
from rovinasemanticsegmentation_tpu_torch.features.dataset import (
    DatasetSample, RovinaDataset, layer_prefixes_for, model_path_for)
from rovinasemanticsegmentation_tpu_torch.features.extractor import (
    FeatureConfig, FeatureExtractor)
from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
from rovinasemanticsegmentation_tpu_torch.train import random as jrandom
from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
    ForestTrainer, TrainerConfig, device_draws)
from rovinasemanticsegmentation_tpu_torch.utils import profiling
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from test_cli import build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "port_bench", "configs", "rovina_train.json")) as _f:
    CONF = json.load(_f)
H, W, STRIDE = 61, 83, 5
COUNTS = (8, 9)
K = np.array([[525.0 * W / 640, 0, W / 2], [0, 525.0 * W / 640, H / 2], [0, 0, 1]],
             np.float32)


@pytest.fixture(scope="module")
def images():
    return bench_train.make_images(2**31 + 77, 2, H, W)


@pytest.fixture(scope="module")
def rows(images):
    calib = Calibration(intrinsic=K, rotation=np.eye(3), translation=np.zeros(3))
    samples = [DatasetSample(f"image{i}", *im[:2], calib, im[2])
               for i, im in enumerate(images)]
    extractor = FeatureExtractor(FeatureConfig.from_config(Config(data=CONF)), "cpu")
    return cli_train.extract_training_rows(samples, extractor, STRIDE)


def test_rows_equal_the_reference(images, rows):
    x, y = rows
    cfg = dataclasses.replace(ref_frame.FrameConfig.from_config(CONF), stride=STRIDE)
    parts = [ref_train.training_rows(*v, np.linalg.inv(K), np.eye(3), np.zeros(3), cfg,
                                     "cpu")
             for im in images for v in ref_train.variants(*im)]
    assert len(parts) == 2 * ref_train.VARIANTS
    assert x.dtype == torch.float32 and x.shape[1] == 366 and len(x) > 1000
    assert torch.equal(x, torch.cat([p[0] for p in parts]))
    np.testing.assert_array_equal(y, np.concatenate([p[1] for p in parts]))
    assert y.dtype == np.int32 and (y >= 0).all()


def test_extraction_spans_and_counts_rows(images, rows):
    calib = Calibration(intrinsic=K, rotation=np.eye(3), translation=np.zeros(3))
    samples = [DatasetSample(f"image{i}", *im[:2], calib, im[2])
               for i, im in enumerate(images)]
    extractor = FeatureExtractor(FeatureConfig.from_config(Config(data=CONF)), "cpu")
    before = cli_train.train_rows.value
    with profiling.tracing(True):
        profiling.take()
        x, _ = cli_train.extract_training_rows(samples, extractor, STRIDE)
        spans = [s for s in profiling.take() if s.name == "train.extract"]
    assert torch.equal(x, rows[0])
    assert cli_train.train_rows.value - before == len(x)
    assert [s.attrs["variants"] for s in spans] == [6, 6]
    assert sum(s.attrs["rows"] for s in spans) == len(x)


def _assert_trees_equal(forest, trees):
    """The forest's trees ``t`` equal ``trees[t]``, the reference's."""
    for t, ref in trees.items():
        v = forest.tree_view(t)
        assert len(v.split_feature) == len(ref.split) > 1
        np.testing.assert_array_equal(v.split_feature, ref.split)
        np.testing.assert_array_equal(v.left_child, ref.left)
        np.testing.assert_array_equal(v.threshold.view(np.int32),
                                      ref.threshold.view(np.int32))
        leaves = ref.left == 0
        np.testing.assert_allclose(v.leaf_hist[leaves], ref.hist[leaves], rtol=1e-6,
                                   atol=0)
        assert ref_train.tree_mismatch(v.split_feature, v.threshold, v.left_child,
                                       v.leaf_hist, ref) == 0.0


@pytest.fixture(scope="module")
def recipe_forest(rows):
    """The recipe's 4 trees, grown together, at depth 8."""
    x, y = rows
    cfg = TrainerConfig(num_trees=4, max_depth=8, min_split_examples=10, seed=3)
    return ForestTrainer(cfg, "cpu").learn(x, y, class_counts=list(COUNTS),
                                           multi_label=True, progress=False)


@pytest.mark.parametrize("tree", range(4))
def test_recipe_trees_equal_the_reference(rows, recipe_forest, tree):
    x, y = rows
    ref = ref_train.grow_tree(x, y, COUNTS, tree, seed=3, max_depth=8, min_split=10)
    _assert_trees_equal(recipe_forest, {tree: ref})
    assert recipe_forest.max_depth == 9


def _tied_set(n=2000, d=40, seed=5):
    """Rows with many tied and integer values, and two label layers that
    depend on them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, :10] = np.round(x[:, :10] * 4)
    y = np.stack([(x[:, 0] + x[:, 1] > 0) * 3 + rng.integers(0, 3, n),
                  np.clip((x[:, 2] > 0.3) + rng.integers(0, 8, n) // 4 * 2, 0, 8)],
                 1).astype(np.int32)
    return torch.from_numpy(x), y


def test_multilabel_depth30_equals_the_reference():
    x, y = _tied_set()
    cfg = TrainerConfig(num_trees=2, max_depth=30, min_split_examples=20, seed=11)
    forest = ForestTrainer(cfg, "cpu").learn(x, y, class_counts=list(COUNTS),
                                             multi_label=True, progress=False)
    trees = [ref_train.grow_tree(x, y, COUNTS, t, seed=11, max_depth=30, min_split=20)
             for t in range(2)]
    _assert_trees_equal(forest, dict(enumerate(trees)))
    assert forest.max_depth > 9


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_threefry_copy_draws_the_port_stream(seed):
    key = jrandom.prng_key(seed)
    dev = torch.device("cpu")
    assert ref_train.key_of(seed) == key
    assert ref_train.fold(key, 7) == jrandom.fold_in(key, 7)
    assert list(ref_train.halves(key)) == jrandom.split(key)
    assert torch.equal(ref_train.bits(key, 1000, dev), jrandom.random_bits(key, (1000,), dev))
    assert torch.equal(ref_train.uniforms(key, 999, dev), jrandom.uniform(key, (999,), dev))
    for span in (2, 3, 9):
        assert torch.equal(ref_train.randints(key, 500, span, dev),
                           jrandom.randint(key, (500,), 0, span, dev).to(torch.int64))
    draw = device_draws([seed], 2, 366, 20, dev)
    for depth, nodes in ((0, 1), (3, 8), (17, 257)):
        layers, feats = draw(depth, [(0, nodes)])
        ref_layers, ref_feats = ref_train.level_draws(key, depth, nodes, 366, 20, 2, dev)
        assert torch.equal(layers, ref_layers) and torch.equal(feats, ref_feats)


def test_tree_mismatch_counts_each_difference():
    x, y = _tied_set(n=600, d=12, seed=2)
    ref = ref_train.grow_tree(x, y, COUNTS, 0, max_depth=30, min_split=20)
    arrays = (ref.split.copy(), ref.threshold.copy(), ref.left.copy(), ref.hist.copy())
    assert ref_train.tree_mismatch(*arrays, ref) == 0.0
    n, leaves = len(ref.split), int((ref.left == 0).sum())
    thr = arrays[1].copy()
    inner = int(np.flatnonzero(ref.left)[-1])
    thr[inner] = np.nextafter(thr[inner], np.float32(np.inf))
    assert ref_train.tree_mismatch(arrays[0], thr, arrays[2], arrays[3], ref) == 1 / n
    hist = arrays[3].copy()
    leaf = int(np.flatnonzero(ref.left == 0)[0])
    hist[leaf, 0, 0] *= 1 + 1e-5
    assert ref_train.tree_mismatch(arrays[0], arrays[1], arrays[2], hist, ref) == 1 / leaves
    short = tuple(a[:-2] for a in arrays)
    assert ref_train.tree_mismatch(*short, ref) == pytest.approx(2 / n + 2 / leaves)


@pytest.mark.parametrize("shared", [True, False])
def test_cli_train_is_extract_training_rows_and_learn(tmp_path, capsys, shared):
    path = build_dataset(tmp_path, names=("img0", "img1"), shared=shared)
    conf = Config(path)
    cli_train.main(["--conf", path, "--device", "cpu", "--max_depth", "7"])
    got = load_forest(model_path_for(conf))
    x, y, counts, multi = cli_train.extract_training_data(conf, "cpu", verbose=False)
    capsys.readouterr()

    prefixes, _ = layer_prefixes_for(conf)
    dataset = RovinaDataset(conf, "file_names_train", prefixes, load_labels=True)
    extractor = FeatureExtractor(FeatureConfig.from_config(conf), "cpu")
    rows, labels = cli_train.extract_training_rows(
        dataset, extractor, conf.get_int("training_sample_stride"))
    assert torch.equal(rows, x) and np.array_equal(labels, y) and len(x) > 100
    cfg = TrainerConfig.from_config(conf)
    cfg.max_depth = 7
    want = ForestTrainer(cfg, "cpu").learn(rows, labels, class_counts=counts,
                                           multi_label=multi, progress=False)
    assert got.node_counts == want.node_counts and got.multi_label == shared
    for name in ("split_feature", "threshold", "left_child", "leaf_hist"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_growth_spans_and_counters(rows):
    """``learn`` is one ``train.grow`` span holding a ``train.level`` span
    a level, then a ``train.refit`` span; ``train.levels`` adds the levels
    and ``train.nodes`` the grown trees' nodes."""
    from rovinasemanticsegmentation_tpu_torch.train import forest_trainer

    x, y = rows
    levels0, nodes0 = forest_trainer.train_levels.value, forest_trainer.train_nodes.value
    cfg = TrainerConfig(num_trees=2, max_depth=6, min_split_examples=10, seed=3)
    with profiling.tracing(True):
        profiling.take()
        forest = ForestTrainer(cfg, "cpu").learn(x, y, class_counts=list(COUNTS),
                                                 progress=False)
        spans = profiling.take()
    (grow,) = [s for s in spans if s.name == "train.grow"]
    (refit,) = [s for s in spans if s.name == "train.refit"]
    levels = [s for s in spans if s.name == "train.level"]
    assert grow.attrs == {"trees": 2, "rows": 2 * len(x)}
    assert [s.attrs["level"] for s in levels] == list(range(len(levels)))
    assert levels[0].attrs["nodes"] == 2 and levels[0].attrs["samples"] == 2 * len(x)
    assert all(s.parent == grow.id and grow.start_ns <= s.start_ns <= s.end_ns
               <= grow.end_ns for s in levels)
    assert grow.end_ns <= refit.start_ns
    assert forest_trainer.train_levels.value - levels0 == len(levels)
    assert forest.max_depth <= len(levels) <= cfg.max_depth + 1
    assert forest_trainer.train_nodes.value - nodes0 == sum(forest.node_counts)
