"""PyTorch port vs JAX reference: forest codec, weight conversion, descent.

The port's plain descent is the CUDA kernel's reference
(``csrc/forest_descent.cu``); here it is held to the JAX descent and to the
Pallas kernel in interpret mode on the same numpy inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models import forest as jforest
from rovinasemanticsegmentation_tpu.ops.forest_pallas import (
    PallasForestPredictor,
)
from rovinasemanticsegmentation_tpu_torch.models import forest as tforest
from rovinasemanticsegmentation_tpu_torch.ops import forest_cuda

torch.set_num_threads(2)

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "resources", "bench_forest.dat",
)


def _jax_leaves(forest, x):
    rec, bits = jforest.pack_node_records(
        forest.split_feature, forest.left_child, forest.threshold
    )
    return np.asarray(jforest._find_leaves_packed(
        jnp.asarray(x), jnp.asarray(rec), forest.max_depth, bits
    ))


def _port_predict(forest, x):
    tf = tforest.forest_from_numpy(forest, "cpu")
    leaves, post = forest_cuda.forest_predict(torch.from_numpy(x), tf)
    return leaves.numpy(), post.numpy()


class TestCodec:
    @pytest.mark.parametrize("use_native", [True, False])
    def test_fixture_decodes_equal(self, use_native):
        want = jforest.load_forest(FIXTURE, class_counts=[8, 9])
        got = tforest.load_forest(
            FIXTURE, class_counts=[8, 9], use_native=use_native
        )
        for name in ("split_feature", "threshold", "left_child", "leaf_hist"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert got.class_counts == want.class_counts == (8, 9)
        assert got.node_counts == want.node_counts
        assert got.max_depth == want.max_depth
        assert got.multi_label == want.multi_label

    def test_forest_from_numpy_accepts_both_packages(self):
        jf = jforest.load_forest(FIXTURE, class_counts=[8, 9])
        a = tforest.forest_from_numpy(jf, "cpu")
        b = tforest.forest_from_numpy(tforest.load_forest(FIXTURE, [8, 9]), "cpu")
        rec, bits = jforest.pack_node_records(
            jf.split_feature, jf.left_child, jf.threshold
        )
        for f in (a, b):
            np.testing.assert_array_equal(f.records.numpy(), rec)
            np.testing.assert_array_equal(f.leaf_hist.numpy(), jf.leaf_hist)
            assert f.records.dtype == torch.int32
            assert f.leaf_hist.dtype == torch.float32
            assert (f.feat_bits, f.max_depth) == (bits, jf.max_depth)
            assert f.class_counts == (8, 9)
            assert f.num_features == int(jf.split_feature.max()) + 1


class TestDescent:
    @pytest.mark.parametrize("seed,trees,depth,nodes,feats", [
        (0, 3, 8, 301, 78),
        (1, 2, 12, 801, 150),
        (2, 2, 6, 101, 700),  # D > 512: feat_bits = 10
    ])
    def test_leaves_equal_jax(self, seed, trees, depth, nodes, feats):
        rng = np.random.default_rng(seed)
        forest = jforest.random_forest(
            rng, trees, depth, feats, [4, 5], max_nodes=nodes
        )
        x = rng.normal(size=(500, feats)).astype(np.float32)
        x[::7, 0] = np.nan  # NaN goes left
        got, _ = _port_predict(forest, x)
        np.testing.assert_array_equal(got, _jax_leaves(forest, x))

    def test_equal_threshold_goes_right(self):
        rng = np.random.default_rng(3)
        forest = jforest.random_forest(rng, 2, 6, 20, [3], max_nodes=63)
        x = rng.normal(size=(200, 20)).astype(np.float32)
        for t in range(2):  # put half the points exactly on the root split
            x[t::2, forest.split_feature[t, 0]] = forest.threshold[t, 0]
        got, _ = _port_predict(forest, x)
        np.testing.assert_array_equal(got, _jax_leaves(forest, x))
        right = forest.left_child[:, 0] + 1
        for t in range(2):
            # On the root split the first step is right: the leaf lies in the
            # right subtree, whose node ids start at the right child.
            assert (got[t::2, t] >= right[t]).all()

    def test_single_node_tree(self):
        tree = jforest.TreeArrays(
            split_feature=np.zeros(1, np.int32),
            threshold=np.zeros(1, np.float32),
            left_child=np.zeros(1, np.int32),
            leaf_hist=np.array([[[1.0, 2.0]]], np.float32),
        )
        forest = jforest.build_forest([tree], [2])
        x = np.random.default_rng(4).normal(size=(9, 3)).astype(np.float32)
        leaves, post = _port_predict(forest, x)
        np.testing.assert_array_equal(leaves, _jax_leaves(forest, x))
        assert (leaves == 0).all()
        np.testing.assert_array_equal(post[:, 0], np.tile([1.0, 2.0], (9, 1)))

    @pytest.mark.parametrize("seed,trees", [(5, 2), (6, 3)])
    def test_posterior_vs_pallas_interpret(self, seed, trees):
        rng = np.random.default_rng(seed)
        forest = jforest.random_forest(
            rng, trees, 10, 78, [8, 9], max_nodes=401
        )
        x = rng.normal(size=(300, 78)).astype(np.float32)
        want = np.asarray(
            PallasForestPredictor(forest, interpret=True).log_posterior(
                jnp.asarray(x)
            )
        )
        _, got = _port_predict(forest, x)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_wrapper_on_cpu_runs_plain_without_launch(self):
        rng = np.random.default_rng(7)
        forest = tforest.forest_from_numpy(
            jforest.random_forest(rng, 2, 5, 10, [3], max_nodes=31), "cpu"
        )
        x = torch.from_numpy(rng.normal(size=(50, 10)).astype(np.float32))
        before = forest_cuda.launches.value
        leaves, post = forest_cuda.forest_predict(x, forest)
        want_leaves, want_post = forest_cuda.forest_predict_plain(x, forest)
        assert torch.equal(leaves, want_leaves) and torch.equal(post, want_post)
        assert forest_cuda.launches.value == before

    def test_too_few_feature_columns_rejected(self):
        rng = np.random.default_rng(8)
        forest = tforest.forest_from_numpy(
            jforest.random_forest(rng, 2, 5, 40, [3], max_nodes=31), "cpu"
        )
        narrow = torch.zeros((4, forest.num_features - 1))
        with pytest.raises(ValueError):
            forest_cuda.forest_predict(narrow, forest)
