"""PyTorch port vs JAX reference: the kernel-experiment variants C and D.

C is the chunk-skip forest descent (``scripts/exp_descent.py``), D the
row-stage patch kernel (``scripts/exp_patches.py``); both run here in
interpret mode. Their ports are kernels C' (``ops/forest_staged_cuda.py``)
and D' (``ops/patches_planar_cuda.py``), whose wrappers run the plain
versions on CPU tensors. The JAX scripts are imported with ``parity`` in
``sys.argv`` (their import-time CPU pin), and the environment variables they
edit are restored after each test.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models import forest as jforest
from rovinasemanticsegmentation_tpu.ops.color import rgb_to_lab8 as j_lab8
from rovinasemanticsegmentation_tpu.ops.forest_pallas import (
    LANES,
    build_level_major,
)
from rovinasemanticsegmentation_tpu.ops.patches import (
    reflect_pad_image as j_reflect_pad,
)
from rovinasemanticsegmentation_tpu_torch.models import forest as tforest
from rovinasemanticsegmentation_tpu_torch.ops import forest_staged_cuda
from rovinasemanticsegmentation_tpu_torch.ops import patches
from rovinasemanticsegmentation_tpu_torch.ops import patches_planar_cuda
from rovinasemanticsegmentation_tpu_torch.ops.color import rgb_to_lab8
from rovinasemanticsegmentation_tpu_torch.ops.geometry import (
    millimetres_to_metres,
)
from rovinasemanticsegmentation_tpu_torch.scripts import exp_descent
from rovinasemanticsegmentation_tpu_torch.scripts import exp_patches

torch.set_num_threads(2)

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "resources", "bench_forest.dat",
)
D = 366


def _jax_script(monkeypatch, name):
    """``scripts/<name>.py`` imported as its ``parity`` mode imports it."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "parity"])
    for var in ("XLA_FLAGS", "JAX_PLATFORMS"):
        if var in os.environ:
            monkeypatch.setenv(var, os.environ[var])
        else:
            monkeypatch.delenv(var, raising=False)
    return importlib.import_module(f"scripts.{name}")


@pytest.fixture(scope="module")
def fixture_forests():
    jf = jforest.load_forest(FIXTURE, class_counts=[8, 9])
    return jf, tforest.forest_from_numpy(jf, "cpu"), build_level_major(jf)


def level_major_to_natural(forest, leaves_lm):
    """Map level-major leaf ids back to natural ids, tree by tree.

    The breadth-first rule of ``forest_pallas.build_level_major``: nodes are
    ordered by depth (stable, so natural order within a level), each level
    starts at a multiple of 128, and a node's new id is its level's start
    plus its rank within the level.
    """
    out = np.empty_like(leaves_lm)
    for t in range(leaves_lm.shape[1]):
        n = forest.node_counts[t]
        left = forest.left_child[t, :n]
        depth = np.zeros(n, np.int64)
        for node in range(n):
            if left[node] != 0:
                depth[left[node]] = depth[left[node] + 1] = depth[node] + 1
        widths = np.bincount(depth)
        level_start = np.concatenate([[0], np.cumsum(-(-widths // LANES))])
        new_id = np.empty(n, np.int64)
        for lvl in range(len(widths)):
            nodes = np.flatnonzero(depth == lvl)
            new_id[nodes] = level_start[lvl] * LANES + np.arange(len(nodes))
        natural = np.full(int(new_id.max()) + 1, -1, np.int64)
        natural[new_id] = np.arange(n)
        out[:, t] = natural[leaves_lm[:, t]]
    assert (out >= 0).all(), "a leaf id maps to no node"
    return out


class TestUsagePermutation:
    def test_equal_to_jax(self, monkeypatch, fixture_forests):
        exp = _jax_script(monkeypatch, "exp_descent")
        _, tf, lm = fixture_forests
        want_perm, want_remap = exp.usage_permutation(lm, D)
        perm, remap = tforest.usage_permutation(tf, D)
        np.testing.assert_array_equal(perm, want_perm)
        np.testing.assert_array_equal(remap, want_remap)
        np.testing.assert_array_equal(remap[perm], np.arange(D))

    def test_permuted_forest_keeps_children_and_thresholds(
        self, fixture_forests
    ):
        _, tf, _ = fixture_forests
        _, remap = tforest.usage_permutation(tf, D)
        fp = tforest.permute_forest_features(tf, remap)
        bits = tf.feat_bits
        meta, new_meta = tf.records[..., 0], fp.records[..., 0]
        assert torch.equal(meta >> bits, new_meta >> bits)
        assert torch.equal(tf.records[..., 1], fp.records[..., 1])
        internal = (meta >> bits) != 0
        fmask = (1 << bits) - 1
        remapped = torch.from_numpy(remap)[(meta & fmask).long()]
        assert torch.equal((new_meta & fmask)[internal], remapped[internal].int())
        assert fp.num_features <= D

    def test_remap_too_short_rejected(self, fixture_forests):
        _, tf, _ = fixture_forests
        with pytest.raises(ValueError):
            tforest.permute_forest_features(tf, np.arange(10))


def _descent_inputs(case, jf):
    x = np.random.default_rng(0).normal(size=(1024, D)).astype(np.float32) * 2
    if case == "nan":
        x[::3, :] = np.nan  # NaN goes left
        x[1::7, ::5] = np.nan
    elif case == "equal_threshold":
        for t in range(jf.num_trees):  # x == thr at each root goes right
            x[t::jf.num_trees, jf.split_feature[t, 0]] = jf.threshold[t, 0]
    return x


class TestStagedDescent:
    @pytest.mark.parametrize("case", ["normal", "nan", "equal_threshold"])
    def test_equal_to_chunk_skip_interpret(
        self, monkeypatch, fixture_forests, case
    ):
        exp = _jax_script(monkeypatch, "exp_descent")
        jf, tf, lm = fixture_forests
        x = _descent_inputs(case, jf)
        perm, remap = exp.usage_permutation(lm, D)
        fmask = (1 << lm.feat_bits) - 1
        meta_r = (remap[lm.meta & fmask]
                  | (lm.meta & ~np.int64(fmask))).astype(np.int32)
        xp = np.ascontiguousarray(x[:, perm])
        leaves_lm = np.asarray(exp.find_leaves_v(
            jnp.asarray(xp), jnp.asarray(meta_r), jnp.asarray(lm.thresholds),
            jnp.asarray(lm.level_offsets), jnp.asarray(lm.level_chunks),
            lm.num_levels, lm.feat_bits, chunk_skip=True, interpret=True,
        ))
        want_post = np.asarray(jforest._sum_leaf_histograms(
            jnp.asarray(lm.leaf_hist), jnp.asarray(leaves_lm)
        ))

        fp = tforest.permute_forest_features(tf, remap)
        leaves = forest_staged_cuda.find_leaves_staged(
            torch.from_numpy(xp), fp, hot=128
        )
        np.testing.assert_array_equal(
            leaves.numpy(), level_major_to_natural(jf, leaves_lm)
        )
        post = tforest.sum_leaf_histograms_plain(fp.leaf_hist, leaves)
        np.testing.assert_array_equal(post.numpy(), want_post)

    def test_wrapper_on_cpu_runs_plain_without_launch(self, fixture_forests):
        _, tf, _ = fixture_forests
        x = torch.from_numpy(
            np.random.default_rng(1).normal(size=(77, D)).astype(np.float32)
        )
        before = forest_staged_cuda.launches.value
        got = forest_staged_cuda.find_leaves_staged(x, tf, hot=D, tile_points=8)
        want = tforest.find_leaves_plain(x, tf.records, tf.max_depth,
                                         tf.feat_bits)
        assert torch.equal(got, want)
        assert forest_staged_cuda.launches.value == before

    @pytest.mark.parametrize("hot,tile_points", [
        (-1, 32), (D + 1, 32),  # hot outside [0, D]
        (128, 0), (128, 257),  # 257 x 4 trees > 1024 threads
        (D, 200),  # 286 KB of shared memory
    ])
    def test_bad_hot_or_tile_rejected(self, fixture_forests, hot, tile_points):
        _, tf, _ = fixture_forests
        x = torch.zeros((10, D))
        with pytest.raises(ValueError):
            forest_staged_cuda.find_leaves_staged(x, tf, hot, tile_points)

    def test_bad_device_or_shape_rejected(self, fixture_forests):
        jf, tf, _ = fixture_forests
        with pytest.raises(ValueError):  # too few columns
            forest_staged_cuda.find_leaves_staged(torch.zeros((4, 100)), tf, 64)
        with pytest.raises(ValueError):  # float64
            forest_staged_cuda.find_leaves_staged(
                torch.zeros((4, D), dtype=torch.float64), tf, 64)
        meta_forest = tforest.forest_from_numpy(jf, "meta")
        with pytest.raises(ValueError, match="unsupported device"):
            forest_staged_cuda.find_leaves_staged(
                torch.zeros((4, D), device="meta"), meta_forest, 64)


def _frame(seed, h, w, b, s):
    """Port inputs of exp_patches: padded Lab and grid depth in metres."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    depth = exp_patches.make_depth(rng, h, w)
    lab = patches.reflect_pad_image(rgb_to_lab8(torch.from_numpy(rgb)), b)
    dgrid = millimetres_to_metres(
        torch.from_numpy(depth[::s, ::s].astype(np.float32)))
    return rgb, depth, lab, dgrid


class TestPlanarPatches:
    def test_make_depth_equal_to_jax(self, monkeypatch):
        exp = _jax_script(monkeypatch, "exp_patches")
        for h, w in ((64, 96), (480, 640)):
            np.testing.assert_array_equal(
                exp_patches.make_depth(np.random.default_rng(0), h, w),
                exp.make_depth(np.random.default_rng(0), h, w),
            )

    def test_separable_plain_equal_to_row_stage_interpret(self, monkeypatch):
        exp = _jax_script(monkeypatch, "exp_patches")
        h, w, b, r, s = 64, 96, 21, 7, 2
        rgb, depth, lab, dgrid = _frame(0, h, w, b, s)
        j_lab = j_reflect_pad(j_lab8(jnp.asarray(rgb)), b)
        np.testing.assert_array_equal(np.asarray(j_lab), lab.numpy())
        want = np.asarray(exp.extract_patches_e(
            j_lab, jnp.asarray(dgrid.numpy()), patch_size=b, reduce_size=r,
            stride=s, interpret=True,
        ))
        got = patches.extract_patches_separable_plain(lab, dgrid, b, r, s)
        assert (dgrid.numpy() <= 0).any()  # the frame has holes
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("s,b,r", [(1, 15, 5), (2, 77, 11), (5, 77, 11)])
    def test_separable_plain_equal_to_gather_plain(self, s, b, r):
        _, _, lab, dgrid = _frame(10 + s, 40, 56, b, s)
        assert (dgrid.numpy() == 0).mean() > 0.005  # 2% holes
        want = patches.extract_patches_plain(lab, dgrid, b, r, s)
        got = patches_planar_cuda.extract_patches_planar(lab, dgrid, b, r, s)
        assert torch.equal(got, want)

    def test_wrapper_on_cpu_runs_plain_without_launch(self):
        _, _, lab, dgrid = _frame(3, 20, 28, 9, 2)
        before = patches_planar_cuda.launches.value
        got = patches_planar_cuda.extract_patches_planar(lab, dgrid, 9, 3, 2)
        want = patches.extract_patches_separable_plain(lab, dgrid, 9, 3, 2)
        assert torch.equal(got, want)
        assert patches_planar_cuda.launches.value == before

    def test_bad_inputs_rejected(self):
        _, _, lab, dgrid = _frame(4, 20, 28, 9, 2)
        planar = patches_planar_cuda.extract_patches_planar
        with pytest.raises(ValueError):  # float64 depth
            planar(lab, dgrid.double(), 9, 3, 2)
        with pytest.raises(ValueError):  # image too small for the grid
            planar(lab[:-2], dgrid, 9, 3, 2)
        with pytest.raises(ValueError):  # reduce size 0
            planar(lab, dgrid, 9, 0, 2)
        with pytest.raises(ValueError):  # R = 60: too much shared memory
            planar(lab, dgrid, 9, 60, 2)
        with pytest.raises(ValueError, match="unsupported device"):
            planar(lab.to("meta"), dgrid.to("meta"), 9, 3, 2)


class TestEntryPoints:
    def test_exp_descent_parity_on_cpu(self, capsys):
        result = exp_descent.main(["parity", "--device", "cpu"])
        assert result["parity"] is True
        assert result["points"] == 4096
        assert len(result["staged"]) == 15  # 5 hot values x 3 tile sizes
        assert all(row["equal"] for row in result["staged"])
        shares = [row["hot_split_share"] for row in result["staged"]]
        assert shares == sorted(shares) and shares[-1] == 1.0
        assert '"parity": true' in capsys.readouterr().out

    def test_exp_patches_parity_on_cpu(self, capsys):
        result = exp_patches.main(["parity", "--device", "cpu"])
        assert result["parity"] is True
        assert result["shape"] == [32, 48, 7, 7, 3]
        assert set(result["equal_to_plain"]) == {
            "A", "planar", "plain", "separable_plain"}
        assert '"parity": true' in capsys.readouterr().out

    @pytest.mark.parametrize("module", [exp_descent, exp_patches])
    def test_bench_refuses_the_cpu(self, module):
        with pytest.raises(RuntimeError):
            module.main(["bench", "--device", "cpu"])

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError):
            exp_descent.main(["parity", "--device", "cuda"])
