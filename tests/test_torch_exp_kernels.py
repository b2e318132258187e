"""PyTorch port vs JAX reference: the kernel-experiment variants C and D.

C is the chunk-skip forest descent (``scripts/exp_descent.py``), D the
row-stage patch kernel (``scripts/exp_patches.py``); both run here in
interpret mode. Their ports are kernels C'' (``ops/forest_staged_cuda.py``,
on float32 and on packed feature rows) and D''
(``ops/patches_separable_cuda.py``, into the patch tensor and into packed
rows), whose wrappers run the plain versions on CPU tensors. The JAX scripts are imported with ``parity`` in
``sys.argv`` (their import-time CPU pin), and the environment variables they
edit are restored after each test.
"""

import copy
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
from rovinasemanticsegmentation_tpu_torch.ops import patches, patches_cuda
from rovinasemanticsegmentation_tpu_torch.ops import patches_separable_cuda
from rovinasemanticsegmentation_tpu_torch.ops.color import rgb_to_lab8
from rovinasemanticsegmentation_tpu_torch.ops.feature_rows import (
    RowLayout,
    permute_rows,
    permute_rows_plain,
    tail_view,
    unpack_rows,
)
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


PACKED = RowLayout.packed(363, 3)


def _integral_byte_thresholds(jf):
    """A copy of ``jf`` whose byte-feature splits have integer thresholds
    (x.5 -> x), so that a patch byte can equal one."""
    jf = copy.deepcopy(jf)
    inner = (jf.left_child != 0) & (jf.split_feature < PACKED.patch_bytes)
    jf.threshold[inner] = np.floor(jf.threshold[inner])
    return jf


def _packed_rows(case, jf, n=1024):
    """[n, 384] packed rows: uniform patch bytes, an N(0, 4) float tail."""
    rng = np.random.default_rng(7)
    pc, k = PACKED.patch_bytes, PACKED.num_features - PACKED.patch_bytes
    patch = rng.integers(0, 256, (n, pc), dtype=np.uint8)
    tail = rng.normal(size=(n, k)).astype(np.float32) * 2
    if case == "nan":
        tail[::3, :] = np.nan  # NaN goes left
        tail[1::7, 1] = np.nan
    elif case == "equal_threshold":
        for t in range(jf.num_trees):  # x == thr at each root goes right
            f, thr = jf.split_feature[t, 0], jf.threshold[t, 0]
            if f < pc:
                assert thr == int(thr) and 0 <= thr <= 255
                patch[t::jf.num_trees, f] = int(thr)
            else:
                tail[t::jf.num_trees, f - pc] = thr
    rows = torch.zeros((n, PACKED.row_bytes), dtype=torch.uint8)
    rows[:, :pc] = torch.from_numpy(patch)
    tail_view(rows, PACKED)[:, :k] = torch.from_numpy(tail)
    return rows


class TestStagedDescentRows:
    @pytest.mark.parametrize("case", ["normal", "nan", "equal_threshold"])
    def test_packed_rows_equal_to_chunk_skip_interpret(self, monkeypatch,
                                                       case):
        """The staged descent's plain path on usage-permuted packed rows
        against the chunk-skip kernel on the same features as float32,
        permuted alike: equal leaf ids and posteriors."""
        exp = _jax_script(monkeypatch, "exp_descent")
        jf = _integral_byte_thresholds(
            jforest.load_forest(FIXTURE, class_counts=[8, 9]))
        tf, lm = tforest.forest_from_numpy(jf, "cpu"), build_level_major(jf)
        rows = _packed_rows(case, jf)
        perm, remap = tforest.usage_permutation_rows(tf, PACKED)
        rows_p = permute_rows(rows, PACKED, perm)
        xp = unpack_rows(rows_p, PACKED).numpy()
        fmask = (1 << lm.feat_bits) - 1
        meta_r = (remap[lm.meta & fmask]
                  | (lm.meta & ~np.int64(fmask))).astype(np.int32)
        leaves_lm = np.asarray(exp.find_leaves_v(
            jnp.asarray(xp), jnp.asarray(meta_r), jnp.asarray(lm.thresholds),
            jnp.asarray(lm.level_offsets), jnp.asarray(lm.level_chunks),
            lm.num_levels, lm.feat_bits, chunk_skip=True, interpret=True,
        ))
        want_post = np.asarray(jforest._sum_leaf_histograms(
            jnp.asarray(lm.leaf_hist), jnp.asarray(leaves_lm)
        ))

        fp = tforest.permute_forest_features(tf, remap)
        for hot in (64, 128, PACKED.patch_bytes):
            leaves = forest_staged_cuda.find_leaves_staged_rows(
                rows_p, PACKED, fp, hot)
            np.testing.assert_array_equal(
                leaves.numpy(), level_major_to_natural(jf, leaves_lm))
        post = tforest.sum_leaf_histograms_plain(fp.leaf_hist, leaves)
        np.testing.assert_array_equal(post.numpy(), want_post)

    def test_row_permutation_keeps_bytes_below_pc(self, fixture_forests):
        _, tf, _ = fixture_forests
        pc = PACKED.patch_bytes
        perm, remap = tforest.usage_permutation_rows(tf, PACKED)
        np.testing.assert_array_equal(np.sort(perm[:pc]), np.arange(pc))
        np.testing.assert_array_equal(perm[pc:], np.arange(pc, D))
        np.testing.assert_array_equal(remap[perm], np.arange(D))
        # The byte features keep usage_permutation's order among themselves.
        full, _ = tforest.usage_permutation(tf, D)
        np.testing.assert_array_equal(perm[:pc], full[full < pc])
        fp = tforest.permute_forest_features(tf, remap)
        bits = tf.feat_bits
        meta, new_meta = tf.records[..., 0], fp.records[..., 0]
        inner = (meta >> bits) != 0
        fmask = (1 << bits) - 1
        assert torch.equal((meta & fmask)[inner] < pc,
                           (new_meta & fmask)[inner] < pc)
        # On float rows the row permutation is the identity.
        ident, _ = tforest.usage_permutation_rows(tf, RowLayout.float32(D))
        np.testing.assert_array_equal(ident, np.arange(D))

    @pytest.mark.parametrize("case", ["normal", "nan"])
    def test_permuted_rows_keep_the_descent(self, fixture_forests, case):
        jf, tf, _ = fixture_forests
        rows = _packed_rows(case, jf, n=500)
        perm, remap = tforest.usage_permutation_rows(tf, PACKED)
        rows_p = permute_rows(rows, PACKED, perm)
        got = unpack_rows(rows_p, PACKED)
        want = permute_rows_plain(rows, PACKED, perm)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(rows_p[:, PACKED.patch_bytes:],
                           rows[:, PACKED.patch_bytes:])
        fp = tforest.permute_forest_features(tf, remap)
        before = tforest.find_leaves_plain(unpack_rows(rows, PACKED),
                                           tf.records, tf.max_depth,
                                           tf.feat_bits)
        after = forest_staged_cuda.find_leaves_staged_rows(rows_p, PACKED,
                                                           fp, hot=64)
        assert torch.equal(before, after)

    @pytest.mark.parametrize("perm", [
        np.arange(D)[::-1].copy(),  # moves float features
        np.arange(D - 1),  # too short
        np.concatenate([np.zeros(2, np.int64), np.arange(2, D)]),  # repeats
    ])
    def test_bad_row_permutation_rejected(self, perm):
        rows = torch.zeros((4, PACKED.row_bytes), dtype=torch.uint8)
        with pytest.raises(ValueError):
            permute_rows(rows, PACKED, perm)
        with pytest.raises(ValueError):
            permute_rows_plain(rows, PACKED, perm)

    @pytest.mark.parametrize("layout,hot,spans", [
        (PACKED, 0, (0, 352)),  # the float tail only
        (PACKED, 64, (64, 352)),
        (PACKED, 100, (112, 352)),  # whole 16-byte units
        (PACKED, 340, (384, 384)),  # the prefix reaches the tail: whole row
        (PACKED, 363, (384, 384)),
        (RowLayout.float32(D), 128, (512, 4 * D)),  # no separate tail
        (RowLayout.float32(D), D, (4 * D, 4 * D)),
    ])
    def test_staged_spans(self, layout, hot, spans):
        assert forest_staged_cuda.staged_spans(layout, hot) == spans
        staged = forest_staged_cuda.staged_features(layout, hot)
        assert staged[:hot].all()
        if layout.patch_bytes:
            assert staged[layout.patch_bytes:].all()  # the tail is staged

    def test_rows_wrapper_on_cpu_runs_plain_without_launch(
        self, fixture_forests
    ):
        jf, tf, _ = fixture_forests
        rows = _packed_rows("nan", jf, n=77)
        before = forest_staged_cuda.launches.value
        got = forest_staged_cuda.find_leaves_staged_rows(rows, PACKED, tf, 64,
                                                         tile_points=8)
        want = tforest.find_leaves_plain(unpack_rows(rows, PACKED),
                                         tf.records, tf.max_depth,
                                         tf.feat_bits)
        assert torch.equal(got, want)
        assert forest_staged_cuda.launches.value == before

    def test_rows_bad_inputs_rejected(self, fixture_forests):
        jf, tf, _ = fixture_forests
        rows = torch.zeros((10, PACKED.row_bytes), dtype=torch.uint8)
        staged = forest_staged_cuda.find_leaves_staged_rows
        with pytest.raises(ValueError):  # hot past the last feature
            staged(rows, PACKED, tf, D + 1)
        with pytest.raises(ValueError):  # rows of another width
            staged(rows[:, :380].contiguous(), PACKED, tf, 64)
        with pytest.raises(ValueError):  # too few features for the forest
            staged(torch.zeros((10, 16), dtype=torch.uint8),
                   RowLayout.packed(12, 0), tf, 4)
        with pytest.raises(ValueError, match="unsupported device"):
            staged(rows.to("meta"), PACKED,
                   tforest.forest_from_numpy(jf, "meta"), 64)


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

    @pytest.mark.parametrize("row0", [0, 5])
    def test_separable_into_rows_equal_to_row_stage_interpret(
        self, monkeypatch, row0
    ):
        """The staged patch kernel's plain into-rows version against the
        row-stage kernel: each point's patch at the start of its row, zeros
        after it, and the fill bytes of the rows outside the block kept."""
        exp = _jax_script(monkeypatch, "exp_patches")
        h, w, b, r, s = 64, 96, 21, 7, 2
        rgb, depth, lab, dgrid = _frame(1, h, w, b, s)
        j_lab = j_reflect_pad(j_lab8(jnp.asarray(rgb)), b)
        want = np.asarray(exp.extract_patches_e(
            j_lab, jnp.asarray(dgrid.numpy()), patch_size=b, reduce_size=r,
            stride=s, interpret=True,
        ))
        n, pc = dgrid.numel(), 3 * r * r
        layout = RowLayout.packed(pc, 3)
        rows = torch.full((row0 + n + 4, layout.row_bytes), 0xAB,
                          dtype=torch.uint8)
        patches_separable_cuda.extract_patches_separable_into(lab, dgrid, b, r, s,
                                                        rows, row0)
        np.testing.assert_array_equal(
            rows[row0 : row0 + n, :pc].numpy(), want.reshape(n, pc))
        assert (rows[row0 : row0 + n, pc:] == 0).all()
        assert (rows[:row0] == 0xAB).all() and (rows[row0 + n :] == 0xAB).all()

    @pytest.mark.parametrize("s,b,r", [(1, 15, 5), (2, 77, 11), (5, 77, 11)])
    def test_separable_into_rows_equal_to_kernel_a_plain(self, s, b, r):
        _, _, lab, dgrid = _frame(20 + s, 40, 56, b, s)
        layout = RowLayout.packed(3 * r * r, 3)
        rows = torch.full((dgrid.numel() + 9, layout.row_bytes), 0x5C,
                          dtype=torch.uint8)
        want = rows.clone()
        before = patches_separable_cuda.launches.value
        patches_separable_cuda.extract_patches_separable_into(lab, dgrid, b, r, s,
                                                        rows, 9)
        patches_cuda.extract_patches_into_plain(lab, dgrid, b, r, s, want, 9)
        assert torch.equal(rows, want)
        assert patches_separable_cuda.launches.value == before

    def test_into_rows_bad_inputs_rejected(self):
        _, _, lab, dgrid = _frame(5, 20, 28, 9, 2)
        into = patches_separable_cuda.extract_patches_separable_into
        n = dgrid.numel()
        rows = torch.zeros((n + 2, 32), dtype=torch.uint8)
        with pytest.raises(ValueError):  # rows past the buffer's end
            into(lab, dgrid, 9, 3, 2, rows, 3)
        with pytest.raises(ValueError):  # rows narrower than a patch
            into(lab, dgrid, 9, 3, 2, rows[:, :20].contiguous(), 0)
        with pytest.raises(ValueError):  # rows past shared memory
            into(lab, dgrid, 9, 3, 2,
                 torch.zeros((n, 8000), dtype=torch.uint8), 0)

    @pytest.mark.parametrize("s,b,r", [(1, 15, 5), (2, 77, 11), (5, 77, 11)])
    def test_separable_plain_equal_to_gather_plain(self, s, b, r):
        _, _, lab, dgrid = _frame(10 + s, 40, 56, b, s)
        assert (dgrid.numpy() == 0).mean() > 0.005  # 2% holes
        want = patches.extract_patches_plain(lab, dgrid, b, r, s)
        got = patches_separable_cuda.extract_patches_separable(lab, dgrid, b, r, s)
        assert torch.equal(got, want)

    def test_wrapper_on_cpu_runs_plain_without_launch(self):
        _, _, lab, dgrid = _frame(3, 20, 28, 9, 2)
        before = patches_separable_cuda.launches.value
        got = patches_separable_cuda.extract_patches_separable(lab, dgrid, 9, 3, 2)
        want = patches.extract_patches_separable_plain(lab, dgrid, 9, 3, 2)
        assert torch.equal(got, want)
        assert patches_separable_cuda.launches.value == before

    def test_bad_inputs_rejected(self):
        _, _, lab, dgrid = _frame(4, 20, 28, 9, 2)
        separable = patches_separable_cuda.extract_patches_separable
        with pytest.raises(ValueError):  # float64 depth
            separable(lab, dgrid.double(), 9, 3, 2)
        with pytest.raises(ValueError):  # image too small for the grid
            separable(lab[:-2], dgrid, 9, 3, 2)
        with pytest.raises(ValueError):  # reduce size 0
            separable(lab, dgrid, 9, 0, 2)
        with pytest.raises(ValueError):  # R = 60: too much shared memory
            separable(lab, dgrid, 9, 60, 2)
        with pytest.raises(ValueError, match="unsupported device"):
            separable(lab.to("meta"), dgrid.to("meta"), 9, 3, 2)


class TestEntryPoints:
    def test_exp_descent_parity_on_cpu(self, capsys):
        result = exp_descent.main(["parity", "--device", "cpu"])
        assert result["parity"] is True
        assert result["rows"] == "packed"
        assert result["points"] == 4096
        assert len(result["staged"]) == 15  # 5 hot values x 3 tile sizes
        assert [row["hot"] for row in result["staged"][::3]] == [
            0, 64, 128, 256, 363]
        assert all(row["equal"] for row in result["staged"])
        shares = [row["hot_split_share"] for row in result["staged"]]
        assert shares == sorted(shares) and shares[-1] == 1.0
        assert '"parity": true' in capsys.readouterr().out

    def test_exp_descent_float_rows_parity_on_cpu(self, capsys):
        result = exp_descent.main(["parity", "--device", "cpu", "--rows",
                                   "float", "--tile-points", "64"])
        assert result["parity"] is True and result["rows"] == "float"
        assert [row["hot"] for row in result["staged"]] == [0, 64, 128, 256,
                                                            366]
        shares = [row["hot_split_share"] for row in result["staged"]]
        assert shares[0] == 0.0 and shares[-1] == 1.0
        assert '"parity": true' in capsys.readouterr().out

    def test_exp_patches_parity_on_cpu(self, capsys):
        result = exp_patches.main(["parity", "--device", "cpu"])
        assert result["parity"] is True
        assert result["shape"] == [32, 48, 7, 7, 3]
        assert set(result["equal_to_plain"]) == {
            "A", "separable", "plain", "separable_plain"}
        assert result["rows_equal_to_plain"] == {
            "A": True, "separable": True, "plain": True, "separable_plain": True}
        assert result["row_bytes"] == 160 and result["row0"] == 3
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
