"""PyTorch port vs JAX: the forest trainer's pieces on the same inputs.

The exact split search (one slot and all K slots of a level), the binned
search and its feature bins, the node statistics, the full-dataset leaf
refit and the log smoothing. Thresholds, masses, bins and boundary indices
are equal; objectives agree within rtol 1e-6 (XLA:CPU's ``log2`` is not
correctly rounded) with ``inf`` where JAX has ``inf``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.train import forest_trainer as J
from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T

from test_trainer import oracle_best_split


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_search_equal(got, want):
    obj_t, thr_t, lm_t, rm_t = (np.asarray(a) for a in got)
    obj_j, thr_j, lm_j, rm_j = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(np.isinf(obj_t), np.isinf(obj_j))
    fin = np.isfinite(obj_j)
    np.testing.assert_allclose(obj_t[fin], obj_j[fin], rtol=1e-6)
    np.testing.assert_array_equal(thr_t, thr_j)
    np.testing.assert_array_equal(lm_t, lm_j)
    np.testing.assert_array_equal(rm_t, rm_j)


def _step_both(vals, seg, cls, weights, f, c):
    want = J.split_search_step(jnp.asarray(vals), jnp.asarray(seg),
                               jnp.asarray(cls), jnp.asarray(weights), f, c)
    got = T.split_search_step(_t(vals), _t(seg), _t(cls), _t(weights), f, c)
    _assert_search_equal([g.numpy() for g in got], want)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_step_single_segment_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    n, c = 100, 4
    vals = rng.normal(size=n).astype(np.float32)
    cls = rng.integers(0, c, n).astype(np.int32)
    obj, thr, lm, rm = _step_both(vals, np.zeros(n, np.int32), cls,
                                  np.ones(c, np.float32), 1, c)
    want = oracle_best_split(vals, cls, c)
    assert obj[0] == pytest.approx(want[0], rel=1e-5)
    assert thr[0] == pytest.approx(want[1], rel=1e-5)
    assert lm[0] == want[2] and rm[0] == want[3]


def test_split_step_multiple_segments():
    rng = np.random.default_rng(3)
    n, c = 60, 3
    vals = rng.normal(size=2 * n).astype(np.float32)
    cls = rng.integers(0, c, 2 * n).astype(np.int32)
    _step_both(vals, np.repeat([0, 1], n).astype(np.int32), cls,
               np.ones(c, np.float32), 2, c)


@pytest.mark.parametrize("seed", [0, 5])
def test_split_step_class_frequency_weighting(seed):
    rng = np.random.default_rng(seed)
    n, c = 120, 3
    vals = rng.normal(size=n).astype(np.float32)
    cls = ((rng.random(n) < 0.12) * rng.integers(1, c, n)).astype(np.int32)
    counts = np.bincount(cls, minlength=c).astype(np.float32)
    weights = np.where(counts > 0, n / np.maximum(counts, 1), 1.0)
    _step_both(vals, np.zeros(n, np.int32), cls, weights.astype(np.float32),
               1, c)


def test_split_step_identical_values_and_inactive_segments():
    cls = np.arange(20).astype(np.int32) % 2
    obj, *_ = _step_both(np.ones(20, np.float32), np.zeros(20, np.int32), cls,
                         np.ones(2, np.float32), 1, 2)
    assert np.isinf(obj[0])
    vals = np.linspace(0, 1, 20).astype(np.float32)
    obj, *_ = _step_both(vals, np.full(20, 1, np.int32),
                         (vals > 0.5).astype(np.int32), np.ones(2, np.float32),
                         1, 2)
    assert np.isinf(obj[0])


@pytest.mark.parametrize("seed", range(6))
def test_split_step_random_segments_ties_and_signed_zeros(seed):
    """Integer values (many exact ties), -0.0 beside +0.0, empty segments
    and inactive examples mixed in one stream."""
    rng = np.random.default_rng(10 + seed)
    n, c, f = 300, 5, 7
    vals = rng.integers(-3, 4, n).astype(np.float32)
    vals[rng.random(n) < 0.1] = -0.0
    if seed % 2:
        vals += rng.normal(0, 1e-7, n).astype(np.float32)  # sub-1e-6 gaps
    seg = rng.integers(0, f + 1, n).astype(np.int32)
    seg[seg == 3] = f  # segment 3 empty
    cls = rng.integers(0, c, n).astype(np.int32)
    weights = rng.uniform(0.5, 4.0, c).astype(np.float32)
    _step_both(vals, seg, cls, weights, f, c)


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_slot_search_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n, d, f, k, c = 400, 12, 6, 4, 3
    x = np.round(rng.normal(size=(n, d)) * 4).astype(np.float32)
    feats = np.stack([rng.permutation(d)[:k] for _ in range(f)]).astype(np.int32)
    seg = rng.integers(0, f + 1, n).astype(np.int32)
    seg_search = np.where(np.isin(seg, [1, 4]), f, seg).astype(np.int32)
    cls = rng.integers(0, c, n).astype(np.int32)
    w = np.ones(c, np.float32)
    want = J.multi_slot_split_search(
        jnp.asarray(x), jnp.asarray(feats), jnp.asarray(seg),
        jnp.asarray(seg_search), jnp.asarray(cls), jnp.asarray(w), f, c)
    got = T.multi_slot_split_search(
        _t(x), _t(feats).long(), _t(seg).long(), _t(seg_search).long(),
        _t(cls).long(), _t(w), f, c)
    _assert_search_equal([g.numpy() for g in got], want)


@pytest.mark.parametrize("num_bins", [4, 16, 256])
def test_feature_bins_equal(num_bins):
    rng = np.random.default_rng(num_bins)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    x[:, 1] = np.round(x[:, 1] * 2)  # few distinct values
    x[:, 2] = 1.5  # constant: no transition, all boundaries inf
    x[:, 3] = rng.integers(0, 100, 300)  # integer-valued like Lab bytes
    xb_j, bnd_j = J.build_feature_bins(jnp.asarray(x), num_bins=num_bins)
    xb_t, bnd_t = T.build_feature_bins(_t(x), num_bins=num_bins)
    np.testing.assert_array_equal(bnd_t.numpy(), np.asarray(bnd_j))
    np.testing.assert_array_equal(xb_t.numpy(), np.asarray(xb_j))


@pytest.mark.parametrize("seed", [0, 1])
def test_binned_search_equals_jax(seed):
    rng = np.random.default_rng(20 + seed)
    n, d, f, k, c, b = 500, 10, 5, 4, 4, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    xb, bnd = J.build_feature_bins(jnp.asarray(x), num_bins=b)
    feats = np.stack([rng.permutation(d)[:k] for _ in range(f)]).astype(np.int32)
    seg = rng.integers(0, f + 1, n).astype(np.int32)
    seg_search = np.where(seg == 2, f, seg).astype(np.int32)
    cls = rng.integers(0, c, n).astype(np.int32)
    w = rng.uniform(0.5, 2.0, c).astype(np.float32)
    want = J.multi_slot_split_search_binned(
        xb, bnd, jnp.asarray(feats), jnp.asarray(seg), jnp.asarray(seg_search),
        jnp.asarray(cls), jnp.asarray(w), f, c, b)
    got = T.multi_slot_split_search_binned(
        _t(xb), _t(bnd), _t(feats).long(), _t(seg).long(),
        _t(seg_search).long(), _t(cls).long(), _t(w), f, c, b)
    _assert_search_equal([g.numpy() for g in got], want)
    # The chosen boundary indices, one slot at a time.
    for s in range(k):
        obj_j, bidx_j, _, _ = J._binned_slot_search(
            xb[:, feats[:, s]][np.arange(n), np.minimum(seg, f - 1)],
            jnp.asarray(seg_search), jnp.asarray(cls), jnp.asarray(w), f, c, b)
        bins = _t(np.asarray(xb))[torch.arange(n), _t(feats[:, s]).long()[
            _t(np.minimum(seg, f - 1)).long()]]
        _, bidx_t, _, _ = T._binned_search(
            bins[None], _t(seg_search).long(), _t(cls).long(), _t(w), f, c, b)
        np.testing.assert_array_equal(bidx_t[0].numpy(), np.asarray(bidx_j))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_node_stats_equal_both_jax_versions(num_layers):
    rng = np.random.default_rng(num_layers)
    n, f, c = 250, 6, 5
    seg = rng.integers(0, f + 1, n).astype(np.int32)
    labels = rng.integers(0, c, (n, num_layers)).astype(np.int32)
    labels[seg == 2, 0] = 1  # a pure node
    mass_t, dist_t = T.node_stats(_t(seg).long(), _t(labels).long(), f, c,
                                  num_layers)
    for fn in (J.node_stats_step, J.node_stats_scatter):
        mass_j, dist_j = fn(jnp.asarray(seg), jnp.asarray(labels), f, c,
                            num_layers)
        np.testing.assert_array_equal(mass_t.numpy(), np.asarray(mass_j))
        np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))


def _random_tree(rng, d, depth):
    """A breadth-first tree (children appended after their parent)."""
    sf, th, lc, dep = [0], [0.0], [0], [0]
    v = 0
    while v < len(sf):
        if dep[v] < depth and rng.random() < 0.8:
            lc[v] = len(sf)
            sf[v] = int(rng.integers(d))
            th[v] = float(rng.normal())
            for _ in range(2):
                sf.append(0), th.append(0.0), lc.append(0)
                dep.append(dep[v] + 1)
        v += 1
    return (np.array(sf, np.int32), np.array(th, np.float32),
            np.array(lc, np.int32), np.array(dep, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leaf_histograms_all_close_to_jax(seed):
    rng = np.random.default_rng(seed)
    n, d, c = 600, 8, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, c, (n, 2)).astype(np.int32)
    labels[:, 1] %= 3
    freqs = np.stack([J._inverted_class_frequency(labels[:, l].astype(np.int64), c)
                      for l in range(2)])
    sf, th, lc, dep = _random_tree(rng, d, 5)
    nn = len(sf)
    want = np.asarray(J._leaf_histograms_all(
        jnp.asarray(x), jnp.asarray(labels), jnp.asarray(freqs),
        jnp.asarray(sf), jnp.asarray(th), jnp.asarray(lc),
        num_nodes=nn, num_classes=c, max_depth=int(dep.max())))
    got = T._leaf_histograms_all(
        _t(x), _t(labels).long(), _t(freqs),
        T.TreeTables(_t(sf), _t(th), _t(lc), _t(dep)), c).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_smooth_histograms_and_class_weights_equal():
    rng = np.random.default_rng(4)
    raw = (rng.integers(0, 40, (30, 2, 5)) * rng.uniform(0.5, 3, (1, 2, 5))
           ).astype(np.float32)
    lc = np.where(rng.random(30) < 0.5, 0, 3).astype(np.int32)
    np.testing.assert_allclose(
        T._smooth_histograms(raw, lc, [5, 3], 1.0),
        J._smooth_histograms(raw, lc, [5, 3], 1.0), rtol=1e-6)
    y = rng.integers(0, 4, (50, 1))
    for use in (False, True):
        cfg_j = J.TrainerConfig(use_class_frequency=use)
        cfg_t = T.TrainerConfig(use_class_frequency=use)
        np.testing.assert_array_equal(T._tree_class_weights(cfg_t, y, 50, 5),
                                      J._tree_class_weights(cfg_j, y, 50, 5))
    labels = rng.integers(0, 6, 80)
    np.testing.assert_array_equal(T._inverted_class_frequency(labels, 7),
                                  J._inverted_class_frequency(labels, 7))
