"""The exact split search's kernels (``csrc/split_search.cu``) against the
plain PyTorch search, and the dispatch that picks between them.

The card tests (marker ``cuda``; each skips when
``torch.cuda.is_available()`` is false) hold the kernels' four ``[K, F]``
results to ``forest_trainer._split_search_plain``'s on the card, bit for bit,
on the same sorted stream: one segment over the whole stream, many segments
with size-1 and single-class ones, inactive entries with and without any,
empty segments, value gaps on both sides of 1e-6, values of +-0.0, ties in
the objective, the ``[C]`` and ``[F, C]`` weighted forms with a partial
``weighted`` mask, and K = 20 slots over ~1M entries. They also hold a
forest learnt on the card to the benchmark's plain reference trainer
(``port_bench/reference/train.py``), node for node, with one search a level.
On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_split_search_cuda.py -q

The CPU tests hold the dispatch and the wrapper's contract: a CPU tensor
keeps the plain search and leaves the counter alone, and the wrapper refuses
CPU tensors and what the kernels cannot take. This file imports nothing of
JAX.
"""

import numpy as np
import pytest
import torch

from port_bench.reference import train as ref_train
from rovinasemanticsegmentation_tpu_torch.ops import split_search_cuda
from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T
from rovinasemanticsegmentation_tpu_torch.utils import profiling, roofline

OUTPUTS = ("objective", "threshold", "left mass", "right mass")
ULP_1 = np.float32(np.spacing(np.float32(1.0)))  # 2^-23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


def _single_segment(rng):
    return (_f32(rng.integers(0, 60, (3, 20000))), _i64(np.zeros(20000)),
            _i64(rng.integers(0, 5, 20000)), 1, 5, None, None)


def _many_segments(rng):
    """500 segments: 20 of a single entry, 40 of a single class, and entries
    off the frontier (segment F)."""
    ns, f = 50000, 500
    seg = rng.integers(0, f + 1, ns)
    seg[seg < 20] = 20
    seg[:20] = np.arange(20)
    cls = rng.integers(0, 4, ns)
    cls[(seg >= 20) & (seg < 60)] = 2
    return (_f32(rng.normal(size=(4, ns))), _i64(seg), _i64(cls), f, 4, None,
            None)


def _no_inactive(rng):
    ns, f = 30000, 200
    return (_f32(rng.integers(0, 255, (3, ns))), _i64(rng.integers(0, f, ns)),
            _i64(rng.integers(0, 9, ns)), f, 9, None, None)


def _mostly_inactive(rng):
    """A deep level: most entries off the frontier, every other segment
    empty, the inactive tail most of the stream."""
    ns, f = 40000, 300
    seg = np.where(rng.random(ns) < 0.85, f, 2 * rng.integers(0, f // 2, ns))
    return (_f32(rng.integers(0, 30, (5, ns))), _i64(seg),
            _i64(rng.integers(0, 9, ns)), f, 9, None, None)


def _all_inactive(rng):
    ns, f = 5000, 7
    return (_f32(rng.normal(size=(2, ns))), _i64(np.full(ns, f)),
            _i64(rng.integers(0, 3, ns)), f, 3, None, None)


def _one_entry(rng):
    return _f32([[1.5]]), _i64([0]), _i64([0]), 1, 1, None, None


def _gaps(rng):
    """Consecutive values 8 and 9 float32 ulps apart at 1.0 (9.5e-7 and
    1.07e-6: one gap below 1e-6, one above), and at 0."""
    ns, f = 20000, 50
    ulps = rng.choice([0, 8, 9, 17], size=(3, ns))
    near_one = np.float32(1.0) + ulps.astype(np.float32) * ULP_1
    near_zero = rng.choice(np.array([0.0, 9.9e-7, 1e-6, 1.01e-6, 2e-6],
                                    np.float32), (3, ns))
    vals = np.where(rng.random((3, ns)) < 0.5, near_one, near_zero)
    return (_f32(vals), _i64(rng.integers(0, f + 1, ns)),
            _i64(rng.integers(0, 3, ns)), f, 3, None, None)


def _signed_zeros(rng):
    ns, f = 20000, 40
    vals = rng.choice(np.array([-0.0, 0.0, -1e-7, 1e-7, 1.0, -1.0], np.float32),
                      (4, ns))
    return (_f32(vals), _i64(rng.integers(0, f + 1, ns)),
            _i64(rng.integers(0, 4, ns)), f, 4, None, None)


def _objective_ties(rng):
    """Classes alternate along values that repeat in a period: splits at
    equal objectives in every segment; the earliest wins."""
    ns, f = 24000, 6
    vals = np.tile((np.arange(ns) % 8).astype(np.float32), (2, 1))
    return (_f32(vals), _i64(np.arange(ns) % f), _i64((np.arange(ns) // f) % 2),
            f, 2, None, None)


def _weighted(rows):
    def make(rng):
        ns, f, c = 30000, 80, 5
        w = (torch.tensor([1.0, 3.5, 0.5, 2.0, 7.25]) if not rows
             else _f32(rng.uniform(0.3, 4.0, (f, c))))
        mask = None if not rows else torch.from_numpy(rng.random(f) < 0.5)
        return (_f32(rng.integers(0, 40, (3, ns))), _i64(rng.integers(0, f + 1, ns)),
                _i64(rng.integers(0, c, ns)), f, c, w, mask)
    return make


def _k20_1m(rng):
    """A level of the recipe's shape, cut: K = 20 slots of byte features
    (and two float ones) over 2^20 entries, 2000 segments, 9 classes."""
    ns, f = 1 << 20, 2000
    vals = rng.integers(0, 256, (20, ns)).astype(np.float32)
    vals[3] = rng.normal(size=ns)
    vals[11] = rng.uniform(0.5, 15.0, ns)
    return (_f32(vals), _i64(rng.integers(0, f + 1, ns)),
            _i64(rng.integers(0, 9, ns)), f, 9, None, None)


CASES = {
    "single_segment": _single_segment,
    "many_segments_inactive_tail": _many_segments,
    "no_inactive": _no_inactive,
    "mostly_inactive_empty_segments": _mostly_inactive,
    "all_inactive": _all_inactive,
    "one_entry": _one_entry,
    "gaps_around_1e-6": _gaps,
    "signed_zeros": _signed_zeros,
    "objective_ties": _objective_ties,
    "weighted_c": _weighted(False),
    "weighted_fc_partial_mask": _weighted(True),
    "k20_1m": _k20_1m,
}


def _sorted(vals, seg):
    key = (seg << 32)[None, :] + T._float_order(vals)
    return torch.sort(key, dim=1)


def _search_both(dev, case):
    vals, seg, cls, f, c, w, mask = (
        a.to(dev) if isinstance(a, torch.Tensor) else a
        for a in CASES[case](np.random.default_rng(sorted(CASES).index(case))))
    sorted_key, order = _sorted(vals, seg)
    got = split_search_cuda.search(sorted_key, order, vals, seg, cls, w, mask,
                                   f, c, T._log2_table(vals.shape[1], dev))
    want = T._split_search_plain(sorted_key, order, vals, seg, cls, w, f, c,
                                 mask)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_equal_the_plain_search(dev, case):
    got, want = _search_both(dev, case)
    torch.cuda.synchronize()
    for name, g, w in zip(OUTPUTS, got, want):
        w = w.to(torch.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (
            f"{case}: {name} differs at "
            f"{(g.view(torch.int32) != w.view(torch.int32)).nonzero()[:5].tolist()}")
    if case not in ("all_inactive", "one_entry"):
        assert bool(torch.isfinite(want[0]).any()), case


@pytest.mark.cuda
def test_split_search_takes_the_kernels_once_a_call(dev):
    vals, seg, cls, f, c, _, _ = (a.to(dev) if isinstance(a, torch.Tensor) else a
                                  for a in _no_inactive(np.random.default_rng(5)))
    before = split_search_cuda.launches.value
    got = T._split_search(vals, seg, cls, None, f, c)
    torch.cuda.synchronize()
    assert split_search_cuda.launches.value == before + 1
    want = T._split_search_plain(*_sorted(vals, seg), vals, seg, cls, None, f, c)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.to(torch.float32).view(torch.int32))


def _rows(n, seed):
    """Training rows of the recipe's kind, cut: byte patch values and float
    tails, two label layers (8 and 9 classes) tied to them with noise."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 40)).astype(np.float32)
    x[:, 36:] = rng.normal(size=(n, 4)).astype(np.float32) * [1.0, 2.0, 0.5, 3.0]
    mat = np.clip((x[:, 0] + x[:, 5] + 64 * x[:, 36]) // 70, 0, 7)
    obj = np.clip((x[:, 2] + x[:, 9] + x[:, 20]) // 90 + (x[:, 37] > 1), 0, 8)
    noise = rng.random(n) < 0.1
    mat[noise] = rng.integers(0, 8, int(noise.sum()))
    return x, np.stack([mat, obj], 1).astype(np.int64)


@pytest.mark.cuda
def test_learn_equals_the_reference_one_search_a_level(dev):
    x, y = _rows(30000, 3)
    counts = [8, 9]
    levels, searches = (profiling.counter("train.levels"), split_search_cuda.launches)
    before = (levels.value, searches.value)
    forest = T.ForestTrainer(T.TrainerConfig(), dev).learn(
        x, y, class_counts=counts, multi_label=True, progress=False)
    assert levels.value - before[0] == searches.value - before[1] > 10
    xt = torch.from_numpy(x).to(dev)
    for t in range(forest.num_trees):
        want = ref_train.grow_tree(xt, y, counts, t)
        v = forest.tree_view(t)
        assert len(want.split) > 100
        assert ref_train.tree_mismatch(v.split_feature, v.threshold,
                                       v.left_child, v.leaf_hist, want) == 0.0, t


# -- the CPU: dispatch and the wrapper's contract


def _inputs(k=2, ns=300, f=5, c=3, seed=0):
    vals, seg, cls, *_ = _no_inactive(np.random.default_rng(seed))
    vals, seg, cls = vals[:k, :ns].contiguous(), seg[:ns] % f, cls[:ns] % c
    sorted_key, order = _sorted(vals, seg)
    return dict(sorted_key=sorted_key, order=order, vals=vals, seg=seg, cls=cls,
                class_weights=None, weighted=None, num_segments=f,
                num_classes=c, table=T._log2_table(ns, "cpu"))


def test_cpu_search_keeps_the_plain_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernels")

    monkeypatch.setattr(split_search_cuda, "search", refuse)
    a = _inputs()
    before = split_search_cuda.launches.value
    got = T._split_search(a["vals"], a["seg"], a["cls"], None, 5, 3)
    assert split_search_cuda.launches.value == before
    want = T._split_search_plain(a["sorted_key"], a["order"], a["vals"],
                                 a["seg"], a["cls"], None, 5, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(torch.isfinite(got[0]).all())


def test_learn_on_the_cpu_counts_no_search():
    x, y = _rows(600, 1)
    levels = profiling.counter("train.levels")
    before = (levels.value, split_search_cuda.launches.value)
    T.ForestTrainer(T.TrainerConfig(num_trees=2, max_depth=5, min_split_examples=5),
                    "cpu").learn(x, y, class_counts=[8, 9], progress=False)
    assert levels.value > before[0]
    assert split_search_cuda.launches.value == before[1]


def test_bound_reads_the_active_stream_once():
    b = roofline.split_search_bound(20, 1000, 600, 50, 10, 9)
    assert b["bound_bytes"] == 16 * 20 * 600 + 16 * 1000 + 16 * 20 * 10
    assert b["bound_by"] == "bytes" and b["bound_ops"] == 41 * 50


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        split_search_cuda.search(**_inputs())


def _with(**changes):
    a = _inputs()
    for name, fn in changes.items():
        a[name] = fn(a)
    return a


@pytest.mark.parametrize("changes,match", [
    (dict(vals=lambda a: a["vals"].double()), "vals"),
    (dict(vals=lambda a: a["vals"][0]), "vals"),
    (dict(sorted_key=lambda a: a["sorted_key"].to(torch.int32)), "sorted_key"),
    (dict(order=lambda a: a["order"][:, 1:]), "order"),
    (dict(seg=lambda a: a["seg"].to(torch.int32)), "seg"),
    (dict(cls=lambda a: a["cls"][1:]), "cls"),
    (dict(num_classes=lambda a: split_search_cuda.MAX_CLASSES + 1), "classes"),
    (dict(num_segments=lambda a: 0), "segment"),
    (dict(table=lambda a: a["table"][:-1]), "table"),
    (dict(table=lambda a: a["table"].double()), "table"),
    (dict(class_weights=lambda a: torch.ones(4)), "class_weights"),
    (dict(class_weights=lambda a: torch.ones((5, 3), dtype=torch.float64)),
     "class_weights"),
    (dict(weighted=lambda a: torch.ones(5)), "weighted"),
    (dict(weighted=lambda a: torch.ones(4, dtype=torch.bool)), "weighted"),
], ids=["vals_dtype", "vals_shape", "key_dtype", "order_shape", "seg_dtype",
        "cls_shape", "classes", "segments", "table_short", "table_dtype",
        "weights_shape", "weights_dtype", "weighted_dtype", "weighted_shape"])
def test_wrapper_refuses_what_the_kernels_cannot_take(changes, match):
    with pytest.raises(ValueError, match=match):
        split_search_cuda.search(**_with(**changes))
