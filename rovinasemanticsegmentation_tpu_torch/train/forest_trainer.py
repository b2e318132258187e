"""Random-forest training: breadth-first growth with an exact sort-based (or
binned) split search over every frontier node of a level at once.

Counterpart of ``rovinasemanticsegmentation_tpu/train/forest_trainer.py``,
after the libforest learners (``learning.cpp:363-1113``). Preserved
semantics, as there:

- bootstrap sampling with replacement, default size = dataset size;
- per node in the multi-label case a label layer is drawn uniformly and the
  split optimises that layer's entropy only (learning.cpp:489-493);
- ``numFeatures = ceil(sqrt(D))`` features sampled per node without
  replacement (:367, :543-546);
- unnormalised entropy ``sum_c -h_c log2 h_c + m log2 m`` summed over both
  children; candidate thresholds between consecutive sorted values, skipped
  when the gap < 1e-6, threshold = midpoint (:576-603);
- stops: node mass < minSplitExamples, purity, depth > maxDepth, child mass
  < minChildSplitExamples (:525, :606);
- leaf histograms refit on the full dataset with inverted class frequency
  weights and log smoothing (:918-1012).

The random draws are the reference package's, so the port grows its trees:
host growth (``device_growth=False``) draws layers and feature subsets from
numpy (``default_rng((seed, t))``), device growth draws them with
``train/random.py``'s threefry, JAX's own stream. Bootstrap indices and the
per-tree device seed come from the same numpy stream, in JAX's order.

The idiom is the GPU's, not the TPU's. A level is one batched step over its
K feature slots (``[K, Ns]``); the (segment, value) sort is one int64 sort
on the segment in the high word and the order-preserving float bits in the
low word; per-segment class totals and offsets come from integer counts;
the per-segment argmin is a ``scatter_reduce("amin")`` on the objective and
then on the position where it is reached (the earliest, as JAX's segmented
scan keeps). Counts are integer ``bincount``s, never float atomics, so a
run on the card is deterministic. The level loop is a Python loop with one
host read per level (the number of splits), and the frontier has its true
size: the threefry draws do not depend on it, so the port needs none of
JAX's static buckets or overflow retries. Trees grow one after another in
the one loop of :meth:`ForestTrainer.learn` (each by
:meth:`ForestTrainer.grow_tree`), for host and device growth
alike: JAX's fused forest, every tree in one dispatch, is the TPU's idiom
for the same trees.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.forest import Forest, TreeArrays, build_forest
from ..utils.config import Config
from . import random as jrandom

log = logging.getLogger(__name__)

# Elements of one binned histogram chunk ([slots, F, C, B]); slots are
# searched in chunks so that a wide frontier does not hold K such tensors.
_BINNED_CHUNK = 1 << 26


@dataclass
class TrainerConfig:
    """Knobs of DecisionTreeLearner/RandomForestLearner (learning.h:107-456)."""

    num_trees: int = 4
    max_depth: int = 30
    min_split_examples: int = 50
    min_child_split_examples: int = 1
    num_features: int = 0  # 0 = autoconf ceil(sqrt(D))
    use_bootstrap: bool = True
    num_bootstrap_examples: int = 0  # 0 = autoconf dataset size
    smoothing: float = 1.0
    seed: int = 0
    # Weight split entropies by the inverted class frequency of the
    # bootstrap sample; single-label only (learning.cpp:498).
    use_class_frequency: bool = False
    # Draw each level's layers and feature subsets with the threefry stream
    # of the reference's device growth instead of the host numpy stream.
    device_growth: bool = True
    # > 0: binned split search over this many dataset-wide quantile bins
    # per feature (device growth only); 0 = exact search.
    split_bins: int = 0

    @classmethod
    def from_config(cls, conf: Config, seed: int = 0) -> "TrainerConfig":
        """train.cpp:225-239."""
        return cls(
            num_trees=conf.get_int("num_trees"),
            max_depth=conf.get_int("max_depth"),
            min_split_examples=conf.get_int("min_split_sample"),
            seed=seed,
        )


# ======================================================================
# Split search
# ======================================================================


def _class_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the (short) class axis in class order, as XLA reduces it."""
    out = t.select(dim, 0)
    for c in range(1, t.shape[dim]):
        out = out + t.select(dim, c)
    return out


def _unnormalized_entropy(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """sum_c -h_c log2 h_c + m log2 m over ``dim`` (ENTROPY macro)."""
    mass = _class_sum(counts, dim)
    term = torch.where(
        counts > 0, -counts * torch.log2(counts.clamp_min(1e-30)), 0.0
    )
    mass_term = torch.where(
        mass > 0, mass * torch.log2(mass.clamp_min(1e-30)), 0.0
    )
    return _class_sum(term, dim) + mass_term


@functools.lru_cache(maxsize=8)
def _log2_table(n: int, device: torch.device) -> torch.Tensor:
    """float32 log2 of 0..n (log2 0 := 0), rounded once from float64 on the
    host: the same numbers on every device."""
    t = np.zeros(n + 1, np.float64)
    np.log2(np.arange(n + 1, dtype=np.float64), out=t, where=np.arange(n + 1) > 0)
    return torch.from_numpy(t.astype(np.float32)).to(device)


def _entropy(
    counts: torch.Tensor,  # integer counts
    class_weights: Optional[torch.Tensor],  # broadcastable to counts, or None
    max_count: int,
    dim: int,
) -> torch.Tensor:
    """:func:`_unnormalized_entropy` of the class-weighted counts. Unweighted
    (``class_weights`` None), the logs of the integer counts come from
    :func:`_log2_table`, so a search gives the same objectives on the card
    as on the CPU and picks the same splits."""
    if class_weights is not None:
        return _unnormalized_entropy(counts.to(torch.float32) * class_weights,
                                     dim)
    table = _log2_table(max_count, counts.device)
    term = torch.where(
        counts > 0, -counts.to(torch.float32) * table[counts.long()], 0.0)
    mass = _class_sum(counts, dim).long()
    return _class_sum(term, dim) + mass.to(torch.float32) * table[mass]


def _weights_or_none(class_weights, device=None) -> Optional[torch.Tensor]:
    """The class weights (numpy or a tensor) as a float32 tensor on
    ``device``, or None when all are 1."""
    if class_weights is None:
        return None
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=device)
    return None if bool((w == 1).all()) else w


def _count(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Integer histogram of ``idx`` over ``[0, size)``; index ``size`` is the
    drop bin for masked elements."""
    return torch.bincount(idx.reshape(-1), minlength=size + 1)[:size]


def _float_order(vals: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) ordered as the float32 ``vals`` (-0.0 as +0.0)."""
    v = torch.where(vals == 0, torch.zeros_like(vals), vals)
    bits = v.view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits + 2**31, -bits - 1)


def _split_search(
    vals: torch.Tensor,  # [K, Ns] float32, one row per feature slot
    seg: torch.Tensor,  # [Ns] int64 frontier slot, num_segments = inactive
    cls: torch.Tensor,  # [Ns] int64 class of the node's chosen layer
    class_weights: Optional[torch.Tensor],  # [C] float32, None = unweighted
    num_segments: int,
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best split per (slot, segment): (objective, threshold, left mass,
    right mass), each [K, F]; objective = +inf where no split is valid, and
    then the other three are read at the last sorted position, as JAX does."""
    f, c = num_segments, num_classes
    k, ns = vals.shape
    dev = vals.device
    key = (seg << 32)[None, :] + _float_order(vals)
    sorted_key, order = torch.sort(key, dim=1)
    sorted_seg = sorted_key >> 32
    sorted_vals = torch.gather(vals, 1, order)
    active = sorted_seg < f

    # Class totals and exclusive offsets per segment (the same for every
    # slot): the stream is segment-sorted, so a position's left counts are
    # its exclusive class prefix minus its segment's offset. Classes ride
    # the middle axis, so that the prefix runs along the contiguous one.
    active_in = seg < f
    tot = _count(torch.where(active_in, seg * c + cls, (f + 1) * c),
                 (f + 1) * c).view(f + 1, c).T.to(torch.int32)  # [C, F+1]
    offs = torch.cumsum(tot, 1, dtype=torch.int32) - tot
    classes = torch.arange(c, device=dev)[:, None]
    onehot = (cls[order][:, None, :] == classes) & active[:, None, :]
    seg_c = sorted_seg.clamp(max=f)
    left = torch.cumsum(onehot, 2, dtype=torch.int32)  # [K, C, Ns]
    left -= onehot.to(torch.int32) + offs[:, seg_c].transpose(0, 1)
    right = tot[:, seg_c].transpose(0, 1) - left
    left_mass = left.sum(1)
    right_mass = right.sum(1)

    prev_vals = torch.cat([sorted_vals[:, :1], sorted_vals[:, :-1]], 1)
    prev_seg = torch.cat(
        [torch.full((k, 1), -1, dtype=torch.int64, device=dev),
         sorted_seg[:, :-1]], 1)
    valid = (
        active
        & (sorted_seg == prev_seg)
        & (sorted_vals - prev_vals >= 1e-6)  # learning.cpp:576-583
        & (left_mass > 0)
    )
    # Entropy on class-weighted counts; masses stay unweighted (:220-258).
    cw = None if class_weights is None else class_weights[:, None]
    objective = torch.where(
        valid,
        _entropy(left, cw, ns, 1) + _entropy(right, cw, ns, 1),
        torch.inf,
    )
    threshold = 0.5 * (prev_vals + sorted_vals)

    best_obj = torch.full((k, f + 1), torch.inf, device=dev).scatter_reduce(
        1, seg_c, objective, "amin")
    hit = valid & (objective == torch.gather(best_obj, 1, seg_c))
    pos = torch.where(hit, torch.arange(ns, device=dev), ns - 1)
    best_pos = torch.full((k, f + 1), ns - 1, device=dev).scatter_reduce(
        1, seg_c, pos, "amin")[:, :f]
    return (
        best_obj[:, :f],
        torch.gather(threshold, 1, best_pos),
        torch.gather(left_mass, 1, best_pos).to(torch.float32),
        torch.gather(right_mass, 1, best_pos).to(torch.float32),
    )


def split_search_step(
    vals: torch.Tensor,  # [Ns] feature value per example
    seg: torch.Tensor,  # [Ns] frontier index, num_segments = inactive
    cls: torch.Tensor,  # [Ns] class label per example
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    num_segments: int,
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best split per frontier segment for one feature slot: (objective,
    threshold, left mass, right mass), each [F]."""
    outs = _split_search(
        vals.to(torch.float32)[None], seg.to(torch.int64),
        cls.to(torch.int64), _weights_or_none(class_weights),
        num_segments, num_classes,
    )
    return tuple(o[0] for o in outs)


def multi_slot_split_search(
    x: torch.Tensor,  # [Ns, D]
    feats: torch.Tensor,  # [F, K] sampled feature ids per frontier node
    seg: torch.Tensor,  # [Ns] frontier slot per example (F = inactive)
    seg_search: torch.Tensor,  # [Ns] like seg, masking unsearchable nodes
    cls: torch.Tensor,  # [Ns]
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    num_segments: int,
    num_classes: int,
):
    """All K feature slots of one level as one batched ``[K, Ns]`` search
    (the JAX code scans the slots one by one); each output is [K, F]."""
    seg_c = seg.clamp(max=num_segments - 1)
    vals = torch.gather(x, 1, feats[seg_c]).T.contiguous()  # [K, Ns]
    return _split_search(vals, seg_search, cls, class_weights,
                         num_segments, num_classes)


# ======================================================================
# Binned (histogram) split search
# ======================================================================


def build_feature_bins(
    x_full: torch.Tensor,  # [N, D] float32
    num_bins: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature quantile bins: (bin index [N, D] int32, boundaries
    [D, B-1] float32).

    Boundaries sit at value-transition midpoints of the sorted column,
    picked evenly over its transitions (every transition when a feature has
    at most B-1 of them); ``bin(x) = #(t <= x)``, so ``bin(x) <= j`` exactly
    when ``x < t[j]`` and a boundary is a valid node threshold.
    """
    n, d = x_full.shape
    b = num_bins
    xs = torch.sort(x_full, dim=0).values.T.contiguous()  # [D, N]
    mid = 0.5 * (xs[:, :-1] + xs[:, 1:])
    cums = torch.cumsum((xs[:, 1:] != xs[:, :-1]).to(torch.int64), 1)
    count = cums[:, -1:]  # [D, 1] distinct-value gaps per feature
    k = torch.arange(1, b, dtype=torch.int64, device=x_full.device)
    target = (k[None, :] * count) // b + 1  # transition ordinal, 1-indexed
    pos = torch.searchsorted(cums, target, side="left").clamp(max=n - 2)
    boundaries = torch.where(count > 0, torch.gather(mid, 1, pos), torch.inf)
    xb = torch.searchsorted(boundaries, x_full.T.contiguous(), side="right")
    return xb.T.to(torch.int32).contiguous(), boundaries


def _binned_search(
    bins: torch.Tensor,  # [K, Ns] bin index per example per slot
    seg: torch.Tensor,  # [Ns] frontier slot (num_segments = masked)
    cls: torch.Tensor,  # [Ns]
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    num_segments: int,
    num_classes: int,
    num_bins: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best boundary per (slot, node) from per-(node, class, bin) counts:
    (objective, boundary index, left mass, right mass), each [K, F]."""
    f, c, b = num_segments, num_classes, num_bins
    k = bins.shape[0]
    size = k * f * c * b
    base = (seg.clamp(max=f - 1) * c + cls) * b
    slot = torch.arange(k, device=bins.device)[:, None] * (f * c * b)
    key = torch.where((seg < f)[None, :],
                      slot + base[None, :] + bins.to(torch.int64).clamp(max=b - 1),
                      size)
    hist = _count(key, size).view(k, f, c, b)
    left = torch.cumsum(hist, 3)[..., : b - 1]  # [K, F, C, B-1]
    right = hist.sum(3, keepdim=True) - left
    left_mass = left.sum(2)
    right_mass = right.sum(2)
    cw = None if class_weights is None else class_weights[:, None]
    ns = seg.shape[0]
    objective = torch.where(
        (left_mass > 0) & (right_mass > 0),
        _entropy(left, cw, ns, 2) + _entropy(right, cw, ns, 2),
        torch.inf,
    )  # [K, F, B-1]
    bidx = torch.argmin(objective, dim=2, keepdim=True)  # first minimum
    return (
        torch.gather(objective, 2, bidx)[..., 0],
        bidx[..., 0],
        torch.gather(left_mass, 2, bidx)[..., 0].to(torch.float32),
        torch.gather(right_mass, 2, bidx)[..., 0].to(torch.float32),
    )


def multi_slot_split_search_binned(
    xb: torch.Tensor,  # [Ns, D] int32 bin indices
    boundaries: torch.Tensor,  # [D, B-1]
    feats: torch.Tensor,  # [F, K]
    seg: torch.Tensor,  # [Ns]
    seg_search: torch.Tensor,  # [Ns] masked
    cls: torch.Tensor,  # [Ns]
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    num_segments: int,
    num_classes: int,
    num_bins: int,
):
    """All K slots of one level, binned, in chunks of slots; thresholds are
    read from the boundary table. Each output is [K, F]."""
    seg_c = seg.clamp(max=num_segments - 1)
    bins = torch.gather(xb, 1, feats[seg_c]).T  # [K, Ns]
    per = max(1, _BINNED_CHUNK // (num_segments * num_classes * num_bins))
    parts = [
        _binned_search(bins[s : s + per], seg_search, cls, class_weights,
                       num_segments, num_classes, num_bins)
        for s in range(0, bins.shape[0], per)
    ]
    obj, bidx, lm, rm = (torch.cat(p) for p in zip(*parts))
    return obj, boundaries[feats.T, bidx], lm, rm


# ======================================================================
# One level, and tree growth
# ======================================================================


def node_stats(
    seg: torch.Tensor,  # [Ns]
    labels: torch.Tensor,  # [Ns, L] int64
    num_segments: int,
    num_classes: int,
    num_layers: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mass [F], distinct-class count per layer [F, L]) from one integer
    count per (node, layer, class): the port of both ``node_stats_step``
    and ``node_stats_scatter``."""
    f, c, l = num_segments, num_classes, num_layers
    layer = torch.arange(l, device=seg.device)
    keys = (seg.clamp(max=f - 1)[:, None] * l + layer) * c + labels
    keys = torch.where((seg < f)[:, None], keys, f * l * c)
    counts = _count(keys, f * l * c).view(f, l, c)
    return counts[:, 0, :].sum(1), (counts > 0).sum(2)


def _level_core(
    x: torch.Tensor,  # [Ns, D]
    labels: torch.Tensor,  # [Ns, L] int64
    node_of: torch.Tensor,  # [Ns] int64 tree-node id per example
    base: int,  # id of the first frontier node
    table_len: int,  # tree-table length (children are allocated here)
    feats: torch.Tensor,  # [F, K] int64 sampled feature ids per slot
    layers: torch.Tensor,  # [F] int64 chosen layer per slot
    min_split: int,
    min_child: int,
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    num_classes: int,
    xb: Optional[torch.Tensor] = None,  # [Ns, D] bin indices (binned mode)
    boundaries: Optional[torch.Tensor] = None,  # [D, B-1] (binned mode)
    num_bins: int = 0,  # 0 = exact search
):
    """One level above the depth limit: slot mapping, node stats, stop checks
    (learning.cpp:521-531), the K-slot search, best-slot selection, child-id allocation and the
    example partition. The frontier is the consecutive ids ``[base, base +
    F)``. -> (splitting [F], feature [F], threshold [F], left ids [F],
    new node_of)."""
    f = feats.shape[0]
    num_layers = labels.shape[1]
    seg_raw = node_of - base
    seg = torch.where((seg_raw >= 0) & (seg_raw < f), seg_raw, f)
    seg_c = seg.clamp(max=f - 1)
    cls = torch.gather(labels, 1, layers[seg_c][:, None])[:, 0]
    cls = torch.where(seg < f, cls, 0)

    mass, distinct = node_stats(seg, labels, f, num_classes, num_layers)
    layer_distinct = torch.gather(distinct, 1, layers[:, None])[:, 0]
    searchable = (mass >= min_split) & (layer_distinct > 1)
    seg_search = torch.where(searchable[seg_c] & (seg < f), seg, f)
    if num_bins > 0:
        obj_k, thr_k, lm_k, rm_k = multi_slot_split_search_binned(
            xb, boundaries, feats, seg, seg_search, cls, class_weights,
            f, num_classes, num_bins,
        )
    else:
        obj_k, thr_k, lm_k, rm_k = multi_slot_split_search(
            x, feats, seg, seg_search, cls, class_weights, f, num_classes,
        )

    # Best slot per node; argmin keeps the first minimum, the host sweep's
    # strict-< update order (learning.cpp:588).
    best = torch.argmin(obj_k, dim=0, keepdim=True)  # [1, F]
    best_obj, best_thr, best_lm, best_rm = (
        torch.gather(t, 0, best)[0] for t in (obj_k, thr_k, lm_k, rm_k))
    best_feat = torch.gather(feats, 1, best.T)[:, 0]

    splitting = (
        searchable
        & torch.isfinite(best_obj)
        & (best_lm >= min_child)
        & (best_rm >= min_child)  # learning.cpp:606
    )
    sp = splitting.to(torch.int64)
    left_ids = table_len + 2 * (torch.cumsum(sp, 0) - sp)

    sp_e = splitting[seg_c] & (seg < f)
    xv = torch.gather(x, 1, best_feat[seg_c][:, None])[:, 0]
    node_new = torch.where(
        sp_e, left_ids[seg_c] + (xv >= best_thr[seg_c]).to(torch.int64),
        node_of,
    )
    return splitting, best_feat, best_thr, left_ids, node_new


@dataclass
class TreeTables:
    """A grown tree's node tables on its device; ``depth`` per node."""

    split_feature: torch.Tensor  # [nn] int32
    threshold: torch.Tensor  # [nn] float32
    left_child: torch.Tensor  # [nn] int32
    depth: torch.Tensor  # [nn] int32

    @property
    def num_nodes(self) -> int:
        return self.split_feature.shape[0]

    def numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        return tuple(t.cpu().numpy() for t in (
            self.split_feature, self.threshold, self.left_child, self.depth))


# (layers [F], feats [F, K]) for the level at ``depth`` with F live nodes.
LevelDraws = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def _grow(
    x: torch.Tensor,  # [Ns, D] bootstrap sample on the device
    labels: torch.Tensor,  # [Ns, L] int64
    draws: LevelDraws,
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    cfg: TrainerConfig,
    num_classes: int,
    xb: Optional[torch.Tensor] = None,
    boundaries: Optional[torch.Tensor] = None,
) -> TreeTables:
    """Grow one tree breadth first. Each level's frontier holds the ids
    ``[base, base + F)``, and its children are allocated at the end of the
    table in slot order, as the reference package's host builder and device
    growth both number them. The loop reads one number per level back from
    the device: how many nodes split."""
    ns = x.shape[0]
    dev = x.device
    node_of = torch.zeros(ns, dtype=torch.int64, device=dev)
    levels = []
    nn, base, f_count, depth = 1, 0, 1, 0
    # Past max_depth no node splits (JAX's device loop stops there; its host
    # loop runs one more level that splits nothing).
    while f_count > 0 and depth <= cfg.max_depth:
        layers, feats = draws(depth, f_count)
        splitting, feat, thr, left_ids, node_of = _level_core(
            x, labels, node_of, base, nn, feats, layers,
            cfg.min_split_examples, cfg.min_child_split_examples,
            class_weights, num_classes,
            xb=xb, boundaries=boundaries,
            num_bins=cfg.split_bins if xb is not None else 0,
        )
        splits = int(splitting.sum())  # the level's one host read
        levels.append((splitting, feat, thr, left_ids))
        base, nn, f_count, depth = nn, nn + 2 * splits, 2 * splits, depth + 1

    zero_i = torch.zeros(f_count, dtype=torch.int64, device=dev)
    sf = [torch.where(s, f, 0) for s, f, _, _ in levels] + [zero_i]
    th = [torch.where(s, t, 0.0) for s, _, t, _ in levels]
    th.append(torch.zeros(f_count, device=dev))
    lc = [torch.where(s, l, 0) for s, _, _, l in levels] + [zero_i]
    dep = [torch.full_like(s, d, dtype=torch.int64)
           for d, (s, _, _, _) in enumerate(levels)]
    dep.append(torch.full_like(zero_i, depth))
    return TreeTables(
        split_feature=torch.cat(sf).to(torch.int32),
        threshold=torch.cat(th),
        left_child=torch.cat(lc).to(torch.int32),
        depth=torch.cat(dep).to(torch.int32),
    )


def _num_features(cfg: TrainerConfig, d: int) -> int:
    return cfg.num_features or int(math.ceil(math.sqrt(d)))


def host_draws(rng: np.random.Generator, num_layers: int, d: int, k: int,
               device) -> LevelDraws:
    """The host growth's numpy draws (JAX ``_grow_tree``): per level, the
    layers, then one permutation's first ``k`` features per node."""

    def draw(depth: int, f: int):
        layers = rng.integers(0, num_layers, size=f)
        feats = np.stack([rng.permutation(d)[:k] for _ in range(f)])
        return (torch.from_numpy(layers.astype(np.int64)).to(device),
                torch.from_numpy(feats.astype(np.int64)).to(device))

    return draw


def device_draws(seed: int, num_layers: int, d: int, k: int,
                 device) -> LevelDraws:
    """The device growth's threefry draws (JAX ``grow_tree_device``): per
    level ``split(fold_in(PRNGKey(seed), depth))``, layers by ``randint``
    and features as the top ``k`` of per-slot uniforms, the level's three
    draws in one evaluation of the hash."""
    key = jrandom.prng_key(seed)

    def draw(depth: int, f: int):
        k_lay, k_feat = jrandom.split(jrandom.fold_in(key, depth))
        k_hi, k_lo = jrandom.split(k_lay)
        hi, lo, bits = jrandom.random_bits_many(
            [(k_hi, (f,)), (k_lo, (f,)), (k_feat, (f, d))], device)
        layers = jrandom.randint_from_bits(hi, lo, 0, num_layers)
        _, feats = jrandom.top_k(jrandom.uniform_from_bits(bits), k)
        return layers.to(torch.int64), feats

    return draw


def grow_tree_device(
    x: torch.Tensor,  # [Ns, D]
    labels: torch.Tensor,  # [Ns, L] int64
    seed: int,  # uint32 threefry seed of this tree
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    cfg: TrainerConfig,
    num_classes: int,
    xb: Optional[torch.Tensor] = None,  # [Ns, D] bin indices (binned mode)
    boundaries: Optional[torch.Tensor] = None,  # [D, B-1] (binned mode)
) -> TreeTables:
    """One tree with the device growth's draws, exact or binned."""
    d = x.shape[1]
    draws = device_draws(seed, labels.shape[1], d, _num_features(cfg, d),
                         x.device)
    return _grow(x, labels, draws, class_weights, cfg, num_classes,
                 xb=xb, boundaries=boundaries)


def _grow_tree(
    x: torch.Tensor,  # [Ns, D]
    labels: torch.Tensor,  # [Ns, L] int64
    class_weights: Optional[torch.Tensor],  # [C], None = unweighted
    cfg: TrainerConfig,
    rng: np.random.Generator,
    num_classes: int,
) -> TreeTables:
    """One tree with the host growth's numpy draws (exact search)."""
    d = x.shape[1]
    draws = host_draws(rng, labels.shape[1], d, _num_features(cfg, d),
                       x.device)
    return _grow(x, labels, draws, class_weights, cfg, num_classes)


def _tree_class_weights(
    cfg: TrainerConfig, y: np.ndarray, ns: int, num_classes: int
) -> np.ndarray:
    """Per-tree class weights (inverted frequency when enabled; unsupported
    in the multi-label case, learning.cpp:498)."""
    num_layers = y.shape[1]
    weights = np.ones(num_classes, np.float32)
    if cfg.use_class_frequency:
        if num_layers > 1:
            log.warning(
                "class frequency weighting is not supported in the "
                "multi-label case (libforest parity); proceeding unweighted"
            )
        else:
            counts = np.bincount(
                y[:, 0].astype(np.int64), minlength=num_classes
            ).astype(np.float32)
            weights = np.where(counts > 0, ns / np.maximum(counts, 1), 1.0)
    return weights.astype(np.float32)


def _bootstrap(rng: np.random.Generator, cfg: TrainerConfig, n: int,
               n_bootstrap: int) -> np.ndarray:
    """A tree's sample indices: the first draw of its stream, or all rows."""
    if cfg.use_bootstrap:
        return rng.integers(0, n, size=n_bootstrap)
    return np.arange(n)


def _tree_seed(rng: np.random.Generator) -> int:
    """The device growth's threefry seed: the draw after the bootstrap."""
    return int(np.uint32(rng.integers(0, 2**32, dtype=np.uint64)))


# ======================================================================
# Leaf histogram refit (updateMultiHistograms, learning.cpp:963-1012)
# ======================================================================


def _leaf_histograms_all(
    x: torch.Tensor,  # [N, D] full dataset
    labels: torch.Tensor,  # [N, L] int64
    freqs: torch.Tensor,  # [L, C] inverted class frequency per layer
    tree: TreeTables,
    num_classes: int,
) -> torch.Tensor:  # [nn, L, C] float32 weighted counts
    """Descend the full dataset once and count examples per (node, layer,
    class) as integers, then weight each count by its class frequency once
    (JAX adds the float32 weight per example: float32 rounding apart, the
    same numbers)."""
    sf = tree.split_feature.to(torch.int64)
    lc = tree.left_child.to(torch.int64)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(int(tree.depth.max())):
        xv = torch.gather(x, 1, sf[node][:, None])[:, 0]
        nxt = lc[node] + (xv >= tree.threshold[node]).to(torch.int64)
        node = torch.where(lc[node] == 0, node, nxt)
    nn, num_layers, c = tree.num_nodes, labels.shape[1], num_classes
    layer = torch.arange(num_layers, device=x.device)
    keys = (node[:, None] * num_layers + layer) * c + labels
    counts = _count(keys, nn * num_layers * c).view(nn, num_layers, c)
    return counts.to(torch.float32) * freqs


def _inverted_class_frequency(labels: np.ndarray, c: int) -> np.ndarray:
    """data.h:345-369: size / per-class count."""
    counts = np.bincount(labels, minlength=c).astype(np.float64)
    return np.where(counts > 0, len(labels) / np.maximum(counts, 1), 0.0).astype(
        np.float32
    )


def _smooth_histograms(
    raw_all: np.ndarray,  # [nn, L, c_max] weighted counts
    left_child: np.ndarray,  # [nn]
    class_counts: Sequence[int],
    smoothing: float,
) -> np.ndarray:
    """Log smoothing per layer (learning.cpp:997); inner nodes zeroed."""
    nn, num_layers, c_max = raw_all.shape
    hist = np.zeros((nn, num_layers, c_max), np.float32)
    for l in range(num_layers):
        c = class_counts[l]
        raw = raw_all[:, l, :c]
        total = raw.sum(axis=1, keepdims=True)
        hist[:, l, :c] = np.log((raw + smoothing) / (total + c * smoothing))
    hist *= (left_child == 0)[:, None, None]
    return hist


# ======================================================================
# The public trainer
# ======================================================================


def _as_labels(labels) -> np.ndarray:
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.ascontiguousarray(labels)
    return labels[:, None] if labels.ndim == 1 else labels


@dataclass
class TrainingData:
    """A training set staged on one device for :meth:`ForestTrainer.grow_tree`."""

    x: torch.Tensor  # [N, D] float32
    labels: np.ndarray  # [N, L] host labels (bootstrap and class weights)
    labels_dev: torch.Tensor  # [N, L] int64
    freqs: torch.Tensor  # [L, C_max] inverted class frequency per layer
    bins: Optional[torch.Tensor]  # [N, D] bin indices (binned search)
    boundaries: Optional[torch.Tensor]  # [D, B-1] (binned search)
    class_counts: List[int]
    multi_label: bool


class ForestTrainer:
    """RandomForestLearner equivalent over dense feature/label tensors on
    one device (``"cuda"`` by default; ``"cpu"`` runs the same torch ops)."""

    def __init__(self, config: TrainerConfig, device: torch.device | str = "cuda"):
        self.config = config
        self.device = resolve_device(device)

    def prepare(
        self,
        features,  # [N, D] float32, numpy or a tensor (kept on its device)
        labels,  # [N, L] int (all >= 0), numpy or a tensor
        class_counts: Optional[Sequence[int]] = None,
        multi_label: Optional[bool] = None,
    ) -> TrainingData:
        """Stage a training set on this trainer's device."""
        if isinstance(features, torch.Tensor):
            x_full = features.to(device=self.device, dtype=torch.float32)
        else:
            x_full = torch.from_numpy(
                np.ascontiguousarray(features, dtype=np.float32)
            ).to(self.device)
        x_full = x_full.contiguous()
        labels = _as_labels(labels)
        num_layers = labels.shape[1]
        if multi_label is None:
            multi_label = num_layers > 1
        if class_counts is None:
            class_counts = [int(labels[:, l].max()) + 1 for l in range(num_layers)]
        c_max = max(class_counts)
        freqs_np = np.zeros((num_layers, c_max), np.float32)
        for l in range(num_layers):
            freqs_np[l, : class_counts[l]] = _inverted_class_frequency(
                labels[:, l].astype(np.int64), class_counts[l]
            )
        bins = bnd = None
        if self.config.split_bins > 0 and self.config.device_growth:
            bins, bnd = build_feature_bins(x_full, num_bins=self.config.split_bins)
        return TrainingData(
            x=x_full,
            labels=labels,
            labels_dev=torch.from_numpy(labels.astype(np.int64)).to(self.device),
            freqs=torch.from_numpy(freqs_np).to(self.device),
            bins=bins,
            boundaries=bnd,
            class_counts=[int(c) for c in class_counts],
            multi_label=bool(multi_label),
        )

    def grow_tree(self, data: TrainingData, t: int,
                  progress: bool = False) -> TreeArrays:
        """Grow tree ``t`` from its own stream ``default_rng((seed, t))`` and
        refit its leaf histograms on the whole set: the same tree whichever
        trees were grown before it, and on whichever device."""
        cfg = self.config
        start = time.perf_counter()
        n = data.x.shape[0]
        c_max = max(data.class_counts)
        rng = np.random.default_rng((cfg.seed, t))
        idx = _bootstrap(rng, cfg, n, cfg.num_bootstrap_examples or n)
        idx_dev = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        cw = _weights_or_none(
            _tree_class_weights(cfg, data.labels[idx], len(idx), c_max),
            self.device)
        xb, yb = data.x[idx_dev], data.labels_dev[idx_dev]
        if cfg.device_growth:
            tables = grow_tree_device(
                xb, yb, _tree_seed(rng), cw, cfg, c_max,
                xb=None if data.bins is None else data.bins[idx_dev],
                boundaries=data.boundaries,
            )
        else:
            tables = _grow_tree(xb, yb, cw, cfg, rng, c_max)
        raw = _leaf_histograms_all(data.x, data.labels_dev, data.freqs, tables,
                                   c_max)
        sf, th, lc, _ = tables.numpy()
        tree = TreeArrays(
            split_feature=sf, threshold=th, left_child=lc,
            leaf_hist=_smooth_histograms(
                raw.cpu().numpy(), lc, data.class_counts, cfg.smoothing),
        )
        if progress:
            log.info(
                "Finished tree %d/%d: %d nodes, depth %d, %.1fs",
                t + 1, cfg.num_trees, tables.num_nodes,
                int(tables.depth.max()), time.perf_counter() - start,
            )
        return tree

    def learn(
        self,
        features,  # [N, D] float32, numpy or a tensor (kept on its device)
        labels,  # [N, L] int (all >= 0), numpy or a tensor
        class_counts: Optional[Sequence[int]] = None,
        multi_label: Optional[bool] = None,
        progress: bool = True,
        checkpoint_path: Optional[str] = None,
    ) -> Forest:
        """Train the forest; with ``checkpoint_path``, save after each tree
        and resume from a partial checkpoint."""
        cfg = self.config
        data = self.prepare(features, labels, class_counts, multi_label)
        class_counts, multi_label = data.class_counts, data.multi_label

        start_tree = 0
        trees: List[TreeArrays] = []
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            from ..utils.checkpoint import TrainingCheckpoint

            ckpt, partial = TrainingCheckpoint.load(checkpoint_path)
            if partial is not None and ckpt.completed_trees > 0:
                start_tree = min(ckpt.completed_trees, cfg.num_trees)
                trees = [partial.tree_view(t) for t in range(start_tree)]
                if progress:
                    log.info("Resuming training at tree %d/%d",
                             start_tree + 1, cfg.num_trees)

        for t in range(start_tree, cfg.num_trees):
            trees.append(self.grow_tree(data, t, progress))
            if checkpoint_path is not None:
                from ..utils.checkpoint import TrainingCheckpoint

                TrainingCheckpoint(
                    completed_trees=t + 1,
                    seed=cfg.seed,
                    config=dict(cfg.__dict__),
                ).save(checkpoint_path,
                       build_forest(trees, class_counts, multi_label=multi_label))

        return build_forest(trees, class_counts, multi_label=multi_label)
