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
low word. After the sort, the card runs ``csrc/split_search.cu``: the
class prefixes, both children's entropies and the per-segment minimum in one
pass over the sorted stream, with one 64-bit ``atomicMin`` of (objective,
position) a run of a segment. The plain search, the CPU's, takes per-segment
class totals and offsets from integer counts and the per-segment argmin as
a ``scatter_reduce("amin")`` on the objective and then on the position where
it is reached (the earliest, as JAX's segmented scan keeps), with the
entries that cannot win spread over spare targets. Counts are integers,
never float atomics, so a run on the card is deterministic.

One level loop (:func:`_grow`) grows a list of trees together, as JAX's
``grow_forest_device`` grows a forest in one dispatch: each level is one
such step over the concatenated frontiers of the trees that still have one
(a segment is its tree's frontier offset plus its slot), with one host read
(each tree's number of splits). Each tree keeps its own bootstrap rows
(its features are read through them, never copied out), draws, class
weights, node table and depth, and nothing of one tree's step depends on
another's, so every tree comes out bit for bit as it grows alone. The
frontier has its true size, and the threefry draws do not depend on it, so
none of JAX's static buckets (``_forest_buckets``) or overflow retries are
needed. :meth:`ForestTrainer.learn` grows the whole forest in this one loop
and refits it in one descent unless a checkpoint is asked for; then it
grows one tree at a time (:meth:`ForestTrainer.grow_tree`, the same loop
with one tree) and saves after each. JAX fuses only device growth; host
growth goes through the one loop too, each tree drawing from its own numpy
stream in its own order, so its trees are JAX's per-tree ones.
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
from ..ops import split_search_cuda
from ..utils import profiling
from ..utils.config import Config
from . import random as jrandom

log = logging.getLogger(__name__)
train_levels = profiling.counter("train.levels")  # levels the loop stepped
train_nodes = profiling.counter("train.nodes")  # nodes of the grown trees

# Elements of one binned histogram chunk ([slots, F, C, B]); slots are
# searched in chunks so that a wide frontier does not hold K such tensors.
_BINNED_CHUNK = 1 << 26
# Elements of one plain exact search's class prefixes ([slots, C, Ns]): a
# forest's level stream holds every tree's samples, so its slots go in chunks
# past it. The card's kernels hold no such tensor and take every slot at once.
_EXACT_CHUNK = 1 << 28
# Spare drop targets of a count or a segment minimum (``_spare``).
_SPARE = 1 << 12


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


def _pair_entropy(
    left: torch.Tensor,  # integer counts
    right: torch.Tensor,
    class_weights: Optional[torch.Tensor],  # broadcastable to the counts
    weighted: Optional[torch.Tensor],  # broadcastable to the class sum
    max_count: int,
    dim: int,
) -> torch.Tensor:
    """Both children's :func:`_entropy`: class-weighted where ``weighted``
    (everywhere when it is None), the unweighted log-table form elsewhere
    and everywhere when ``class_weights`` is None. A forest's trees keep the
    form each takes alone."""

    def both(w):
        return (_entropy(left, w, max_count, dim)
                + _entropy(right, w, max_count, dim))

    if class_weights is None:
        return both(None)
    if weighted is None:
        return both(class_weights)
    return torch.where(weighted, both(class_weights), both(None))


def _segment_rows(table: torch.Tensor, seg: torch.Tensor, fill) -> torch.Tensor:
    """``table[seg]`` for a per-segment ``table`` ([F, ...]), ``fill`` where
    ``seg`` is F (inactive)."""
    return torch.cat([table, torch.full_like(table[:1], fill)])[seg]


def _take(x: torch.Tensor, rows: Optional[torch.Tensor],
          cols: torch.Tensor) -> torch.Tensor:
    """``x[rows[i], cols[i, j]]`` ([Ns, J]); ``rows`` None: x's own rows."""
    if rows is None:
        return torch.gather(x, 1, cols)
    return x[rows[:, None], cols]


def _spare(n: int, first: int, device) -> torch.Tensor:
    """Element ``i`` of ``n``'s own spare index, ``first + i % _SPARE``: the
    target of an element whose count or minimum is dropped. One shared drop
    target would take the atomic of every such element, most of a deep
    level's stream, and cost the card time that varies with the data."""
    return first + torch.arange(n, device=device) % _SPARE


def _count(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Integer histogram of ``idx`` over ``[0, size)``; index ``size`` marks
    masked elements, which are counted in spare bins past it."""
    flat = idx.reshape(-1)
    flat = torch.where(flat < size, flat, _spare(flat.numel(), size, flat.device))
    return torch.bincount(flat, minlength=size + _SPARE)[:size]


def _float_order(vals: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) ordered as the float32 ``vals`` (-0.0 as +0.0)."""
    v = torch.where(vals == 0, torch.zeros_like(vals), vals)
    bits = v.view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits + 2**31, -bits - 1)


def _split_search(
    vals: torch.Tensor,  # [K, Ns] float32, one row per feature slot
    seg: torch.Tensor,  # [Ns] int64 frontier slot, num_segments = inactive
    cls: torch.Tensor,  # [Ns] int64 class of the node's chosen layer
    class_weights: Optional[torch.Tensor],  # [C] or per segment [F, C]; None = unweighted
    num_segments: int,
    num_classes: int,
    weighted: Optional[torch.Tensor] = None,  # [F] bool: weights apply (None = all)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best split per (slot, segment): (objective, threshold, left mass,
    right mass), each [K, F]; objective = +inf where no split is valid, and
    then the other three are read at the last sorted position, as JAX does.
    The (segment, value) sort, then on a CUDA tensor ``csrc/split_search.cu``
    (``ops/split_search_cuda.py``, which raises beyond its limits), elsewhere
    :func:`_split_search_plain`. Both give the same bits."""
    key = (seg << 32)[None, :] + _float_order(vals)
    sorted_key, order = torch.sort(key, dim=1)
    if vals.device.type == "cuda":
        return split_search_cuda.search(
            sorted_key, order, vals, seg, cls, class_weights, weighted,
            num_segments, num_classes, _log2_table(vals.shape[1], vals.device))
    return _split_search_plain(sorted_key, order, vals, seg, cls, class_weights,
                               num_segments, num_classes, weighted)


def _split_search_plain(
    sorted_key: torch.Tensor,  # [K, Ns] int64 sorted (seg << 32) + value order
    order: torch.Tensor,  # [K, Ns] int64 the sort's indices
    vals: torch.Tensor,  # [K, Ns] float32
    seg: torch.Tensor,  # [Ns] int64
    cls: torch.Tensor,  # [Ns] int64
    class_weights: Optional[torch.Tensor],  # [C] or [F, C], None = unweighted
    num_segments: int,
    num_classes: int,
    weighted: Optional[torch.Tensor] = None,  # [F] bool (None = all)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_split_search` after the sort, in PyTorch ops over ``[K, C,
    Ns]`` class prefixes."""
    f, c = num_segments, num_classes
    k, ns = vals.shape
    dev = vals.device
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
    # Every slot's stream holds the same segments in the same order.
    cw = class_weights
    if cw is not None:
        cw = (cw[:, None] if cw.dim() == 1
              else _segment_rows(cw, seg_c[0], 1.0).T)  # [C, Ns]
    wm = None if weighted is None else _segment_rows(weighted, seg_c[0], False)
    objective = torch.where(
        valid, _pair_entropy(left, right, cw, wm, ns, 1), torch.inf)
    threshold = 0.5 * (prev_vals + sorted_vals)

    # Entries that cannot move their segment's result (not valid; not the
    # minimum) go to spare columns past the segments' (``_spare``).
    spare = _spare(ns, f, dev)
    best_obj = torch.full((k, f + _SPARE), torch.inf, device=dev).scatter_reduce(
        1, torch.where(valid, seg_c, spare), objective, "amin")
    hit = valid & (objective == torch.gather(best_obj, 1, seg_c))
    pos = torch.where(hit, torch.arange(ns, device=dev), ns - 1)
    best_pos = torch.full((k, f + _SPARE), ns - 1, device=dev).scatter_reduce(
        1, torch.where(hit, seg_c, spare), pos, "amin")[:, :f]
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
    class_weights: Optional[torch.Tensor],  # [C] or [F, C], None = unweighted
    num_segments: int,
    num_classes: int,
    rows: Optional[torch.Tensor] = None,  # [Ns] row of x per example
    weighted: Optional[torch.Tensor] = None,  # [F] bool (None = all)
):
    """All K feature slots of one level as one batched ``[K, Ns]`` search
    (the JAX code scans the slots one by one); off the card in chunks of
    slots past :data:`_EXACT_CHUNK`. Each output is [K, F]."""
    seg_c = seg.clamp(max=num_segments - 1)
    vals = _take(x, rows, feats[seg_c]).T.contiguous()  # [K, Ns]
    per = (vals.shape[0] if vals.device.type == "cuda"
           else max(1, _EXACT_CHUNK // (num_classes * vals.shape[1])))
    parts = [_split_search(vals[s : s + per], seg_search, cls, class_weights,
                           num_segments, num_classes, weighted)
             for s in range(0, vals.shape[0], per)]
    return parts[0] if len(parts) == 1 else tuple(
        torch.cat(p) for p in zip(*parts))


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
    class_weights: Optional[torch.Tensor],  # [C] or [F, C], None = unweighted
    num_segments: int,
    num_classes: int,
    num_bins: int,
    weighted: Optional[torch.Tensor] = None,  # [F] bool (None = all)
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
    cw = None if class_weights is None else class_weights[..., None]
    wm = None if weighted is None else weighted[:, None]
    objective = torch.where(
        (left_mass > 0) & (right_mass > 0),
        _pair_entropy(left, right, cw, wm, seg.shape[0], 2),
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
    class_weights: Optional[torch.Tensor],  # [C] or [F, C], None = unweighted
    num_segments: int,
    num_classes: int,
    num_bins: int,
    rows: Optional[torch.Tensor] = None,  # [Ns] row of xb per example
    weighted: Optional[torch.Tensor] = None,  # [F] bool (None = all)
):
    """All K slots of one level, binned, in chunks of slots; thresholds are
    read from the boundary table. Each output is [K, F]."""
    seg_c = seg.clamp(max=num_segments - 1)
    bins = _take(xb, rows, feats[seg_c]).T  # [K, Ns]
    per = max(1, _BINNED_CHUNK // (num_segments * num_classes * num_bins))
    parts = [
        _binned_search(bins[s : s + per], seg_search, cls, class_weights,
                       num_segments, num_classes, num_bins, weighted)
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
    x: torch.Tensor,  # [N, D], read through ``rows``
    rows: torch.Tensor,  # [Ns] row of x per example
    labels: torch.Tensor,  # [Ns, L] int64
    node_of: torch.Tensor,  # [Ns] int64 node id per example in its tree's table
    seg: torch.Tensor,  # [Ns] frontier slot per example, F = off the frontier
    first: torch.Tensor,  # [F] the first slot of each slot's tree
    table_len: torch.Tensor,  # [F] each slot's tree-table length
    feats: torch.Tensor,  # [F, K] int64 sampled feature ids per slot
    layers: torch.Tensor,  # [F] int64 chosen layer per slot
    min_split: int,
    min_child: int,
    class_weights: Optional[torch.Tensor],  # [F, C] per slot, None = unweighted
    weighted: Optional[torch.Tensor],  # [F] bool: weights apply (None = all)
    num_classes: int,
    xb: Optional[torch.Tensor] = None,  # [N, D] bin indices (binned mode)
    boundaries: Optional[torch.Tensor] = None,  # [D, B-1] (binned mode)
    num_bins: int = 0,  # 0 = exact search
):
    """One level above the depth limit over a frontier of F slots (one or
    several trees' frontiers one after another): node stats, stop checks
    (learning.cpp:521-531), the K-slot search, best-slot selection, child-id
    allocation and the example partition. A tree's children are allocated
    at the end of its own table in slot order. -> (splitting [F], feature
    [F], threshold [F], left ids [F], new node_of)."""
    f = feats.shape[0]
    num_layers = labels.shape[1]
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
            f, num_classes, num_bins, rows=rows, weighted=weighted,
        )
    else:
        obj_k, thr_k, lm_k, rm_k = multi_slot_split_search(
            x, feats, seg, seg_search, cls, class_weights, f, num_classes,
            rows=rows, weighted=weighted,
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
    before = torch.cumsum(sp, 0) - sp  # splits in the slots before, all trees
    left_ids = table_len + 2 * (before - before[first])

    sp_e = splitting[seg_c] & (seg < f)
    xv = _take(x, rows, best_feat[seg_c][:, None])[:, 0]
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


# (layers [F], feats [F, K]) of the level at ``depth``, given each live
# tree's (index, frontier size): the live trees' rows one after another.
LevelDraws = Callable[[int, Sequence[Tuple[int, int]]],
                      Tuple[torch.Tensor, torch.Tensor]]


def _grow(
    x: torch.Tensor,  # [N, D] the rows the trees' samples index
    labels: torch.Tensor,  # [N, L] int64
    rows: Sequence[torch.Tensor],  # per tree: [Ns_t] int64 sample rows of x
    draws: LevelDraws,
    class_weights: Sequence[Optional[torch.Tensor]],  # per tree: [C] or None
    cfg: TrainerConfig,
    num_classes: int,
    xb: Optional[torch.Tensor] = None,  # [N, D] bin indices (binned mode)
    boundaries: Optional[torch.Tensor] = None,  # [D, B-1] (binned mode)
) -> List[TreeTables]:
    """Grow a list of trees breadth first in one level loop.

    Each level is one :func:`_level_core` over the concatenated frontiers
    of the trees that still have one; a tree's frontier holds its ids
    ``[base, base + F_t)`` and its children are allocated at the end of its
    table in slot order, as the reference package's host builder and device
    growth both number them. The loop reads one small vector per level back
    from the device: how many nodes of each tree split. A tree whose
    frontier empties leaves the loop (and its examples the level's stream);
    past ``max_depth`` no node splits (JAX's device loop stops there; its
    host loop runs one more level that splits nothing), and the last
    frontier stays as leaf rows.

    With tracing on, the loop is a ``train.grow`` span (``attrs``: trees,
    rows) and each level a ``train.level`` span in it (``attrs``: level,
    nodes of the frontier, samples); ``train.levels`` adds the levels and
    ``train.nodes`` the grown trees' nodes."""
    dev = x.device
    num_trees = len(rows)
    num_bins = cfg.split_bins if xb is not None else 0
    span = [len(r) for r in rows]  # the examples of a tree lie together
    row = torch.cat(list(rows))
    tree = torch.repeat_interleave(torch.arange(num_trees, device=dev),
                                   torch.tensor(span, device=dev))
    lab = labels[row]
    node_of = torch.zeros_like(row)
    weighted = [w is not None for w in class_weights]
    if any(weighted):
        w_tree = torch.stack([torch.ones(num_classes, device=dev) if w is None
                              else w for w in class_weights])
        weighted_tree = torch.tensor(weighted, device=dev)
    levels: List[list] = [[] for _ in range(num_trees)]  # (sf, th, lc) slices
    nn, f_count = [1] * num_trees, [1] * num_trees
    live, depth = list(range(num_trees)), 0
    grow = profiling.span("train.grow", attrs={"trees": num_trees, "rows": len(row)})
    while live and depth <= cfg.max_depth:
        fs = [f_count[t] for t in live]
        starts = np.cumsum([0] + fs[:-1])
        f = int(sum(fs))
        level_span = profiling.span(
            "train.level", parent=grow,
            attrs={"level": depth, "nodes": f, "samples": len(row)})
        base = np.array([n - c for n, c in zip(nn, f_count)])
        shift = np.zeros(num_trees, np.int64)
        shift[live] = starts - base[live]
        host = np.concatenate([
            np.repeat(live, fs), np.repeat(starts, fs),
            np.repeat([nn[t] for t in live], fs), shift, base,
        ]).astype(np.int64)
        meta = torch.from_numpy(host).to(dev)  # the level's one upload
        slot_tree, first, table_len = meta[:f], meta[f:2 * f], meta[2 * f:3 * f]
        shift_t, base_t = meta[3 * f:3 * f + num_trees], meta[3 * f + num_trees:]
        seg = torch.where(node_of >= base_t[tree], node_of + shift_t[tree], f)

        cw = wm = None
        if any(weighted[t] for t in live):
            cw = w_tree[slot_tree]
            if not all(weighted[t] for t in live):
                wm = weighted_tree[slot_tree]
        layers, feats = draws(depth, list(zip(live, fs)))
        splitting, feat, thr, left_ids, node_of = _level_core(
            x, row, lab, node_of, seg, first, table_len, feats, layers,
            cfg.min_split_examples, cfg.min_child_split_examples, cw, wm,
            num_classes, xb=xb, boundaries=boundaries, num_bins=num_bins,
        )
        level = (torch.where(splitting, feat, 0), torch.where(splitting, thr, 0.0),
                 torch.where(splitting, left_ids, 0))
        splits = torch.zeros(num_trees, dtype=torch.int64, device=dev).index_add_(
            0, slot_tree, splitting.to(torch.int64)).tolist()  # the host read
        for t, s, ft in zip(live, starts, fs):
            levels[t].append(tuple(a[s:s + ft] for a in level))
            nn[t] += 2 * splits[t]
            f_count[t] = 2 * splits[t]
        kept = [t for t in live if f_count[t]]
        if kept and kept != live:  # drop the done trees' examples
            ends = np.cumsum([span[t] for t in live])
            ranges = [(e - span[t], e) for t, e in zip(live, ends) if f_count[t]]
            row, lab, node_of, tree = (torch.cat([a[b:e] for b, e in ranges])
                                       for a in (row, lab, node_of, tree))
        live = kept
        depth += 1
        level_span.end()
        train_levels.add()
    grow.end()
    train_nodes.add(sum(nn))

    out = []
    for t in range(num_trees):
        zero = torch.zeros(f_count[t], dtype=torch.int64, device=dev)
        sizes = [l[0].shape[0] for l in levels[t]] + [f_count[t]]
        dep = np.repeat(np.arange(len(sizes)), sizes)
        out.append(TreeTables(
            split_feature=torch.cat([l[0] for l in levels[t]] + [zero]).to(torch.int32),
            threshold=torch.cat([l[1] for l in levels[t]] + [zero.to(torch.float32)]),
            left_child=torch.cat([l[2] for l in levels[t]] + [zero]).to(torch.int32),
            depth=torch.from_numpy(dep.astype(np.int32)).to(dev),
        ))
    return out


def _num_features(cfg: TrainerConfig, d: int) -> int:
    return cfg.num_features or int(math.ceil(math.sqrt(d)))


def host_draws(rngs: Sequence[np.random.Generator], num_layers: int, d: int,
               k: int, device) -> LevelDraws:
    """The host growth's numpy draws (JAX ``_grow_tree``), each tree from its
    own stream ``rngs[t]``: per level, the layers, then one permutation's
    first ``k`` features per node."""

    def draw(depth: int, live: Sequence[Tuple[int, int]]):
        layers, feats = [], []
        for t, f in live:
            layers.append(rngs[t].integers(0, num_layers, size=f))
            feats.extend(rngs[t].permutation(d)[:k] for _ in range(f))
        return (torch.from_numpy(np.concatenate(layers).astype(np.int64)).to(device),
                torch.from_numpy(np.stack(feats).astype(np.int64)).to(device))

    return draw


def device_draws(seeds: Sequence[int], num_layers: int, d: int, k: int,
                 device) -> LevelDraws:
    """The device growth's threefry draws (JAX ``grow_tree_device``), tree
    ``t`` from ``PRNGKey(seeds[t])``: per level ``split(fold_in(key,
    depth))``, layers by ``randint`` and features as the top ``k`` of
    per-slot uniforms. The live trees' draws are one evaluation of the hash;
    the threefry is the partitionable one, so a tree's rows do not depend
    on the trees drawn beside it."""
    keys = [jrandom.prng_key(s) for s in seeds]

    def draw(depth: int, live: Sequence[Tuple[int, int]]):
        lay, feat = [], []
        for t, f in live:
            k_lay, k_feat = jrandom.split(jrandom.fold_in(keys[t], depth))
            lay.append((jrandom.split(k_lay), f))
            feat.append((k_feat, (f, d)))
        f = sum(n for _, n in lay)
        bits = jrandom.random_bits_flat(
            [(k_hi, (n,)) for (k_hi, _), n in lay]
            + [(k_lo, (n,)) for (_, k_lo), n in lay] + feat, device)
        layers = jrandom.randint_from_bits(bits[:f], bits[f:2 * f], 0, num_layers)
        _, feats = jrandom.top_k(
            jrandom.uniform_from_bits(bits[2 * f:].view(f, d)), k)
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
    """One tree on all of ``x``'s rows with the device growth's draws, exact
    or binned: :func:`_grow` with one tree."""
    d = x.shape[1]
    draws = device_draws([seed], labels.shape[1], d, _num_features(cfg, d),
                         x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    return _grow(x, labels, [rows], draws, [class_weights], cfg, num_classes,
                 xb=xb, boundaries=boundaries)[0]


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


def _leaf_histograms_forest(
    x: torch.Tensor,  # [N, D] full dataset
    labels: torch.Tensor,  # [N, L] int64
    freqs: torch.Tensor,  # [L, C] inverted class frequency per layer
    trees: Sequence[TreeTables],
    num_classes: int,
) -> List[torch.Tensor]:  # per tree [nn_t, L, C] float32 weighted counts
    """Descend the full dataset once through every tree (their tables one
    after another, ``[N, T]`` nodes) to the deepest tree's own depth, count
    examples per (tree, node, layer, class) as integers in one count, then
    weight each count by its class frequency once (JAX adds the float32
    weight per example: float32 rounding apart, the same numbers).

    The deepest leaves sit one level below ``max_depth``, and the descent
    reaches them: JAX's fused refit descends ``ceil(max_depth / 8) * 8``
    levels and misses them when ``max_depth`` is a multiple of 8."""
    dev = x.device
    sizes = [t.num_nodes for t in trees]
    offsets = np.cumsum([0] + sizes[:-1]).tolist()
    sf = torch.cat([t.split_feature for t in trees]).to(torch.int64)
    th = torch.cat([t.threshold for t in trees])
    lc = torch.cat([torch.where(t.left_child != 0, t.left_child.to(torch.int64) + o, 0)
                    for t, o in zip(trees, offsets)])
    node = torch.tensor(offsets, device=dev).repeat(x.shape[0], 1)  # [N, T]
    depth = int(torch.stack([t.depth.max() for t in trees]).max())
    for _ in range(depth):
        left = lc[node]
        nxt = left + (torch.gather(x, 1, sf[node]) >= th[node]).to(torch.int64)
        node = torch.where(left == 0, node, nxt)
    total, num_layers, c = sum(sizes), labels.shape[1], num_classes
    layer = torch.arange(num_layers, device=dev)
    keys = (node[:, :, None] * num_layers + layer) * c + labels[:, None, :]
    counts = _count(keys, total * num_layers * c).view(total, num_layers, c)
    return list((counts.to(torch.float32) * freqs).split(sizes))


def _leaf_histograms_all(
    x: torch.Tensor,  # [N, D] full dataset
    labels: torch.Tensor,  # [N, L] int64
    freqs: torch.Tensor,  # [L, C] inverted class frequency per layer
    tree: TreeTables,
    num_classes: int,
) -> torch.Tensor:  # [nn, L, C] float32 weighted counts
    """:func:`_leaf_histograms_forest` of one tree."""
    return _leaf_histograms_forest(x, labels, freqs, [tree], num_classes)[0]


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

    def grow_trees(self, data: TrainingData, tree_ids: Sequence[int],
                   progress: bool = False) -> List[TreeArrays]:
        """Grow trees ``tree_ids`` in one level loop and refit their leaf
        histograms on the whole set in one descent. Tree ``t`` draws from
        its own stream ``default_rng((seed, t))`` (its bootstrap, then its
        threefry seed, or in host growth its numpy draws in its own order):
        the same tree whichever trees grow beside it or before it, and on
        whichever device."""
        cfg = self.config
        if not tree_ids:
            return []
        start = time.perf_counter()
        n, d = data.x.shape
        c_max = max(data.class_counts)
        rngs, rows, weights = [], [], []
        for t in tree_ids:
            rng = np.random.default_rng((cfg.seed, t))
            idx = _bootstrap(rng, cfg, n, cfg.num_bootstrap_examples or n)
            rows.append(torch.from_numpy(idx.astype(np.int64)).to(self.device))
            weights.append(_weights_or_none(
                _tree_class_weights(cfg, data.labels[idx], len(idx), c_max),
                self.device))
            rngs.append(rng)
        num_layers, k = data.labels.shape[1], _num_features(cfg, d)
        if cfg.device_growth:
            draws = device_draws([_tree_seed(r) for r in rngs], num_layers, d,
                                 k, self.device)
        else:
            draws = host_draws(rngs, num_layers, d, k, self.device)
        tables = _grow(data.x, data.labels_dev, rows, draws, weights, cfg, c_max,
                       xb=data.bins, boundaries=data.boundaries)
        with profiling.span("train.refit"):
            raws = _leaf_histograms_forest(data.x, data.labels_dev, data.freqs,
                                           tables, c_max)
        trees = []
        for t, tab, raw in zip(tree_ids, tables, raws):
            sf, th, lc, dep = tab.numpy()
            trees.append(TreeArrays(
                split_feature=sf, threshold=th, left_child=lc,
                leaf_hist=_smooth_histograms(
                    raw.cpu().numpy(), lc, data.class_counts, cfg.smoothing),
            ))
            if progress:
                log.info("Finished tree %d/%d: %d nodes, depth %d (%d grown "
                         "together, %.1fs)", t + 1, cfg.num_trees, len(sf),
                         int(dep.max()), len(tables), time.perf_counter() - start)
        return trees

    def grow_tree(self, data: TrainingData, t: int,
                  progress: bool = False) -> TreeArrays:
        """Tree ``t`` alone: :meth:`grow_trees` of ``[t]``."""
        return self.grow_trees(data, [t], progress)[0]

    def learn(
        self,
        features,  # [N, D] float32, numpy or a tensor (kept on its device)
        labels,  # [N, L] int (all >= 0), numpy or a tensor
        class_counts: Optional[Sequence[int]] = None,
        multi_label: Optional[bool] = None,
        progress: bool = True,
        checkpoint_path: Optional[str] = None,
    ) -> Forest:
        """Train the forest. Every tree grows in one level loop
        (:meth:`grow_trees`), as JAX's fused forest does; with
        ``checkpoint_path``, one tree after another, and the checkpoint is
        saved after each tree and resumed from."""
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

        if checkpoint_path is None:
            trees = self.grow_trees(data, range(cfg.num_trees), progress)
        for t in range(len(trees), cfg.num_trees):
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
