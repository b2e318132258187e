"""The forest training recipe, plainly: ``semantic_segmentation_train``'s
augmented labelled extraction and libforest's multi-label tree learner, one
tree at a time, in plain PyTorch and NumPy in float32.

Extraction (``train.cpp:89-164``): each image is used 6 times, brightness
-20, 0 and +20 (``:115-117``, a saturating 8-bit add), each with and without
a horizontal flip of colour, depth and labels (``:132-145``; the calibration
is not flipped); each variant's WITH_POSITIVE_LABEL features at
``training_sample_stride`` come from ``frame.py``'s feature path, and a grid
point is kept where its depth is in range and every label layer is >= 0.

Growth (``learning.cpp:412-662``, the multi-label branch): tree ``t`` draws
its bootstrap of the dataset's size from ``default_rng((seed, t))``, then a
32-bit seed from the same stream. Breadth first, each level draws per
frontier node one label layer and ``ceil(sqrt(D))`` features from the
threefry-2x32 stream below; a node is searched when it holds at least
``min_split`` samples and more than one class of its layer; for each of its
features its samples are stably sorted by value, and every position whose
value exceeds the previous one by at least 1e-6 is a candidate with the
midpoint as threshold; the objective is the unnormalised entropy ``sum_c -n_c
log2 n_c + m log2 m`` of both children on the node's layer, summed in class
order; the node takes the earliest candidate of the smallest objective, over
its features in draw order, and splits when both children hold at least
``min_child`` samples. Its children are numbered after the table's last
node; a sample goes right when its value is >= the threshold. The leaves
are refit (``learning.cpp:963-1012``) with every row of the dataset: counts
per (leaf, layer, class) weighted by the inverted class frequency ``N / n_c``
and log-smoothed, ``log((h + s) / (sum h + C s))``.

Where this departs from ``learning.cpp``:

- depth first on an explicit stack there, breadth first here: the node
  numbering is the breadth-first one that the reference package's learners
  use (children after the table's last node, in frontier order);
- the layer and feature draws are the threefry-2x32 stream of the reference
  package's device growth (``PRNGKey(seed)``, per level ``split(fold_in(key,
  depth))``, ``randint`` of the layers, ``top_k`` of uniforms for the
  features), not ``std::mt19937``, and the bootstrap is numpy's;
- ``fastlog2`` there; here log2 of each integer count, computed in float64
  and rounded once to float32, so that every device gives the same
  objectives;
- the entropy is summed afresh per candidate, not updated one sample at a
  time.

Nothing here imports the port.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference import frame as ref_frame

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BRIGHTNESS = (-20, 0, 20)  # train.cpp:115-117
VARIANTS = 2 * len(BRIGHTNESS)


# ----------------------------------------------------------------------
# Extraction
# ----------------------------------------------------------------------


def variants(rgb: np.ndarray, depth: np.ndarray, labels: Sequence[np.ndarray]
             ) -> Iterator[Tuple[np.ndarray, np.ndarray, List[np.ndarray]]]:
    """The 6 augmented copies of one image in ``train.cpp``'s order: per
    brightness shift, as it is and flipped left to right."""
    for delta in BRIGHTNESS:
        shifted = np.clip(rgb.astype(np.int16) + delta, 0, 255).astype(np.uint8)
        yield shifted, depth, list(labels)
        yield (np.ascontiguousarray(shifted[:, ::-1]), np.ascontiguousarray(depth[:, ::-1]),
               [np.ascontiguousarray(l[:, ::-1]) for l in labels])


def grid_labels(labels: Sequence[np.ndarray], stride: int) -> np.ndarray:
    """[P, L] labels at the stride grid's points, row-major."""
    return np.stack([np.asarray(l)[::stride, ::stride].reshape(-1) for l in labels], 1)


def in_range(depth: np.ndarray, cfg: ref_frame.FrameConfig) -> np.ndarray:
    """[P] bool: the grid points whose depth is in range, as
    ``ref_frame.features`` masks them, without the features."""
    s = cfg.stride
    grid = np.asarray(depth, np.float32)[::s, ::s].reshape(-1)
    lo = np.float32(cfg.d_min) * np.float32(1000.0)
    hi = np.float32(cfg.d_max) * np.float32(1000.0)
    return (grid >= lo) & (grid <= hi)


def kept(depth: np.ndarray, labels: Sequence[np.ndarray], cfg: ref_frame.FrameConfig
         ) -> np.ndarray:
    """[P] bool: the grid points a variant keeps: depth in range and every
    label >= 0."""
    return in_range(depth, cfg) & (grid_labels(labels, cfg.stride) >= 0).all(1)


def training_rows(rgb: np.ndarray, depth: np.ndarray, labels: Sequence[np.ndarray],
                  kinv, rot, trans, cfg: ref_frame.FrameConfig, device,
                  dtype=torch.float32) -> Tuple[torch.Tensor, np.ndarray]:
    """One variant's kept rows: -> (features [n, D] float32 on ``device``,
    labels [n, L] int32). With ``dtype`` the depth, height and normal
    features are rounded to it."""
    feats, _, _ = ref_frame.features(
        torch.from_numpy(np.ascontiguousarray(rgb)).to(device),
        torch.from_numpy(np.asarray(depth, np.int32)).to(device),
        kinv, rot, trans, cfg, dtype)
    keep = kept(depth, labels, cfg)  # in range, as ``mask`` holds it, and labelled
    return (feats[torch.from_numpy(keep).to(device)],
            grid_labels(labels, cfg.stride)[keep].astype(np.int32))


# ----------------------------------------------------------------------
# Threefry-2x32 (JAX's partitionable stream), on int64 tensors
# ----------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 words in Python ints or int64
    tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def key_of(seed: int) -> Tuple[int, int]:
    return 0, int(seed) & _M32


def fold(key, data: int):
    return threefry(key[0], key[1], 0, int(data) & _M32)


def halves(key):
    """``split(key)``: the keys that hash (0, 0) and (0, 1)."""
    return threefry(key[0], key[1], 0, 0), threefry(key[0], key[1], 0, 1)


def bits(key, n: int, device) -> torch.Tensor:
    """32 random bits for each of the flat indices 0..n-1, as int64."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry(key[0], key[1], i >> 32, i & _M32)
    return b0 ^ b1


def uniforms(key, n: int, device) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as a mantissa in [1, 2), less 1."""
    return ((bits(key, n, device) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def randints(key, n: int, span: int, device) -> torch.Tensor:
    """``randint(key, (n,), 0, span)``: 64 bits per value folded into the span
    in uint32 arithmetic."""
    k_hi, k_lo = halves(key)
    hi, lo = bits(k_hi, n, device), bits(k_lo, n, device)
    mult = ((2**16 % span) ** 2 & _M32) % span
    return (((((hi % span) * mult) & _M32) + lo % span) & _M32) % span


def level_draws(key, depth: int, nodes: int, d: int, k: int, layers: int, device):
    """One level's draws: (layer [F], the ``k`` features [F, k]) of its
    ``nodes`` frontier nodes: the largest ``k`` of each node's ``d``
    uniforms, ties to the lower index."""
    k_lay, k_feat = halves(fold(key, depth))
    lay = randints(k_lay, nodes, layers, device)
    u = uniforms(k_feat, nodes * d, device).view(nodes, d)
    feats = torch.sort(u, dim=1, descending=True, stable=True).indices[:, :k]
    return lay, feats


# ----------------------------------------------------------------------
# One tree
# ----------------------------------------------------------------------


@dataclass
class Tree:
    """A grown tree, breadth-first numbered: leaves have ``left`` 0 (and
    feature 0, threshold 0); inner nodes' ``hist`` is 0."""

    split: np.ndarray  # [n] int64
    threshold: np.ndarray  # [n] float32
    left: np.ndarray  # [n] int64
    hist: np.ndarray  # [n, L, C_max] float32 log-histograms


@functools.lru_cache(maxsize=4)
def _log2(n: int, device) -> torch.Tensor:
    """float32 log2 of 0..n (0 at 0), rounded once from float64."""
    v = np.zeros(n + 1)
    np.log2(np.arange(n + 1, dtype=np.float64), out=v, where=np.arange(n + 1) > 0)
    return torch.from_numpy(v.astype(np.float32)).to(device)


def _entropy(counts: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``sum_c -n_c log2 n_c + m log2 m`` of integer counts [C, n], the
    classes summed in order."""
    total = None
    for n in counts:
        term = torch.where(n > 0, -n.to(torch.float32) * table[n], 0.0)
        total = term if total is None else total + term
    mass = counts.sum(0)
    return total + mass.to(torch.float32) * table[mass]


def _best_splits(vals, slot, cls, nodes: int, classes: int, table):
    """For one drawn feature of every searched node: the samples' values
    [S], frontier slots [S] and classes [S] -> per slot (objective,
    threshold, left mass, right mass), objective +inf without a candidate.
    Sorts and prefix sums only: no atomics."""
    dev = vals.device
    order = torch.sort(vals, stable=True).indices
    order = order[torch.sort(slot[order], stable=True).indices]
    s_slot, s_vals = slot[order], vals[order]
    onehot = (cls[order] == torch.arange(classes, device=dev)[:, None]).to(torch.int64)
    after = torch.cumsum(onehot, 1)  # [C, S]: per class, samples up to here
    before = after - onehot
    mass = torch.bincount(slot, minlength=nodes)
    first = torch.cumsum(mass, 0) - mass  # each slot's first position
    start, end = first[s_slot], (first + mass - 1)[s_slot]
    left = before - before[:, start]
    right = after[:, end] - before[:, start] - left
    n = len(s_vals)
    same = torch.zeros(n, dtype=torch.bool, device=dev)
    same[1:] = s_slot[1:] == s_slot[:-1]
    prev = torch.cat([s_vals[:1], s_vals[:-1]])
    ok = same & (s_vals - prev >= 1e-6) & (left.sum(0) > 0)
    objective = torch.where(ok, _entropy(left, table) + _entropy(right, table), torch.inf)
    # Per slot, the least objective at its earliest position: the positions
    # sorted by objective, then stably by slot; a slot's first is its best.
    by_obj = torch.sort(objective, stable=True).indices
    by_obj = by_obj[torch.sort(s_slot[by_obj], stable=True).indices]
    pos = by_obj[first.clamp(max=n - 1)]
    best = torch.where(mass > 0, objective[pos], torch.inf)
    return (best, 0.5 * (prev[pos] + s_vals[pos]), left[:, pos].sum(0),
            right[:, pos].sum(0))


def bootstrap(n: int, seed: int, t: int) -> Tuple[np.ndarray, int]:
    """Tree ``t``'s bootstrap rows (``n`` draws of ``[0, n)``) and its 32-bit
    draw seed, from ``default_rng((seed, t))`` in that order."""
    rng = np.random.default_rng((seed, t))
    rows = rng.integers(0, n, size=n)
    return rows, int(np.uint32(rng.integers(0, 2**32, dtype=np.uint64)))


def grow_tree(x: torch.Tensor, labels: np.ndarray, class_counts: Sequence[int],
              t: int, seed: int = 0, max_depth: int = 30, min_split: int = 50,
              min_child: int = 1, smoothing: float = 1.0) -> Tree:
    """Tree ``t`` of the forest seeded ``seed``, grown on rows ``x`` [N, D]
    (float32, on any device) with labels [N, L] (all >= 0) and refit."""
    dev = x.device
    n, d = x.shape
    num_layers, classes = labels.shape[1], max(class_counts)
    k = int(math.ceil(math.sqrt(d)))
    lab = torch.from_numpy(labels.astype(np.int64)).to(dev)
    boot, tree_seed = bootstrap(n, seed, t)
    key = key_of(tree_seed)
    rows = torch.from_numpy(boot).to(dev)  # the level's samples
    slot = torch.zeros_like(rows)  # and their frontier slots
    split, threshold, left = [0], [np.float32(0)], [0]
    frontier = [0]
    table = _log2(n, dev)
    for depth in range(max_depth + 1):
        f = len(frontier)
        if f == 0:
            break
        layer, feats = level_draws(key, depth, f, d, k, num_layers, dev)
        cls = lab[rows, layer[slot]]
        mass = torch.bincount(slot, minlength=f)
        present = torch.zeros((f, classes), dtype=torch.bool, device=dev)
        present[slot, cls] = True
        searched = (mass >= min_split) & (present.sum(1) > 1)
        s = searched[slot]
        s_rows, s_slot, s_cls = rows[s], slot[s], cls[s]
        best = torch.full((f,), torch.inf, device=dev)
        thr = torch.zeros(f, device=dev)
        feat = torch.zeros(f, dtype=torch.int64, device=dev)
        lm = torch.zeros(f, dtype=torch.int64, device=dev)
        rm = torch.zeros(f, dtype=torch.int64, device=dev)
        if len(s_rows):
            for j in range(k):
                fj = feats[s_slot, j]
                obj, th, l_m, r_m = _best_splits(x[s_rows, fj], s_slot, s_cls, f,
                                                 classes, table)
                better = obj < best  # the first feature of the least objective
                best = torch.where(better, obj, best)
                thr = torch.where(better, th, thr)
                feat = torch.where(better, feats[:, j], feat)
                lm, rm = torch.where(better, l_m, lm), torch.where(better, r_m, rm)
        splits = (searched & torch.isfinite(best) & (lm >= min_child)
                  & (rm >= min_child)).cpu().numpy()
        feat_h, thr_h = feat.cpu().numpy(), thr.cpu().numpy()
        nxt, child_of = [], np.full(f, -1, np.int64)
        for i, node in enumerate(frontier):
            if splits[i]:
                first_child = len(split)
                split[node], threshold[node], left[node] = (
                    int(feat_h[i]), thr_h[i], first_child)
                split += [0, 0]
                threshold += [np.float32(0), np.float32(0)]
                left += [0, 0]
                child_of[i] = len(nxt)
                nxt += [first_child, first_child + 1]
        go = torch.from_numpy(splits).to(dev)[slot]
        rows, slot = rows[go], slot[go]
        right = (x[rows, feat[slot]] >= thr[slot]).to(torch.int64)
        slot = torch.from_numpy(child_of).to(dev)[slot] + right
        frontier = nxt
    split_a = np.array(split, np.int64)
    thr_a = np.array(threshold, np.float32)
    left_a = np.array(left, np.int64)
    return Tree(split_a, thr_a, left_a,
                refit(x, labels, split_a, thr_a, left_a, class_counts, smoothing))


def refit(x: torch.Tensor, labels: np.ndarray, split: np.ndarray,
          threshold: np.ndarray, left: np.ndarray, class_counts: Sequence[int],
          smoothing: float) -> np.ndarray:
    """The leaves' log-histograms from every row: [n, L, C_max] float32."""
    dev = x.device
    n = x.shape[0]
    sf, th, lc = (torch.from_numpy(a).to(dev) for a in (split, threshold, left))
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    r = torch.arange(n, device=dev)
    while True:
        child = lc[node]
        inner = child != 0
        if not bool(inner.any()):
            break
        node = torch.where(inner, child + (x[r, sf[node]] >= th[node]).to(torch.int64), node)
    leaf_of = node.cpu().numpy()
    nodes, num_layers, c_max = len(split), labels.shape[1], max(class_counts)
    raw = np.zeros((nodes, num_layers, c_max), np.float32)
    for l, c in enumerate(class_counts):
        lab = labels[:, l].astype(np.int64)
        freq = np.bincount(lab, minlength=c).astype(np.float64)
        weight = np.where(freq > 0, n / np.maximum(freq, 1), 0.0).astype(np.float32)
        counts = np.zeros((nodes, c), np.int64)
        np.add.at(counts, (leaf_of, lab), 1)
        raw[:, l, :c] = counts.astype(np.float32) * weight
    hist = np.zeros_like(raw)
    for l, c in enumerate(class_counts):
        h = raw[:, l, :c]
        hist[:, l, :c] = np.log((h + smoothing) / (h.sum(axis=1, keepdims=True)
                                                   + c * smoothing))
    hist[left != 0] = 0.0
    return hist


def tree_mismatch(split, threshold, left, hist, ref: Tree, rtol: float = 1e-6) -> float:
    """The share of breadth-first nodes whose feature, float32 threshold or
    left child differ from ``ref``'s (a node only one side has differs),
    plus the share of ``ref``'s leaves whose log-histogram differs anywhere
    by more than ``rtol`` of ``ref``'s value."""
    split, left = np.asarray(split, np.int64), np.asarray(left, np.int64)
    threshold = np.asarray(threshold, np.float32)
    n = min(len(split), len(ref.split))
    differ = ((split[:n] != ref.split[:n]) | (left[:n] != ref.left[:n])
              | (threshold[:n].view(np.int32) != ref.threshold[:n].view(np.int32)))
    nodes = (int(differ.sum()) + abs(len(split) - len(ref.split))) / max(len(split),
                                                                       len(ref.split))
    leaves = np.flatnonzero(ref.left == 0)
    same_leaf = leaves[leaves < n]
    same_leaf = same_leaf[left[same_leaf] == 0]
    a = np.asarray(hist, np.float32)[same_leaf].astype(np.float64)
    b = ref.hist[same_leaf].astype(np.float64)
    off = (np.abs(a - b) > rtol * np.abs(b)).reshape(len(same_leaf), -1).any(1)
    return nodes + (int(off.sum()) + len(leaves) - len(same_leaf)) / max(len(leaves), 1)
