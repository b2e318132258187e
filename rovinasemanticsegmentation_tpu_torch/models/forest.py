"""Multi-label random forest: the forest.dat codec, the device forest, the
feature-usage reorder, and the plain descent that the CUDA kernels
(``csrc/forest_descent.cu``, ``csrc/forest_descent_staged.cu``) are held to.

Counterpart of ``rovinasemanticsegmentation_tpu/models/forest.py``. The
structure-of-arrays ``Forest`` and the binary codec are numpy code copied
from there (that module imports jax, so it cannot be imported here):

- ``split_feature``  int32  [T, N]
- ``threshold``      float32[T, N]
- ``left_child``     int32  [T, N]  (right child = left + 1; 0 = leaf)
- ``leaf_hist``      float32[T, N, L, C_max]

Prediction follows ``DecisionTree::findLeafNode`` (libforest
classifier.cpp:97-117): ``node <- left_child[node] + (x[f] >= thr)`` until
``left_child == 0``, and the posterior is the per-layer sum of the trees'
leaf log-histograms in tree order (``RandomForest::multiClassLogPosterior``,
classifier.cpp:187-208). The codec follows io.h:34-108 and
classifier.cpp:134-152, 210-235 bit for bit.
"""

from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass
from typing import BinaryIO, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class Forest:
    """A random forest as host numpy arrays (the reference's ``Forest``)."""

    split_feature: np.ndarray  # [T, N] int32
    threshold: np.ndarray  # [T, N] float32
    left_child: np.ndarray  # [T, N] int32
    leaf_hist: np.ndarray  # [T, N, L, C_max] float32
    class_counts: Tuple[int, ...]  # per-layer class counts (<= C_max)
    node_counts: Tuple[int, ...]  # real node count per tree (<= N)
    max_depth: int  # deepest leaf over all trees
    multi_label: bool = True


@dataclass
class TreeArrays:
    split_feature: np.ndarray
    threshold: np.ndarray
    left_child: np.ndarray
    leaf_hist: np.ndarray  # [n, L, C_max]


def _tree_max_depth(left_child: np.ndarray) -> int:
    """Depth of the deepest leaf (root = depth 0)."""
    n = len(left_child)
    if n == 0:
        return 0
    depth = np.zeros(n, dtype=np.int32)
    max_d = 0
    # Children are appended after their parent (classifier.cpp:77-95).
    for node in range(n):
        l = left_child[node]
        if l != 0:
            depth[l] = depth[node] + 1
            depth[l + 1] = depth[node] + 1
            max_d = max(max_d, depth[node] + 1)
    return int(max_d)


def build_forest(
    trees: Sequence[TreeArrays],
    class_counts: Sequence[int],
    multi_label: bool = True,
    pad_nodes_to: int = 128,
) -> Forest:
    """Pack per-tree arrays into padded structure-of-arrays tensors."""
    t_count = len(trees)
    node_counts = tuple(len(t.split_feature) for t in trees)
    n_max = max(node_counts) if node_counts else 1
    n_pad = -(-n_max // pad_nodes_to) * pad_nodes_to
    num_layers = len(class_counts)
    c_max = max(class_counts) if class_counts else 1

    split_feature = np.zeros((t_count, n_pad), dtype=np.int32)
    threshold = np.zeros((t_count, n_pad), dtype=np.float32)
    left_child = np.zeros((t_count, n_pad), dtype=np.int32)
    leaf_hist = np.zeros((t_count, n_pad, num_layers, c_max), dtype=np.float32)
    max_depth = 0
    for t, tree in enumerate(trees):
        n = node_counts[t]
        split_feature[t, :n] = tree.split_feature
        threshold[t, :n] = tree.threshold
        left_child[t, :n] = tree.left_child
        leaf_hist[t, :n] = tree.leaf_hist
        max_depth = max(max_depth, _tree_max_depth(tree.left_child))
    return Forest(
        split_feature=split_feature,
        threshold=threshold,
        left_child=left_child,
        leaf_hist=leaf_hist,
        class_counts=tuple(int(c) for c in class_counts),
        node_counts=node_counts,
        max_depth=max_depth,
        multi_label=multi_label,
    )


def _feature_bits(num_features: int) -> int:
    bits = 1
    while (1 << bits) < num_features:
        bits += 1
    return bits


def pack_node_records(
    split_feature: np.ndarray, left_child: np.ndarray, threshold: np.ndarray
) -> Tuple[np.ndarray, int]:
    """[T, N, 2] int32 records ``(feat | left << bits, threshold bits)``.

    One 8-byte record per node: the descent reads a node with one load.
    """
    bits = _feature_bits(int(split_feature.max()) + 2)
    if (int(left_child.max()) << bits) >= 2**31:
        raise ValueError("tree too large for packed records")
    meta = split_feature.astype(np.int32) | (left_child.astype(np.int32) << bits)
    rec = np.stack(
        [meta, np.ascontiguousarray(threshold, np.float32).view(np.int32)],
        axis=-1,
    )
    return np.ascontiguousarray(rec), bits


# ======================================================================
# The device forest and the plain descent
# ======================================================================


@dataclass
class TorchForest:
    """A forest's inference tables on one device."""

    records: torch.Tensor  # [T, N, 2] int32 packed node records
    leaf_hist: torch.Tensor  # [T, N, L, C_max] float32
    class_counts: Tuple[int, ...]
    max_depth: int
    feat_bits: int
    num_features: int  # 1 + the largest split feature: features need >= this

    @property
    def num_trees(self) -> int:
        return self.records.shape[0]

    @property
    def device(self) -> torch.device:
        return self.records.device


def forest_from_numpy(forest, device: torch.device | str) -> TorchForest:
    """Convert a forest with the reference ``Forest`` fields as numpy arrays.

    Duck-typed: the reference package's ``Forest`` and this module's both
    work, so one trained forest runs through both packages.
    """
    split = np.asarray(forest.split_feature, np.int32)
    rec, bits = pack_node_records(
        split,
        np.asarray(forest.left_child, np.int32),
        np.asarray(forest.threshold, np.float32),
    )
    return TorchForest(
        records=torch.from_numpy(rec).to(device),
        leaf_hist=torch.from_numpy(
            np.ascontiguousarray(forest.leaf_hist, np.float32)
        ).to(device),
        class_counts=tuple(int(c) for c in forest.class_counts),
        max_depth=int(forest.max_depth),
        feat_bits=bits,
        num_features=int(split.max()) + 1,
    )


def usage_permutation(
    forest: TorchForest, num_features: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Features ordered by how many internal nodes split on them, most first.

    Returns ``(perm, remap)``: column ``k`` of the reordered features is old
    column ``perm[k]``, and ``remap[old] = new``. Ties keep their order
    (stable sort). Port of ``usage_permutation`` in the chunk-skip descent
    experiment (``scripts/exp_descent.py``); the counts do not depend on how
    nodes are numbered, so the natural records give the same result as the
    level-major ones.
    """
    meta, feat_bits = forest.records[..., 0].cpu().numpy(), forest.feat_bits
    fmask = (1 << feat_bits) - 1
    internal = (meta >> feat_bits) != 0
    counts = np.bincount(
        (meta & fmask)[internal].ravel(), minlength=num_features
    )[:num_features]
    perm = np.argsort(-counts, kind="stable")
    remap = np.empty_like(perm)
    remap[perm] = np.arange(len(perm))
    return perm, remap


def permute_forest_features(forest: TorchForest, remap) -> TorchForest:
    """The forest that splits on reordered columns: feature ``f`` -> ``remap[f]``.

    Only internal nodes are rewritten (a leaf's feature field is never read);
    ``left << feat_bits`` and the thresholds are kept, so leaf ids stay in the
    natural numbering. Raises if a remapped feature needs more than
    ``feat_bits`` bits.
    """
    remap_np = np.asarray(remap, np.int64)
    meta, feat_bits = forest.records[..., 0].cpu().numpy(), forest.feat_bits
    fmask = (1 << feat_bits) - 1
    feats = meta & fmask
    internal = (meta >> feat_bits) != 0
    if internal.any() and int(feats[internal].max()) >= len(remap_np):
        raise ValueError(
            f"forest splits on feature {int(feats[internal].max())}, but the "
            f"remap covers {len(remap_np)} features"
        )
    new_feats = np.where(internal, remap_np[np.where(internal, feats, 0)], feats)
    if int(new_feats.max()) > fmask:
        raise ValueError(
            f"remapped feature {int(new_feats.max())} needs more than "
            f"{feat_bits} bits"
        )
    new_meta = ((meta & ~fmask) | new_feats).astype(np.int32)
    records = forest.records.clone()
    records[..., 0] = torch.from_numpy(new_meta).to(records.device)
    return TorchForest(
        records=records,
        leaf_hist=forest.leaf_hist,
        class_counts=forest.class_counts,
        max_depth=forest.max_depth,
        feat_bits=feat_bits,
        num_features=int(new_feats.max()) + 1,
    )


def find_leaves_plain(
    features: torch.Tensor,  # [P, D] float32
    records: torch.Tensor,  # [T, N, 2] int32
    max_depth: int,
    feat_bits: int,
) -> torch.Tensor:  # [P, T] int32 leaf ids
    """Vectorised findLeafNode over points x trees (the kernel's plain version).

    A leaf has ``left_child == 0`` and is a fixed point; the loop stops once
    every point sits on a leaf in every tree, or after ``max_depth`` levels.
    """
    num_trees = records.shape[0]
    p = features.shape[0]
    meta_tab = records[..., 0]
    thr_tab = records[..., 1].view(torch.float32)
    trees = torch.arange(num_trees, device=features.device)[None, :]
    fmask = (1 << feat_bits) - 1
    node = torch.zeros((p, num_trees), dtype=torch.int64, device=features.device)
    for _ in range(max_depth):
        meta = meta_tab[trees, node]  # [P, T]
        lc = meta >> feat_bits
        active = lc != 0
        if not bool(active.any()):
            break
        x = torch.gather(features, 1, (meta & fmask).long())
        nxt = lc.long() + (x >= thr_tab[trees, node]).long()
        node = torch.where(active, nxt, node)
    return node.to(torch.int32)


def sum_leaf_histograms_plain(
    leaf_hist: torch.Tensor, leaves: torch.Tensor
) -> torch.Tensor:  # [P, L, C]
    """Per-layer leaf log-histograms summed over trees in order t = 0..T-1.

    The kernel fuses this sum in the same order, so the two agree bit for bit.
    """
    num_trees, n, num_layers, c = leaf_hist.shape
    flat = leaf_hist.reshape(num_trees, n, num_layers * c)
    acc = torch.zeros(
        (leaves.shape[0], num_layers * c), dtype=torch.float32,
        device=leaf_hist.device,
    )
    for t in range(num_trees):
        acc = acc + flat[t][leaves[:, t].long()]
    return acc.reshape(-1, num_layers, c)


# ======================================================================
# Reference forest.dat binary codec (reading; writing comes with training)
# ======================================================================
#
# writeBinary layout (io.h:34-108):
#   scalar T           -> raw little-endian bytes of T
#   vector<T>          -> int32 count, then each element
# DecisionTree::write (classifier.cpp:144-152):
#   splitFeatures (vec<int>), thresholds (vec<float>), leftChild (vec<int>),
#   histograms (vec<vec<float>>), multi_histograms (vec<vec<vec<float>>>)
# RandomForest::write (classifier.cpp:210-220): int32 tree count, then trees.


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", f.read(4))[0]


def _read_vec(f: BinaryIO, dtype: np.dtype) -> np.ndarray:
    n = _read_i32(f)
    return np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype).copy()


def _read_nested2(f: BinaryIO) -> List[np.ndarray]:
    n = _read_i32(f)
    return [_read_vec(f, np.dtype("<f4")) for _ in range(n)]


def _read_nested3(f: BinaryIO) -> List[List[np.ndarray]]:
    n = _read_i32(f)
    return [_read_nested2(f) for _ in range(n)]


@dataclass
class RawTree:
    """A decoded reference tree prior to structure-of-arrays packing."""

    split_features: np.ndarray
    thresholds: np.ndarray
    left_child: np.ndarray
    histograms: List[np.ndarray]
    multi_histograms: List[List[np.ndarray]]


def read_reference_tree(f: BinaryIO) -> RawTree:
    return RawTree(
        split_features=_read_vec(f, np.dtype("<i4")),
        thresholds=_read_vec(f, np.dtype("<f4")),
        left_child=_read_vec(f, np.dtype("<i4")),
        histograms=_read_nested2(f),
        multi_histograms=_read_nested3(f),
    )


def read_reference_forest(f: BinaryIO) -> List[RawTree]:
    count = _read_i32(f)
    return [read_reference_tree(f) for _ in range(count)]


def _load_forest_native(
    data: bytes, class_counts: Optional[Sequence[int]]
) -> Optional[Forest]:
    """Single-pass decode through the port's C++ codec (``native/``)."""
    from ..native import native_forest_decode

    decoded = native_forest_decode(data)
    if decoded is None:
        return None
    node_counts, split, thr, left, hist_index, hist_vals = decoded
    if len(node_counts) == 0:
        raise ValueError("Empty forest file")
    multi = bool(len(hist_index)) and bool((hist_index[:, 2] >= 0).any())
    if class_counts is None:
        if multi:
            rows = hist_index[hist_index[:, 2] >= 0]
            num_layers = int(rows[:, 2].max()) + 1
            counts = tuple(
                int(rows[rows[:, 2] == l][:, 3].max()) for l in range(num_layers)
            )
        else:
            counts = (int(hist_index[:, 3].max()) if len(hist_index) else 1,)
    else:
        counts = tuple(int(c) for c in class_counts)
    num_layers = len(counts)
    c_max = max(counts)

    trees: List[TreeArrays] = []
    starts = np.concatenate([[0], np.cumsum(node_counts)])
    hists = [
        np.zeros((int(node_counts[t]), num_layers, c_max), np.float32)
        for t in range(len(node_counts))
    ]
    for t, v, l, length, off in hist_index:
        li = 0 if l < 0 else int(l)
        hists[t][v, li, :length] = hist_vals[off : off + length]
    for t in range(len(node_counts)):
        s, e = starts[t], starts[t + 1]
        trees.append(
            TreeArrays(
                split_feature=split[s:e],
                threshold=thr[s:e],
                left_child=left[s:e],
                leaf_hist=hists[t],
            )
        )
    return build_forest(trees, counts, multi_label=multi)


def load_forest(
    path_or_bytes,
    class_counts: Optional[Sequence[int]] = None,
    use_native: bool = True,
) -> Forest:
    """Load a reference ``forest.dat`` into host structure-of-arrays form.

    ``class_counts`` may be omitted; it is then inferred from the leaf
    histograms. Decodes through the C++ codec when it builds, else in Python.
    Pass the result to :func:`forest_from_numpy` to place it on a device.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    if use_native:
        forest = _load_forest_native(data, class_counts)
        if forest is not None:
            return forest
    raw = read_reference_forest(_io.BytesIO(data))
    if not raw:
        raise ValueError("Empty forest file")

    multi = any(any(len(l) for l in t.multi_histograms) for t in raw)
    if multi:
        inferred: List[int] = []
        for t in raw:
            for layers in t.multi_histograms:
                if layers:
                    for li, h in enumerate(layers):
                        while len(inferred) <= li:
                            inferred.append(0)
                        inferred[li] = max(inferred[li], len(h))
        counts = tuple(class_counts) if class_counts else tuple(inferred)
    else:
        c = max((len(h) for t in raw for h in t.histograms), default=1)
        counts = tuple(class_counts) if class_counts else (c,)

    num_layers = len(counts)
    c_max = max(counts)
    trees: List[TreeArrays] = []
    for t in raw:
        n = len(t.split_features)
        hist = np.zeros((n, num_layers, c_max), dtype=np.float32)
        if multi:
            for v, layers in enumerate(t.multi_histograms):
                for li, h in enumerate(layers):
                    hist[v, li, : len(h)] = h
        else:
            for v, h in enumerate(t.histograms):
                hist[v, 0, : len(h)] = h
        trees.append(
            TreeArrays(
                split_feature=t.split_features.astype(np.int32),
                threshold=t.thresholds.astype(np.float32),
                left_child=t.left_child.astype(np.int32),
                leaf_hist=hist,
            )
        )
    return build_forest(trees, counts, multi_label=multi)
