"""Classifier evaluation tools: accuracy, confusion matrix, tree correlation.

Counterpart of ``rovinasemanticsegmentation_tpu/models/tools.py``, after the
libforest eval tools (``include/libforest/tools.h:19-78``), over whole
datasets:

- accuracy of the ensemble argmax;
- row-normalized confusion matrix;
- pairwise tree correlation = 1 - normalized Hamming distance between the
  per-tree label vectors (CorrelationTool's metric).

The descent is ``forest_predict`` on the features' device: kernel B on a
CUDA tensor, the plain descent on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.forest_cuda import forest_predict
from .forest import Forest, forest_from_numpy


def _predict(forest: Forest, features: torch.Tensor):
    return forest_predict(features, forest_from_numpy(forest, features.device))


def _per_tree_labels(forest: Forest, features: torch.Tensor, layer: int = 0) -> np.ndarray:
    """[T, P] argmax labels of each individual tree."""
    leaves = _predict(forest, features)[0].cpu().numpy()  # [P, T]
    c = forest.class_counts[layer]
    out = np.zeros((forest.num_trees, features.shape[0]), np.int32)
    hist = forest.leaf_hist[:, :, layer, :c]
    for t in range(forest.num_trees):
        out[t] = hist[t][leaves[:, t]].argmax(axis=1)
    return out


def ensemble_labels(forest: Forest, features: torch.Tensor, layer: int = 0) -> np.ndarray:
    c = forest.class_counts[layer]
    post = _predict(forest, features)[1].cpu().numpy()[:, layer, :c]
    return post.argmax(axis=1)


def accuracy(forest: Forest, features: torch.Tensor, labels: np.ndarray, layer: int = 0) -> float:
    """AccuracyTool::measure."""
    return float((ensemble_labels(forest, features, layer) == np.asarray(labels)).mean())


def confusion_matrix(
    forest: Forest, features: torch.Tensor, labels: np.ndarray, layer: int = 0
) -> np.ndarray:
    """ConfusionMatrixTool::measure: row-normalized [C, C]."""
    c = forest.class_counts[layer]
    pred = ensemble_labels(forest, features, layer)
    m = np.zeros((c, c), np.float64)
    np.add.at(m, (np.asarray(labels), pred), 1.0)
    rows = m.sum(axis=1, keepdims=True)
    return m / np.maximum(rows, 1.0)


def tree_correlation(forest: Forest, features: torch.Tensor, layer: int = 0) -> np.ndarray:
    """CorrelationTool::measure: [T, T] agreement between tree predictions."""
    labels = _per_tree_labels(forest, features, layer)  # [T, P]
    t_count = forest.num_trees
    corr = np.zeros((t_count, t_count), np.float64)
    for i in range(t_count):
        for j in range(t_count):
            hamming = (labels[i] != labels[j]).mean()
            corr[i, j] = 1.0 - hamming
    return corr
