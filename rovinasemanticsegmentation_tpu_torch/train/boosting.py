"""SAMME-style AdaBoost forest (BoostedRandomForest + learner).

Counterpart of ``rovinasemanticsegmentation_tpu/train/boosting.py``, after
libforest's ``learning.cpp:1120-1234`` and ``classifier.cpp:241-307``:

- each round samples N points with replacement proportionally to the boosting
  weights (inverse-CDF sampling, :1162-1175);
- the tree trains on the weighted resample; the weighted training error and
  ``alpha = log((1-err)/err) + log(C-1)`` follow SAMME (:1180-1197);
- misclassified weights scale by ``exp(alpha)`` and renormalize (:1201-1217);
- prediction is a weighted hard vote: each tree's argmax class receives its
  alpha (classifier.cpp:283-302).

The descent is the port's ``forest_predict``: kernel B on a CUDA tensor, the
plain descent on a CPU tensor. Serialization matches the reference writer:
tree count, then per tree the weight followed by the tree body
(classifier.cpp:250-280).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.forest import (
    Forest,
    RawTree,
    TreeArrays,
    build_forest,
    forest_from_numpy,
    read_reference_tree,
    write_reference_tree,
)
from ..ops.forest_cuda import forest_predict
from .forest_trainer import ForestTrainer, TrainerConfig


@dataclass
class BoostedForest:
    """A forest whose trees carry AdaBoost weights."""

    forest: Forest  # single-layer (L=1)
    weights: np.ndarray  # [T] alphas

    def class_log_posterior(self, features: torch.Tensor) -> torch.Tensor:
        """Weighted hard votes (classifier.cpp:283-302). [P, C] on the
        features' device."""
        tf = forest_from_numpy(self.forest, features.device)
        leaves, _ = forest_predict(features, tf)  # [P, T]
        c = self.forest.class_counts[0]
        hist = tf.leaf_hist[:, :, 0, :c]  # [T, N, C]
        votes = torch.zeros((features.shape[0], c), device=features.device)
        for t in range(self.forest.num_trees):
            label = torch.argmax(hist[t][leaves[:, t].long()], dim=1)
            votes = votes + torch.nn.functional.one_hot(label, c) * float(
                self.weights[t])
        return votes

    def classify(self, features: torch.Tensor) -> np.ndarray:
        return torch.argmax(self.class_log_posterior(features), dim=1).cpu().numpy()


class BoostedForestTrainer:
    """BoostedRandomForestLearner equivalent on one device."""

    def __init__(self, config: TrainerConfig, device: torch.device | str = "cuda"):
        self.config = config
        self.device = resolve_device(device)

    def learn(
        self,
        features,  # [N, D] float32, numpy or a tensor
        labels: np.ndarray,  # [N] single layer
        class_counts: Optional[Sequence[int]] = None,
    ) -> BoostedForest:
        labels = np.asarray(labels).reshape(-1)
        n = len(labels)
        c = (
            int(class_counts[0])
            if class_counts
            else int(labels.max()) + 1
        )
        rng = np.random.default_rng(self.config.seed)
        weights = np.full(n, 1.0 / n)

        tree_cfg = TrainerConfig(
            num_trees=1,
            max_depth=self.config.max_depth,
            min_split_examples=self.config.min_split_examples,
            min_child_split_examples=self.config.min_child_split_examples,
            num_features=self.config.num_features,
            use_bootstrap=False,  # resampling happens here
            smoothing=self.config.smoothing,
            device_growth=self.config.device_growth,
        )
        if isinstance(features, torch.Tensor):
            x_dev = features.to(device=self.device, dtype=torch.float32)
        else:
            x_dev = torch.from_numpy(
                np.ascontiguousarray(features, np.float32)).to(self.device)

        trees: List[TreeArrays] = []
        alphas: List[float] = []
        for _ in range(self.config.num_trees):
            # Weighted resample with replacement (learning.cpp:1162-1175).
            idx = rng.choice(n, size=n, replace=True, p=weights)
            trainer = ForestTrainer(
                TrainerConfig(**{**tree_cfg.__dict__, "seed": int(rng.integers(1 << 31))}),
                self.device,
            )
            tree_forest = trainer.learn(
                x_dev[torch.from_numpy(idx).to(self.device)], labels[idx],
                class_counts=[c], multi_label=False, progress=False,
            )
            trees.append(tree_forest.tree_view(0))

            # Weighted error on the FULL dataset (:1180-1194).
            _, post = forest_predict(
                x_dev, forest_from_numpy(tree_forest, self.device))
            predicted = post[:, 0, :c].argmax(1).cpu().numpy()
            mis = predicted != labels
            error = float(weights[mis].sum())
            error = min(max(error, 1e-8), 1 - 1e-8)
            alpha = float(np.log((1 - error) / error) + np.log(c - 1))
            alphas.append(alpha)

            # Reweight and renormalize (:1201-1217).
            weights = weights * np.where(mis, np.exp(alpha), 1.0)
            weights /= weights.sum()

        packed = build_forest(trees, [c], multi_label=False)
        return BoostedForest(forest=packed, weights=np.asarray(alphas, np.float32))


# ----------------------------------------------------------------------
# Reference binary IO (classifier.cpp:250-280 writer layout)
# ----------------------------------------------------------------------


def save_boosted_forest(path: str, boosted: BoostedForest) -> None:
    forest = boosted.forest
    with open(path, "wb") as f:
        f.write(struct.pack("<i", forest.num_trees))
        for t in range(forest.num_trees):
            f.write(struct.pack("<f", float(boosted.weights[t])))
            view = forest.tree_view(t)
            n = len(view.split_feature)
            is_leaf = view.left_child == 0
            raw = RawTree(
                split_features=view.split_feature,
                thresholds=view.threshold,
                left_child=view.left_child,
                histograms=[
                    view.leaf_hist[v, 0, : forest.class_counts[0]].astype(np.float32)
                    if is_leaf[v]
                    else np.zeros(0, np.float32)
                    for v in range(n)
                ],
                multi_histograms=[[] for _ in range(n)],
            )
            write_reference_tree(f, raw)


def load_boosted_forest(path: str) -> BoostedForest:
    with open(path, "rb") as f:
        (count,) = struct.unpack("<i", f.read(4))
        weights: List[float] = []
        trees: List[TreeArrays] = []
        c = 1
        for _ in range(count):
            (w,) = struct.unpack("<f", f.read(4))
            weights.append(w)
            raw = read_reference_tree(f)
            c = max(c, max((len(h) for h in raw.histograms), default=1))
            n = len(raw.split_features)
            hist = np.zeros((n, 1, c), np.float32)
            for v, h in enumerate(raw.histograms):
                hist[v, 0, : len(h)] = h
            trees.append(
                TreeArrays(
                    split_feature=raw.split_features.astype(np.int32),
                    threshold=raw.thresholds.astype(np.float32),
                    left_child=raw.left_child.astype(np.int32),
                    leaf_hist=hist,
                )
            )
        # Re-pad histograms to the global class count.
        for i, t in enumerate(trees):
            if t.leaf_hist.shape[2] < c:
                padded = np.zeros((t.leaf_hist.shape[0], 1, c), np.float32)
                padded[:, :, : t.leaf_hist.shape[2]] = t.leaf_hist
                trees[i] = TreeArrays(
                    t.split_feature, t.threshold, t.left_child, padded
                )
        forest = build_forest(trees, [c], multi_label=False)
        return BoostedForest(forest=forest, weights=np.asarray(weights, np.float32))
