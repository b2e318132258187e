"""Forest-training throughput of the port on one card.

The counterpart of ``scripts/bench_train.py``. The reference's training
instrument is "Finished forest in N s" over 8 CPU threads
(``libforest/src/learning.cpp:1105``, ``src/train.cpp:239``). This trains
the port's ``ForestTrainer`` (device growth; exact split search, or the
binned search with ``split_bins > 0``) on a synthetic multi-label dataset
shaped like one training run's extracted features: ``n_points`` x 366
standard-normal features from seed 0, labels the argmax of features 0-7
(8 classes) and 8-16 (9 classes).

Usage:

    python -m rovinasemanticsegmentation_tpu_torch.scripts.bench_train \\
        [n_points] [n_trees] [split_bins] [--device cuda|cpu]

A cold pass (the first ``learn``, with the card's lazy set-up) is followed
by a warm pass of a second trainer at seed 17, the number comparable to the
reference's. Prints the card's name and power limit, then one JSON line
``{"metric": "train_points_per_sec", ...}``. On the card by default; without
one, ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..train.forest_trainer import ForestTrainer, TrainerConfig

NUM_FEATURES = 366
CLASS_COUNTS = [8, 9]


def make_dataset(n: int, d: int = NUM_FEATURES):
    """-> (features [n, d] float32, labels [n, 2] int32), the JAX script's."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    # Labels correlated with features so splits do real work.
    labels = np.stack(
        [
            (feats[:, :8].argmax(axis=1)).astype(np.int32),
            (feats[:, 8:17].argmax(axis=1)).astype(np.int32),
        ],
        axis=1,
    )
    return feats, labels


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_points", type=int, nargs="?", default=200_000)
    ap.add_argument("n_trees", type=int, nargs="?", default=4)
    ap.add_argument("split_bins", type=int, nargs="?", default=0,
                    help="> 0: binned split search over this many bins")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, trees, bins = args.n_points, args.n_trees, args.split_bins
    feats, labels = make_dataset(n)

    def learn(seed: int):
        config = TrainerConfig(num_trees=trees, max_depth=30,
                               min_split_examples=50, split_bins=bins,
                               seed=seed)
        start = time.perf_counter()
        forest = ForestTrainer(config, dev).learn(
            feats, labels, class_counts=CLASS_COUNTS, progress=False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return forest, time.perf_counter() - start

    _, cold = learn(0)
    forest, warm = learn(17)
    if dev.type == "cuda":
        from . import card_description

        card = card_description()
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        card, kind, platform = None, "cpu", "cpu"
    out = {
        "metric": "train_points_per_sec",
        "value": n * trees / warm,
        "unit": "point-trees/s",
        "points": n,
        "trees": trees,
        "split_bins": bins,
        "nodes": sum(forest.node_counts),
        "node_counts": list(forest.node_counts),
        "warm_s": warm,
        "cold_s": cold,
        "device": {"platform": platform, "kind": kind,
                   "count": torch.cuda.device_count() if card else 1,
                   "name_and_power_limit": card},
    }
    if card:
        print(card)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
