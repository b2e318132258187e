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
        [n_points] [n_trees] [split_bins] [--device cuda|cpu] [--pairs P]
        [--first fused|loop]

``learn`` grows the forest's trees together in one level loop (the fused
forest); the tree loop grows them one after another (``grow_tree`` per
tree, as ``learn`` does with a checkpoint). A cold pass at seed 0 (the
process's first training, with the card's lazy set-up; ``--first`` says
which path takes it) is followed by ``P`` warm pairs at seed 17, the fused
forest and the tree loop in turns (fused first in even pairs), each with
its peak of allocated device memory. Prints the card's name and power
limit, then one JSON line ``{"metric": "train_points_per_sec", ...}``: the
fused forest's warm rate (its first warm run, the number comparable to the
reference's), and beside it every run of both paths. On the card by
default; without one, ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.forest import build_forest
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
    ap.add_argument("--pairs", type=int, default=1,
                    help="warm (fused, tree loop) pairs, in turns")
    ap.add_argument("--first", choices=("fused", "loop"), default="fused",
                    help="the path of the cold pass")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, trees, bins = args.n_points, args.n_trees, args.split_bins
    feats, labels = make_dataset(n)
    cuda = dev.type == "cuda"

    def train(path: str, seed: int):
        """-> (forest, wall s, peak allocated bytes or None)."""
        config = TrainerConfig(num_trees=trees, max_depth=30,
                               min_split_examples=50, split_bins=bins,
                               seed=seed)
        trainer = ForestTrainer(config, dev)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        if path == "fused":
            forest = trainer.learn(feats, labels, class_counts=CLASS_COUNTS,
                                   progress=False)
        else:
            data = trainer.prepare(feats, labels, class_counts=CLASS_COUNTS)
            forest = build_forest(
                [trainer.grow_tree(data, t) for t in range(trees)],
                data.class_counts, multi_label=data.multi_label)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
        return forest, wall, torch.cuda.max_memory_allocated() if cuda else None

    _, cold, cold_peak = train(args.first, 0)
    runs = {"fused": [], "loop": []}
    forests = {}
    for i in range(args.pairs):
        for path in (("fused", "loop") if i % 2 == 0 else ("loop", "fused")):
            forests[path], wall, peak = train(path, 17)
            runs[path].append({"s": wall, "peak_bytes": peak})
    forest = forests["fused"]
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        if not np.array_equal(getattr(forest, f), getattr(forests["loop"], f)):
            raise RuntimeError(f"the fused forest's {f} differs from the "
                               "tree loop's")
    warm = runs["fused"][0]["s"]
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
        "cold_s": cold if args.first == "fused" else None,
        "fused_runs": runs["fused"],
        "tree_loop": {
            "warm_s": runs["loop"][0]["s"],
            "cold_s": cold if args.first == "loop" else None,
            "runs": runs["loop"],
        },
        "cold_path": args.first,
        "cold_peak_bytes": cold_peak,
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
