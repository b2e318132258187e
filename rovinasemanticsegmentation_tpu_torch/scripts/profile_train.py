"""Where forest training's time goes on the card, from one ``torch.profiler``
window over the fixture recipe.

Usage (on a machine with an NVIDIA GPU, from the repository root):

    python rovinasemanticsegmentation_tpu_torch/scripts/profile_train.py \
        [--root DIR] [--mode exact|binned] [--path fused|loop]

Extracts the recipe's 12 VGA frames on the card (``make_bench_forest.py``:
~1.45e5 samples x 366 features), trains the recipe's forest (4 trees of
depth <= 30) through ``learn`` (``--path fused``: every tree in one level
loop) or one tree after another (``--path loop``: ``grow_tree`` per tree)
once to warm up and once more unprofiled (wall seconds), then once under
``torch.profiler``, and prints the card's name and power limit, then one
JSON line: the unprofiled wall seconds, the device time (the sum of the
device activities' durations, and their union), the device's idle share
(one minus the union over the profiled wall time), the levels (each
tree's deepest leaf; the forest's is the deepest tree's, the trees' their
sum), the device activities per level of the forest and per level of a
tree, and the top device activities and CPU-side operators by device time.

``--root`` imports the package from another checkout, so that two versions
compare in one call on one card (an older checkout's ``learn`` may grow
one tree after another).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from typing import List, Optional

import torch


def _union_us(device) -> float:
    busy, edge = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, edge), e.time_range.end
        busy += max(0.0, hi - lo)
        edge = max(edge, hi)
    return busy


def profile_training(train, top: int = 12) -> dict:
    """``train()`` once warm, once timed, once profiled -> the numbers."""
    from torch.profiler import ProfilerActivity, profile

    from rovinasemanticsegmentation_tpu_torch.models.forest import (
        _tree_max_depth,
    )

    train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest = train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events if e.device_type.name != "CPU"]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    ops = sorted(
        ((e.key, e.device_time_total, e.count) for e in prof.key_averages()
         if e.device_time_total > 0 and e.key.startswith("aten::")),
        key=lambda r: -r[1])[:top]
    depths = [_tree_max_depth(forest.tree_view(t).left_child)
              for t in range(forest.num_trees)]
    busy = _union_us(device)
    return {
        "trees": forest.num_trees,
        "nodes_per_tree": list(forest.node_counts),
        "levels_per_tree": depths,
        "wall_s": wall,
        "profiled_wall_s": prof_wall,
        "device_s": sum(v[0] for v in by_name.values()) / 1e6,
        "busy_s": busy / 1e6,
        "idle_share": 1.0 - busy / 1e6 / prof_wall,
        "device_activities": len(device),
        "activities_per_forest_level": len(device) / max(max(depths), 1),
        "activities_per_tree_level": len(device) / max(sum(depths), 1),
        "top_kernels": [
            {"name": name[:90], "ms": us / 1000, "count": n}
            for name, (us, n) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:top]],
        "top_ops": [{"op": k, "device_ms": t / 1000, "calls": n}
                    for k, t, n in ops],
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose package is profiled (default: this one)")
    ap.add_argument("--mode", choices=("exact", "binned"), default="exact")
    ap.add_argument("--path", choices=("fused", "loop"), default="fused")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the training profile measures the card: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rovinasemanticsegmentation_tpu_torch.scripts import card_description
    from rovinasemanticsegmentation_tpu_torch.models.forest import build_forest
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        make_bench_forest as recipe,
    )
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        ForestTrainer,
    )

    gen = recipe.frames()
    x, y = recipe.extract([next(gen) for _ in range(recipe.FRAMES)], "cuda")
    cfg = recipe.trainer_config(split_bins=256 if args.mode == "binned" else 0)
    counts = list(recipe.CLASS_COUNTS)

    def train():
        trainer = ForestTrainer(cfg, "cuda")
        if args.path == "fused":
            return trainer.learn(x, y, class_counts=counts, progress=False)
        data = trainer.prepare(x, y, class_counts=counts)
        return build_forest([trainer.grow_tree(data, t)
                             for t in range(cfg.num_trees)],
                            counts, multi_label=data.multi_label)

    out = dict(profile_training(train), mode=args.mode, path=args.path,
               samples=len(x), root=root)
    print(card_description())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
