"""Tree-parallel forest training across devices.

Counterpart of ``rovinasemanticsegmentation_tpu/parallel/tree_parallel.py``.
The reference trains trees concurrently with OpenMP threads
(``/root/reference/third-party/libforest/src/learning.cpp:1046``,
``num_threads(8)`` at ``src/train.cpp:239``). Trees are independent: here
host threads take trees round-robin over a list of devices (a list may name
one card more than once), each with the training set staged once per
distinct device.

Tree ``t`` is :meth:`ForestTrainer.grow_tree`'s tree ``t``, drawn from
``default_rng((seed, t))``: the forest equals the sequential trainer's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.forest import Forest, TreeArrays, build_forest
from ..train.forest_trainer import ForestTrainer, TrainerConfig


def learn_forest_parallel(
    config: TrainerConfig,
    features: np.ndarray,
    labels: np.ndarray,
    class_counts: Optional[Sequence[int]] = None,
    multi_label: Optional[bool] = None,
    devices: Optional[List] = None,
) -> Forest:
    """Train ``config.num_trees`` trees round-robin over ``devices``
    (default: every card; raises where there is none)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or ["cuda"]
    devices = [resolve_device(d) for d in devices]
    trainers = {}
    for dev in devices:
        if dev not in trainers:
            trainer = ForestTrainer(config, dev)
            trainers[dev] = (trainer, trainer.prepare(
                features, labels, class_counts, multi_label))
    data0 = next(iter(trainers.values()))[1]

    def train_one(t: int) -> TreeArrays:
        trainer, data = trainers[devices[t % len(devices)]]
        return trainer.grow_tree(data, t)

    with ThreadPoolExecutor(max_workers=min(len(devices), config.num_trees)) as ex:
        trees = list(ex.map(train_one, range(config.num_trees)))
    return build_forest(trees, data0.class_counts, multi_label=data0.multi_label)
