"""Checkpointing: forests and training state as npz bundles (+ reference
``forest.dat`` interop).

Port of ``rovinasemanticsegmentation_tpu/utils/checkpoint.py`` onto the port's
``models/forest.py`` (same npz layout, so either package resumes the
other's checkpoints).

The reference's only checkpoint is the trained forest in its custom binary
format (``third-party/libforest/include/libforest/io.h``,
``classifier.cpp:210-235``; README warns model/config must move in lockstep).
Here the SoA tensors save natively as compressed npz (fast, self-describing)
while ``models/forest.py`` keeps full ``forest.dat`` interop; a converter
bridges the two. Trainer state checkpoints enable resumable forest training,
which the reference lacks.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Dict, Optional

import numpy as np

from ..models.forest import Forest, load_forest, save_forest


def save_forest_npz(path: str, forest: Forest) -> None:
    np.savez_compressed(
        path,
        split_feature=forest.split_feature,
        threshold=forest.threshold,
        left_child=forest.left_child,
        leaf_hist=forest.leaf_hist,
        class_counts=np.asarray(forest.class_counts, np.int32),
        node_counts=np.asarray(forest.node_counts, np.int32),
        max_depth=np.int32(forest.max_depth),
        multi_label=np.bool_(forest.multi_label),
    )


def load_forest_npz(path: str) -> Forest:
    with np.load(path) as z:
        return Forest(
            split_feature=z["split_feature"],
            threshold=z["threshold"],
            left_child=z["left_child"],
            leaf_hist=z["leaf_hist"],
            class_counts=tuple(int(c) for c in z["class_counts"]),
            node_counts=tuple(int(c) for c in z["node_counts"]),
            max_depth=int(z["max_depth"]),
            multi_label=bool(z["multi_label"]),
        )


def convert_reference_to_npz(dat_path: str, npz_path: str) -> Forest:
    """forest.dat -> npz."""
    forest = load_forest(dat_path)
    save_forest_npz(npz_path, forest)
    return forest


def convert_npz_to_reference(npz_path: str, dat_path: str) -> Forest:
    """npz -> forest.dat (loadable by the C++ tools)."""
    forest = load_forest_npz(npz_path)
    save_forest(dat_path, forest)
    return forest


@dataclass
class TrainingCheckpoint:
    """Resumable forest-training state: completed trees + RNG position.

    The reference trains all trees in one OpenMP run with no resume
    (learning.cpp:1031-1113); tree independence makes per-tree checkpointing
    natural here.
    """

    completed_trees: int
    seed: int
    config: Dict

    def save(self, path: str, partial_forest: Optional[Forest]) -> None:
        meta = json.dumps(asdict(self))
        arrays = {"meta": np.frombuffer(meta.encode(), np.uint8)}
        if partial_forest is not None:
            arrays.update(
                split_feature=partial_forest.split_feature,
                threshold=partial_forest.threshold,
                left_child=partial_forest.left_child,
                leaf_hist=partial_forest.leaf_hist,
                class_counts=np.asarray(partial_forest.class_counts, np.int32),
                node_counts=np.asarray(partial_forest.node_counts, np.int32),
                max_depth=np.int32(partial_forest.max_depth),
                multi_label=np.bool_(partial_forest.multi_label),
            )
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str):
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            forest = None
            if "split_feature" in z:
                forest = Forest(
                    split_feature=z["split_feature"],
                    threshold=z["threshold"],
                    left_child=z["left_child"],
                    leaf_hist=z["leaf_hist"],
                    class_counts=tuple(int(c) for c in z["class_counts"]),
                    node_counts=tuple(int(c) for c in z["node_counts"]),
                    max_depth=int(z["max_depth"]),
                    multi_label=bool(z["multi_label"]),
                )
        return cls(**meta), forest
