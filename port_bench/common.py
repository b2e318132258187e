"""What the drivers share: the configuration read once, for the port and for
the reference, and the comparison of labels."""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference import frame as ref_frame

# Posteriors of masked grid points: 0, as the node initialises them
# (segmenter.cpp:358-362).
FILL = 0.0


@dataclass(frozen=True)
class Setting:
    """The configuration's sizes and settings as the drivers use them."""

    conf: dict
    root: str

    @property
    def h(self) -> int:
        return int(self.conf["camera"]["height"])

    @property
    def w(self) -> int:
        return int(self.conf["camera"]["width"])

    @property
    def focal(self) -> float:
        return float(self.conf["camera"]["fx"])

    @property
    def intrinsic(self) -> np.ndarray:
        cam = self.conf["camera"]
        return np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                         [0, 0, 1]], np.float32)

    @property
    def kinv(self) -> np.ndarray:
        return np.linalg.inv(self.intrinsic).astype(np.float32)

    @property
    def stride(self) -> int:
        return int(self.conf["rf_prediction_stride"])

    @property
    def class_counts(self) -> Tuple[int, ...]:
        return tuple(sum(1 for c in layer["coding"] if c["label"] >= 0)
                     for layer in self.conf["color_codings"])

    @property
    def unknown_labels(self) -> Tuple[int, ...]:
        return tuple(next(c["label"] for c in layer["coding"]
                          if c["name"] == "Unknown")
                     for layer in self.conf["color_codings"])

    @property
    def layer_names(self) -> List[str]:
        return [layer["name"] for layer in self.conf["color_codings"]]

    @property
    def forest_path(self) -> str:
        return os.path.join(self.root, self.conf["forest_file"])

    @property
    def frame_config(self) -> ref_frame.FrameConfig:
        return ref_frame.FrameConfig.from_config(self.conf)


@functools.lru_cache(maxsize=4)
def reference_forest(path: str, class_counts: Tuple[int, ...], device: str):
    """The forest file decoded by the reference, on ``device``."""
    return ref_frame.Forest(ref_frame.read_forest(path, class_counts), device)


def reference_frame(setting: Setting, rgb: np.ndarray, depth_mm: np.ndarray,
                    device, dtype=torch.float32):
    """One keyframe through the reference frame path on ``device``: ->
    (per-layer posteriors [H, W, C_l], per-layer int8 labels [H, W])."""
    forest = reference_forest(setting.forest_path, setting.class_counts,
                              str(device))
    return ref_frame.run_frame(
        torch.from_numpy(np.ascontiguousarray(rgb)).to(device),
        torch.from_numpy(np.asarray(depth_mm, np.int32)).to(device),
        setting.kinv, np.eye(3), np.zeros(3), setting.frame_config, forest,
        setting.class_counts, FILL, dtype)


def mismatch(got: Sequence, want: Sequence) -> float:
    """The largest share of differing labels over the layers (arrays or
    tensors, compared element by element)."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g = np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g).reshape(-1)
        w = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w).reshape(-1)
        if g.shape != w.shape:
            return 1.0
        worst = max(worst, float((g.astype(np.int64) != w.astype(np.int64)).mean()))
    return worst
