"""Disk dataset access for the train/test CLIs.

The port's copy of ``rovinasemanticsegmentation_tpu/features/dataset.py``, kept so that
the port imports nothing of the JAX package.

Mirrors the data plumbing of the reference CLIs
(``src/train.cpp:57-128``, ``src/test_multi.cpp:62-165``):
file-name lists come from config JSON indirection, images live in
``<root_dir>/<kind_dir>/<name><kind_ext>``, color images are converted to RGB
at load (train.cpp:123), labels decode through the per-layer color codings,
and calibrations load from per-image JSON files.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.calibration import Calibration
from ..utils.config import Config
from ..utils.imageio import load_color, load_depth, save_color
from ..utils.labels import LayerCoding, RgbLabelConversion, parse_color_codings


@dataclass
class DatasetSample:
    name: str
    rgb: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] uint16 (mm)
    calibration: Calibration
    labels: List[np.ndarray]  # per layer [H, W] int8 (empty if unlabeled)


class RovinaDataset:
    """File-list dataset in the reference's on-disk layout."""

    def __init__(
        self,
        conf: Config,
        split_key: str,
        layer_prefixes: Sequence[str],
        load_labels: bool = True,
    ):
        self.conf = conf
        self.names: List[str] = conf.get_from_file(split_key)
        self.color_dir = conf.get_path("color_dir")
        self.color_ext = conf.get_str("color_ext")
        self.depth_dir = conf.get_path("depth_dir")
        self.depth_ext = conf.get_str("depth_ext")
        self.calib_dir = conf.get_path("calibration_dir")
        self.calib_ext = conf.get_str("calibration_ext")
        self.load_labels = load_labels
        self.layer_prefixes = list(layer_prefixes)
        self.label_dirs = [
            conf.get_path(f"{p}_label_dir") for p in layer_prefixes
        ] if load_labels else []
        self.label_exts = [
            conf.get_str(f"{p}_label_ext") for p in layer_prefixes
        ] if load_labels else []
        codings = {
            l["name"]: l["coding"] for l in conf.get_raw("color_codings")
        }
        self.converters = [
            RgbLabelConversion(codings[p]) for p in layer_prefixes
        ] if load_labels else []

    def __len__(self) -> int:
        return len(self.names)

    def load(self, index: int) -> DatasetSample:
        name = self.names[index]
        rgb = load_color(f"{self.color_dir}{name}{self.color_ext}")
        depth = load_depth(f"{self.depth_dir}{name}{self.depth_ext}")
        calib = Calibration(filename=f"{self.calib_dir}{name}{self.calib_ext}")
        labels: List[np.ndarray] = []
        if self.load_labels:
            for d, e, conv in zip(self.label_dirs, self.label_exts, self.converters):
                labels.append(conv.rgb_to_label(load_color(f"{d}{name}{e}")))
        return DatasetSample(name, rgb, depth, calib, labels)

    def __iter__(self) -> Iterator[DatasetSample]:
        for i in range(len(self)):
            yield self.load(i)


def layer_prefixes_for(conf: Config) -> Tuple[List[str], bool]:
    """(layer prefixes, shared?) from ``training_label_prefix``.

    ``"shared"`` means one multi-label forest over [material, object]
    (train.cpp:89-164); anything else is a single-layer run (:165-223).
    """
    prefix = conf.get_str("training_label_prefix")
    if prefix == "shared":
        return ["material", "object"], True
    return [prefix], False


def model_path_for(conf: Config) -> str:
    prefixes, shared = layer_prefixes_for(conf)
    if shared:
        return conf.get_path("forest_file_name")
    return conf.get_path(f"{prefixes[0]}_forest_file_name")
