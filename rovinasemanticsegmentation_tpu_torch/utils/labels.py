"""Label <-> RGB color coding, vectorized.

The port's copy of ``rovinasemanticsegmentation_tpu/utils/labels.py``, kept so that
the port imports nothing of the JAX package.

Capability parity with ``RgbLabelConversion``
(``include/rgb_label_conversion.h:15-119``), re-designed as
NumPy LUT/gather operations so whole label images convert in one shot.

Semantics preserved from the reference:

- labels are signed 8-bit (``label_type = char``, ``include/defines.h:3``),
  with ``NO_LABEL = -5`` (``include/defines.h:5``);
- colors are keyed by the packed integer ``1000000*r + 1000*g + b``
  (``rgb_label_conversion.h:38``);
- an *unmapped* color maps to label 0 and an unmapped label to color
  ``(0,0,0)`` — the reference uses ``std::map::operator[]`` which
  default-constructs missing entries (``rgb_label_conversion.h:80-88``);
- ``valid_label_count`` counts labels >= 0 (``rgb_label_conversion.h:103-110``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

NO_LABEL: int = -5  # include/defines.h:5

LABEL_DTYPE = np.int8  # label_type = char (include/defines.h:3)


def _pack_rgb(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (
        1000000 * r.astype(np.int64) + 1000 * g.astype(np.int64) + b.astype(np.int64)
    )


class RgbLabelConversion:
    """Bidirectional label<->RGB mapping from a JSON coding list."""

    def __init__(self, coding: "str | Sequence[dict]"):
        if isinstance(coding, str):
            coding = json.loads(coding)
        self._name_to_label: Dict[str, int] = {}
        self._label_to_name: Dict[int, str] = {}
        self._label_to_rgb: Dict[int, Tuple[int, int, int]] = {}
        self._packed_to_label: Dict[int, int] = {}
        for c in coding:
            name = str(c["name"])
            label = int(c["label"])
            r, g, b = (int(v) & 0xFF for v in c["color"])
            self._name_to_label[name] = label
            self._label_to_name[label] = name
            self._label_to_rgb[label] = (r, g, b)
            self._packed_to_label[1000000 * r + 1000 * g + b] = label

        # Vectorized RGB->label table: sorted packed keys + labels, so image
        # conversion is a searchsorted + gather instead of a per-pixel map.
        packed = np.array(sorted(self._packed_to_label.keys()), dtype=np.int64)
        labels = np.array(
            [self._packed_to_label[k] for k in packed], dtype=LABEL_DTYPE
        )
        self._sorted_packed = packed
        self._sorted_labels = labels

        # Vectorized label->RGB table indexed by label+128 (labels are int8).
        lut = np.zeros((256, 3), dtype=np.uint8)  # unmapped -> (0,0,0)
        for label, (r, g, b) in self._label_to_rgb.items():
            lut[label + 128] = (r, g, b)
        self._label_rgb_lut = lut

    # ------------------------------------------------------------------
    # Image-wise conversions
    # ------------------------------------------------------------------
    def label_to_rgb(self, labels: np.ndarray) -> np.ndarray:
        """[H, W] int labels -> [H, W, 3] uint8 RGB (rgb_label_conversion.h:42-54)."""
        labels = np.asarray(labels).astype(np.int16)
        return self._label_rgb_lut[labels + 128]

    def rgb_to_label(self, rgb: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 RGB -> [H, W] int8 labels (rgb_label_conversion.h:56-77).

        Unmapped colors become label 0, matching the reference's
        ``std::map::operator[]`` default construction.
        """
        rgb = np.asarray(rgb)
        packed = _pack_rgb(rgb[..., 0], rgb[..., 1], rgb[..., 2])
        idx = np.searchsorted(self._sorted_packed, packed.ravel())
        idx = np.clip(idx, 0, len(self._sorted_packed) - 1)
        found = self._sorted_packed[idx] == packed.ravel()
        out = np.where(found, self._sorted_labels[idx], LABEL_DTYPE(0))
        return out.reshape(packed.shape).astype(LABEL_DTYPE)

    # ------------------------------------------------------------------
    # Scalar lookups
    # ------------------------------------------------------------------
    def get_label_name(self, label: int) -> str:
        return self._label_to_name.get(int(label), "")

    def get_label_number(self, name: str) -> int:
        return self._name_to_label.get(name, 0)

    def get_label_color(self, label: int) -> Tuple[int, int, int]:
        return self._label_to_rgb.get(int(label), (0, 0, 0))

    @property
    def label_count(self) -> int:
        return len(self._name_to_label)

    @property
    def valid_label_count(self) -> int:
        """Number of labels >= 0 (rgb_label_conversion.h:103-110)."""
        return sum(1 for l in self._label_to_name if l >= 0)


class LayerCoding:
    """Per-layer class metadata parsed from ``color_codings``.

    Mirrors the Segmenter constructor's parsing (``src/segmenter.cpp:72-98``):
    for each layer keep the valid (label >= 0) class names and colors in label
    order, and record the index of the ``Unknown`` class (default label), or 0
    if absent.
    """

    def __init__(self, name: str, coding: Sequence[dict]):
        self.name = str(name)
        self.class_names: List[str] = []
        self.class_colors: List[Tuple[int, int, int]] = []
        self.unknown_label: int = -1
        for c in coding:
            if int(c["label"]) >= 0:
                self.class_names.append(str(c["name"]))
                self.class_colors.append(tuple(int(v) for v in c["color"]))
            # Reference checks the *name* against "Unknown", and records the
            # index of the most recently appended valid class
            # (segmenter.cpp:88-91).
            if str(c["name"]) == "Unknown" and self.unknown_label < 0:
                self.unknown_label = len(self.class_names) - 1
        if self.unknown_label < 0:
            self.unknown_label = 0  # segmenter.cpp:93-96
        self.conversion = RgbLabelConversion(list(coding))

    @property
    def class_count(self) -> int:
        return len(self.class_names)


def parse_color_codings(color_codings: Sequence[dict]) -> List[LayerCoding]:
    """Parse the config's ``color_codings`` list into LayerCoding objects."""
    return [LayerCoding(l["name"], l["coding"]) for l in color_codings]
