"""Camera calibration: intrinsics and SE(3) extrinsics with JSON IO.

The port's copy of ``rovinasemanticsegmentation_tpu/utils/calibration.py``, kept so that
the port imports nothing of the JAX package.

Capability parity with ``Calibration``
(``include/calibration.h:10-24``,
``src/calibration.cpp:16-108``):

- the JSON ``intrinsic`` array is row-major 3x3 (the reference fills Eigen
  column-major then transposes in place, calibration.cpp:34-37);
- rotation formats ``q3`` (xyz quaternion, w recovered as sqrt(1-x2-y2-z2)),
  ``q4`` (xyzw quaternion), and ``r3`` (column-major 3x3 matrix — Eigen
  linear-index fill without transpose, calibration.cpp:60-66);
- ``translation`` is a 3-vector.

Matrices are exposed as float32 NumPy arrays ready for ``torch.from_numpy``.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np


def quaternion_to_matrix(x: float, y: float, z: float, w: float) -> np.ndarray:
    """Unit-quaternion to rotation matrix (Eigen ``Quaternion::matrix`` semantics)."""
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=np.float32,
    )


class Calibration:
    """Intrinsics (+inverse) and SE(3) extrinsics for one camera."""

    def __init__(
        self,
        intrinsic: Optional[np.ndarray] = None,
        rotation: Optional[np.ndarray] = None,
        translation: Optional[np.ndarray] = None,
        filename: Optional[str] = None,
    ):
        if filename is not None:
            self._load(filename)
            return
        self.intrinsic = (
            np.eye(3, dtype=np.float32)
            if intrinsic is None
            else np.asarray(intrinsic, dtype=np.float32)
        )
        self.rotation = (
            np.eye(3, dtype=np.float32)
            if rotation is None
            else np.asarray(rotation, dtype=np.float32)
        )
        self.translation = (
            np.zeros(3, dtype=np.float32)
            if translation is None
            else np.asarray(translation, dtype=np.float32)
        )

    # ------------------------------------------------------------------
    @property
    def intrinsic_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.intrinsic).astype(np.float32)

    @property
    def extrinsic(self) -> np.ndarray:
        """4x4 homogeneous [R | t] matrix."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.rotation
        m[:3, 3] = self.translation
        return m

    # ------------------------------------------------------------------
    def _load(self, filename: str) -> None:
        with open(filename, "r") as f:
            calib = json.load(f)
        for key in ("intrinsic", "translation", "rotation"):
            if key not in calib:
                raise ValueError(f"Calibration file {filename} is not complete!")
        # Row-major 3x3 (calibration.cpp:34-37).
        self.intrinsic = np.array(calib["intrinsic"], dtype=np.float32).reshape(3, 3)

        rot = calib["rotation"]
        fmt = rot.get("format")
        data = rot.get("data", [])
        if fmt == "q3":
            qx, qy, qz = (float(v) for v in data[:3])
            qw = math.sqrt(max(0.0, 1.0 - qx * qx - qy * qy - qz * qz))
            self.rotation = quaternion_to_matrix(qx, qy, qz, qw)
        elif fmt == "q4":
            qx, qy, qz, qw = (float(v) for v in data[:4])
            self.rotation = quaternion_to_matrix(qx, qy, qz, qw)
        elif fmt == "r3":
            # Eigen linear-index fill = column-major (calibration.cpp:60-66).
            self.rotation = (
                np.array(data, dtype=np.float32).reshape(3, 3, order="F")
            )
        else:
            raise ValueError(f"Unknown rotation format: {fmt!r}")

        self.translation = np.array(calib["translation"], dtype=np.float32)

    def save_to_file(self, filename: str) -> None:
        """Save as r3-format JSON (calibration.cpp:76-108)."""
        calib = {
            "intrinsic": [float(v) for v in self.intrinsic.reshape(-1)],
            "translation": [float(v) for v in self.translation],
            "rotation": {
                "format": "r3",
                # Column-major to round-trip through the r3 loader.
                "data": [float(v) for v in self.rotation.reshape(-1, order="F")],
            },
        }
        with open(filename, "w") as f:
            json.dump(calib, f, indent=2)
