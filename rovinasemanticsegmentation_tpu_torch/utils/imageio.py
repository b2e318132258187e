"""Dataset image IO: RGB PNGs, 16-bit depth PGM/PNG, PPM (CRF demo images).

The port's copy of ``rovinasemanticsegmentation_tpu/utils/imageio.py``, kept so that
the port imports nothing of the JAX package.

The reference leans on ``cv::imread``/``cv::imwrite``
(``src/train.cpp:122-128``) and on PPM helpers in the densecrf
examples (``third-party/densecrf/examples/ppm.cpp``). Here PIL handles
PNG/PGM; PPM has a tiny binary parser so the CRF parity demo has no extra
dependencies.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

try:  # PIL is baked into the image
    from PIL import Image

    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def load_color(path: str) -> np.ndarray:
    """Load an RGB image as [H, W, 3] uint8 (cv::imread COLOR, but RGB order).

    The reference immediately converts BGR->RGB after imread
    (train.cpp:123), so RGB is the canonical in-memory order here.
    """
    if not _HAS_PIL:
        raise RuntimeError("PIL is unavailable")
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_depth(path: str) -> np.ndarray:
    """Load a 16-bit depth image (millimeters) as [H, W] uint16.

    Mirrors ``cv::imread(..., CV_LOAD_IMAGE_ANYDEPTH)`` on the dataset's
    ``.pgm`` depth files (train.cpp:125).
    """
    if path.lower().endswith(".pgm"):
        return _load_pnm(path)[0].astype(np.uint16)
    if not _HAS_PIL:
        raise RuntimeError("PIL is unavailable")
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint16)


def save_color(path: str, rgb: np.ndarray) -> None:
    if not _HAS_PIL:
        raise RuntimeError("PIL is unavailable")
    Image.fromarray(np.asarray(rgb, dtype=np.uint8), mode="RGB").save(path)


# ----------------------------------------------------------------------
# PNM (PPM/PGM) binary formats, for densecrf example parity inputs.
# ----------------------------------------------------------------------

_PNM_HEADER = re.compile(rb"^(P[256])\s+(?:#.*\s+)*(\d+)\s+(\d+)\s+(\d+)\s")


def _load_pnm(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()
    m = _PNM_HEADER.match(data)
    if not m:
        raise ValueError(f"Not a binary PNM file: {path}")
    magic, w, h, maxval = m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))
    body = data[m.end():]
    channels = 3 if magic == b"P6" else 1
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    count = w * h * channels
    arr = np.frombuffer(body, dtype=dtype, count=count)
    shape = (h, w, 3) if channels == 3 else (h, w)
    return arr.reshape(shape).astype(np.uint16 if maxval > 255 else np.uint8), maxval


def load_ppm(path: str) -> np.ndarray:
    """Load a binary PPM as [H, W, 3] uint8 (densecrf examples/ppm.cpp)."""
    arr, _ = _load_pnm(path)
    if arr.ndim != 3:
        raise ValueError(f"Expected a P6 PPM: {path}")
    return arr.astype(np.uint8)


def save_ppm(path: str, rgb: np.ndarray) -> None:
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())
