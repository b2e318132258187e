"""Input generators of the benchmark, frozen here.

``make_depth``, ``make_cloud`` and ``perturb`` are copies of the port's
bench generators (``rovinasemanticsegmentation_tpu_torch/bench.py``, which
copied ``bench.py``'s): piecewise-smooth indoor depth with sensor noise and
2% holes, a local map backprojected from keyframes' surfaces, and a
content-varying perturbation per batch. ``perturb_np`` is ``perturb`` on the
host, for the reference. Nothing here imports the port.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def make_depth(r: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Piecewise-smooth indoor-style depth in mm with sensor noise and 2%
    holes, box sizes as fractions of the frame."""
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (
        3000.0
        + 1500.0 * np.sin(xs / w * np.pi * r.uniform(0.5, 2.0))
        + 1000.0 * (ys / h) * r.uniform(0.5, 3.0)
    )
    for _ in range(6):  # furniture-like fronto-parallel boxes
        y0, x0 = r.integers(0, h - h // 6), r.integers(0, w - 3 * w // 16)
        bh, bw = r.integers(h // 8, 3 * h // 8), r.integers(w // 8, 3 * w // 8)
        depth[y0 : y0 + bh, x0 : x0 + bw] = r.uniform(700, 2500)
    depth += r.normal(0, 15, (h, w))  # sensor noise
    holes = r.random((h, w)) < 0.02  # dropouts
    depth[holes] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


def make_cloud(r: np.random.Generator, frames, focal: float, h: int, w: int,
               map_every: int, map_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """A local map backprojected from the first ``map_every`` keyframes'
    surfaces, with a per-keyframe pose drift: -> (points [N, 3], RGB in
    [0, 1] [N, 3]), float32."""
    fx, fy, cx, cy = focal, focal, w / 2, h / 2
    pts, cols = [], []
    per_frame = map_points // map_every
    for f in range(map_every):
        d = frames[f][1].astype(np.float32) / 1000.0
        ys = r.integers(0, h, per_frame)
        xs = r.integers(0, w, per_frame)
        z = d[ys, xs]
        z = np.where(z > 0, z, 2.0)
        pts.append(
            np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=1)
            + np.array([0.05, 0.02, 0.0]) * f  # per-keyframe pose drift
        )
        cols.append(frames[f][0][ys, xs].astype(np.float32) / 255.0)
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(cols).astype(np.float32))


def make_pool(seed: int, n: int, h: int, w: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` keyframes (rgb uint8 [H, W, 3], depth uint16 mm [H, W]) drawn
    from one generator; -> the frames and the generator, for what follows."""
    rng = np.random.default_rng(seed)
    frames = [
        (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), make_depth(rng, h, w))
        for _ in range(n)
    ]
    return frames, rng


def perturb(rgb, depth, e: int):
    """A content-varying, validity-preserving tweak of staged frames (device
    tensors): the RGB XORed with ``e``, ``e`` added to depth where it is
    nonzero."""
    return rgb ^ (e & 0xFF), torch.where(depth > 0, depth + e, depth)


def perturb_np(rgb: np.ndarray, depth: np.ndarray, e: int):
    """:func:`perturb` on host arrays: -> (rgb uint8, depth int32 mm)."""
    d = depth.astype(np.int32)
    return rgb ^ np.uint8(e & 0xFF), np.where(d > 0, d + e, d)
