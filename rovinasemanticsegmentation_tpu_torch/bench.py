"""The synthetic workload of ``bench.py``, made on the host from a seed.

Thirty VGA keyframes (Xtion intrinsics 525 / 320 / 240) with
piecewise-smooth depth (:func:`make_depth`), one local map of 30000 surface
points every 5 keyframes (:func:`make_cloud`), the trained fixture forest
``resources/bench_forest.dat`` and the dense CRF's parameters. The stage
profilers under ``scripts/`` build their inputs from it, and
``port_bench/tests/test_bench_generators.py`` holds ``port_bench``'s frozen
generators equal to it; the benchmark itself is ``port_bench/``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .pipelines.local_map import CrfParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "resources", "bench_forest.dat")
CLASS_COUNTS = (8, 9)
UNKNOWN_LABELS = (7, 8)
STRIDE = 2
FOCAL = 525.0  # Xtion VGA intrinsics; the principal point is the centre
CRF = CrfParams(use_dense_crf=True, iterations=10)


@dataclass(frozen=True)
class Workload:
    """The sizes of ``bench.py``'s workload; the defaults are its own.
    ``batch`` and ``curve`` are dispatch sizes in keyframes, each checked to
    hold whole maps."""

    height: int = 480
    width: int = 640
    keyframes: int = 30  # per epoch
    map_every: int = 5  # keyframes per local map
    map_points: int = 30000
    batch: int = 10
    curve: Tuple[int, ...] = (5, 10, 15)

    def __post_init__(self):
        for b in (self.batch, *self.curve):
            if self.keyframes % b or b % self.map_every:
                raise ValueError(f"batch {b} must divide {self.keyframes} "
                                 f"keyframes and be a multiple of "
                                 f"{self.map_every}")
        if self.map_points % self.map_every:
            raise ValueError("map_points must be a multiple of map_every")


def make_depth(r: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Piecewise-smooth indoor-style depth in mm with sensor noise and 2%
    holes: ``bench.py``'s ``make_depth``, its box sizes as fractions of the
    frame (the same draws at VGA)."""
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


def make_cloud(r: np.random.Generator, frames, h: int, w: int, map_every: int,
               map_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """A local map backprojected from the first ``map_every`` keyframes'
    surfaces, with a per-keyframe pose drift (``bench.py``'s ``make_cloud``):
    -> (points [N, 3], RGB in [0, 1] [N, 3]), float32."""
    fx, fy, cx, cy = FOCAL, FOCAL, w / 2, h / 2
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


def make_workload(seed: int, wl: Workload):
    """-> (keyframes [(rgb uint8 [H, W, 3], depth uint16 mm [H, W])], the
    map cloud), drawn from one generator in ``bench.py``'s order."""
    rng = np.random.default_rng(seed)
    h, w = wl.height, wl.width
    frames = [
        (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), make_depth(rng, h, w))
        for _ in range(wl.keyframes)
    ]
    return frames, make_cloud(rng, frames, h, w, wl.map_every, wl.map_points)


def perturb(rgb: torch.Tensor, depth: torch.Tensor, e: int):
    """A content-varying, validity-preserving tweak of staged frames: the
    RGB XORed with ``e``, ``e`` added to depth where it is nonzero."""
    return rgb ^ (e & 0xFF), torch.where(depth > 0, depth + e, depth)
