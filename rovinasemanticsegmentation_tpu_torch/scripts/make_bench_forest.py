"""Train the fixture forest's recipe with the port: synthetic VGA frames,
real 366-feature extraction at stride 5, two heuristic label layers, and a
4-tree forest of depth <= 30.

Usage:

    python -m rovinasemanticsegmentation_tpu_torch.scripts.make_bench_forest \
        --out <forest.dat> [--device cuda|cpu]

The recipe is the reference package's ``scripts/make_bench_forest.py``
(which wrote ``resources/bench_forest.dat``), copied here: ``FRAMES`` frames
from ``default_rng(42)`` (smooth depth with boxes and 2% holes, colour
loosely tied to depth), features at the training stride 5
(``resources/config.json:33``), a material layer (8 classes) from height
bands and an object layer (9 classes) from colour sums, and
``TrainerConfig(num_trees=4, max_depth=30, min_split_examples=50)``. The
frames continue the same generator, so frame ``FRAMES`` (the 13th) is a
held-out frame of the same distribution. Extraction and training run on
``--device``; the script never writes into ``resources/``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, List, Tuple

import numpy as np
import torch

H, W = 480, 640
TRAIN_STRIDE = 5
FRAMES = 12
SEED = 42
CLASS_COUNTS = (8, 9)


def make_depth(r: np.random.Generator) -> np.ndarray:
    ys, xs = np.mgrid[0:H, 0:W]
    depth = (
        3000.0
        + 1500.0 * np.sin(xs / W * np.pi * r.uniform(0.5, 2.0))
        + 1000.0 * (ys / H) * r.uniform(0.5, 3.0)
    )
    for _ in range(6):
        y0, x0 = r.integers(0, H - 80), r.integers(0, W - 120)
        bh, bw = r.integers(60, 180), r.integers(80, 240)
        depth[y0 : y0 + bh, x0 : x0 + bw] = r.uniform(700, 2500)
    depth += r.normal(0, 15, (H, W))
    depth[r.random((H, W)) < 0.02] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


def make_rgb(r: np.random.Generator, depth: np.ndarray) -> np.ndarray:
    """Colour loosely correlated with depth structure (smooth + patches)."""
    base = (depth.astype(np.float32) / 15500.0 * 200.0)[..., None]
    rgb = base + r.normal(0, 20, (H, W, 3))
    for _ in range(8):
        y0, x0 = r.integers(0, H - 60), r.integers(0, W - 80)
        bh, bw = r.integers(40, 160), r.integers(60, 200)
        rgb[y0 : y0 + bh, x0 : x0 + bw] += r.uniform(-80, 80, 3)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def frame_labels(rgb: np.ndarray, depth: np.ndarray) -> List[np.ndarray]:
    """Material (8) from height bands, object (9) from colour; -1 = no depth."""
    z = depth.astype(np.float32) / 1000.0
    ys = np.mgrid[0:H, 0:W][0]
    height_proxy = (ys.astype(np.float32) / H) * z
    mat = np.clip((height_proxy / 6.0 * 8.0).astype(np.int64), 0, 7)
    obj = np.clip((rgb.astype(np.int64).sum(-1) // 96), 0, 8)
    mat[depth == 0] = -1
    obj[depth == 0] = -1
    return [mat.astype(np.int8), obj.astype(np.int8)]


def frames(seed: int = SEED) -> Iterator[Tuple[np.ndarray, np.ndarray, List[np.ndarray]]]:
    """(rgb, depth, labels) of the recipe's frames, in order, without end."""
    rng = np.random.default_rng(seed)
    while True:
        depth = make_depth(rng)
        rgb = make_rgb(rng, depth)
        yield rgb, depth, frame_labels(rgb, depth)


def calibration():
    from ..utils.calibration import Calibration

    return Calibration(
        intrinsic=np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]]),
        rotation=np.eye(3),
        translation=np.zeros(3),
    )


def extract(frame_list, device) -> Tuple[torch.Tensor, np.ndarray]:
    """Labelled features of ``frame_list`` at the training stride:
    (features [N, 366] float32 on ``device``, labels [N, 2] int32)."""
    from ..features.extractor import ExtractType, FeatureConfig, FeatureExtractor

    extractor = FeatureExtractor(FeatureConfig(), device)
    calib = calibration()
    feats, labels = [], []
    for rgb, depth, layers in frame_list:
        batch = extractor.extract(
            rgb, depth, calib, stride=TRAIN_STRIDE,
            label_extraction=ExtractType.WITH_POSITIVE_LABEL, labels=layers,
        )
        feats.append(batch.features[batch.mask])
        labels.append(batch.labels[batch.mask])
    return torch.cat(feats), torch.cat(labels).cpu().numpy().astype(np.int32)


def trainer_config(**overrides):
    from ..train.forest_trainer import TrainerConfig

    return TrainerConfig(
        **{"num_trees": 4, "max_depth": 30, "min_split_examples": 50,
           **overrides})


def main(argv=None) -> None:
    from ..device import resolve_device
    from ..models.forest import save_forest
    from ..train.forest_trainer import ForestTrainer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="forest.dat to write")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    gen = frames()
    t0 = time.perf_counter()
    x, y = extract([next(gen) for _ in range(FRAMES)], dev)
    t1 = time.perf_counter()
    print(f"extracted {len(x)} samples x {x.shape[1]} features in "
          f"{t1 - t0:.2f}s")
    forest = ForestTrainer(trainer_config(), dev).learn(
        x, y, class_counts=list(CLASS_COUNTS), progress=False)
    print(f"trained in {time.perf_counter() - t1:.2f}s; "
          f"nodes per tree: {forest.node_counts}, depth {forest.max_depth}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_forest(args.out, forest)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
