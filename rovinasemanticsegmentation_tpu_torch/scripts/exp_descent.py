"""Forest descent over a staged feature tile (C') against kernel B.

Port of ``scripts/exp_descent.py`` (the chunk-skip variant C of the TPU
descent kernel) with the real-feature input of
``scripts/exp_descent_real.py``. Features are reordered by how often the
forest splits on them (``usage_permutation``), the forest is rewritten to
match, and C' (``ops/forest_staged_cuda.py``) stages each tile's first
``hot`` columns in shared memory. Its leaf ids must equal kernel B's
(``ops/forest_cuda.py``, unpermuted inputs) and the plain descent's, at
every ``hot`` and tile size.

Usage:

    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_descent parity
    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_descent bench \
        [--features random|real] [--hot 0 64 128 256 366] [--tile-points 16 32 64]

``parity`` runs on the card, or on the CPU (plain versions) with
``--device cpu``;
``bench`` needs the card and times each version with CUDA events: median of
``--reps`` calls, each on a fresh input ``x + i * 1e-6``; B is timed before
and after the variants. B's time covers descent plus its fused histogram
sum; C' and the plain version return leaf ids only. The last line printed
is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..features.extractor import FeatureConfig, FeatureExtractor
from ..models.forest import (
    find_leaves_plain,
    forest_from_numpy,
    load_forest,
    permute_forest_features,
    usage_permutation,
)
from ..ops import forest_cuda
from ..ops.forest_staged_cuda import find_leaves_staged
from ..utils.calibration import Calibration
from . import card_description, median_ms

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resources", "bench_forest.dat",
)
NUM_FEATURES = 366
H, W, STRIDE = 480, 640, 2  # the real-feature frame


def make_depth(r: np.random.Generator) -> np.ndarray:
    """VGA depth in mm with 2% holes (``scripts/exp_descent_real.py``)."""
    ys, xs = np.mgrid[0:H, 0:W]
    depth = (3000.0 + 1500.0 * np.sin(xs / W * np.pi * r.uniform(0.5, 2.0))
             + 1000.0 * (ys / H) * r.uniform(0.5, 3.0))
    for _ in range(6):
        y0, x0 = r.integers(0, H - 80), r.integers(0, W - 120)
        bh, bw = r.integers(60, 180), r.integers(80, 240)
        depth[y0:y0 + bh, x0:x0 + bw] = r.uniform(700, 2500)
    depth += r.normal(0, 15, (H, W))
    depth[r.random((H, W)) < 0.02] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


def make_features(kind: str, mode: str, dev: torch.device) -> torch.Tensor:
    """[P, 366] float32: N(0, 4) noise, or one VGA frame's features."""
    rng = np.random.default_rng(0)
    if kind == "random":
        n = 76800 if mode == "bench" else 4096
        x = rng.normal(size=(n, NUM_FEATURES)).astype(np.float32) * 2.0
        return torch.from_numpy(x).to(dev)
    calib = Calibration(
        intrinsic=np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1.0]]),
        rotation=np.eye(3), translation=np.zeros(3))
    rgb = np.asarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    depth = make_depth(rng)
    extractor = FeatureExtractor(FeatureConfig(), dev)
    return extractor.extract(rgb, depth, calib, STRIDE).features


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m rovinasemanticsegmentation_tpu_torch.scripts."
             "exp_descent",
        description="Staged-tile forest descent (C') against kernel B.",
    )
    ap.add_argument("mode", choices=("parity", "bench"))
    ap.add_argument("--features", choices=("random", "real"),
                    default="random")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; bench needs cuda")
    ap.add_argument("--hot", type=int, nargs="+",
                    default=[0, 64, 128, 256, 366],
                    help="staged columns; 0 stages nothing (B's lookups "
                         "without its histogram sum)")
    ap.add_argument("--tile-points", type=int, nargs="+",
                    default=[16, 32, 64])
    ap.add_argument("--reps", type=int, default=20)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == "bench" and dev.type != "cuda":
        raise RuntimeError("bench times the card: run it with --device cuda")
    forest = forest_from_numpy(load_forest(FIXTURE, class_counts=[8, 9]), dev)
    x = make_features(args.features, args.mode, dev)
    perm, remap = usage_permutation(forest, NUM_FEATURES)
    forest_p = permute_forest_features(forest, remap)
    xp = x[:, torch.from_numpy(perm).to(dev)].contiguous()

    base, _ = forest_cuda.forest_predict(x, forest)
    plain = find_leaves_plain(xp, forest_p.records, forest_p.max_depth,
                              forest_p.feat_bits)
    parity = bool(torch.equal(plain, base))

    meta = forest_p.records[..., 0].cpu().numpy()
    fmask = (1 << forest_p.feat_bits) - 1
    split_feats = (meta & fmask)[(meta >> forest_p.feat_bits) != 0]

    def fresh(src):
        return lambda i: src + i * 1e-6

    def time_b():  # before and after the variants, for the drift between
        return median_ms(lambda f: forest_cuda.forest_predict(f, forest),
                         fresh(x), args.reps)

    bench = args.mode == "bench"
    b_ms = [time_b()] if bench else []
    staged = []
    for hot in args.hot:
        for tp in args.tile_points:
            got = find_leaves_staged(xp, forest_p, hot, tp)
            ok = bool(torch.equal(got, base))
            parity &= ok
            row = {"hot": hot, "tile_points": tp, "equal": ok,
                   "hot_split_share": float((split_feats < hot).mean())}
            if bench:
                row["ms"] = median_ms(
                    lambda f, hot=hot, tp=tp: find_leaves_staged(
                        f, forest_p, hot, tp),
                    fresh(xp), args.reps,
                )
            staged.append(row)

    result = {
        "script": "exp_descent", "mode": args.mode,
        "features": args.features, "device": str(dev),
        "card": card_description() if dev.type == "cuda" else None,
        "points": int(x.shape[0]), "trees": forest.num_trees,
        "parity": parity, "staged": staged,
    }
    if bench:
        result["forest_predict_ms"] = b_ms + [time_b()]
        result["plain_ms"] = median_ms(
            lambda f: find_leaves_plain(
                f, forest_p.records, forest_p.max_depth, forest_p.feat_bits),
            fresh(xp), args.reps,
        )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["parity"] else 1)
