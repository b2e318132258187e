"""Forest descent over the staged hot prefix of each row (C'') against kernel B.

Port of ``scripts/exp_descent.py`` (the chunk-skip variant C of the TPU
descent kernel) with the real-feature input of
``scripts/exp_descent_real.py``. Features are reordered by how often the
forest splits on them, the forest is rewritten to match, and C''
(``ops/forest_staged_cuda.py``) stages each row's first ``hot`` features
in shared memory (on packed rows also the float tail) and reads the rest in
place. Its leaf ids must equal kernel B's (``ops/forest_cuda.py``, on the
unpermuted rows) and the plain descent's, at every ``hot`` and tile size.

``--rows packed`` (the default) runs on the frame path's packed 8-bit rows
(``ops/feature_rows.py``, 384 B): ``real`` features are one VGA frame's
``extract_feature_rows``, ``random`` ones uniform bytes in the patch columns
and N(0, 4) in the float tail; the byte features are usage-permuted among
themselves (``usage_permutation_rows``, ``permute_rows``). ``--rows float``
runs on float32 ``[P, 366]`` rows (``extract_features``, or N(0, 4) noise)
with all columns usage-permuted (``usage_permutation``).

Usage:

    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_descent parity
    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_descent bench \
        [--rows packed|float] [--features random|real] \
        [--hot 0 64 128 256 363] [--tile-points 16 32 64]

``parity`` runs on the card, or on the CPU (plain versions) with
``--device cpu``;
``bench`` needs the card and times each version with CUDA events: median of
``--reps`` calls, each on a fresh input (the float features plus
``i * 1e-6``); B is timed before and after the variants. B's time covers
descent plus its fused histogram sum; C'' and the plain version return leaf
ids only. The last line printed is one JSON object.
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
from ..features.extractor import (
    FeatureConfig,
    FeatureExtractor,
    extract_feature_rows,
    feature_row_layout,
)
from ..models.forest import (
    find_leaves_plain,
    forest_from_numpy,
    load_forest,
    permute_forest_features,
    usage_permutation,
    usage_permutation_rows,
)
from ..ops import forest_cuda
from ..ops.feature_rows import (
    RowLayout,
    permute_rows,
    tail_view,
    unpack_rows,
)
from ..ops.forest_staged_cuda import find_leaves_staged_rows, staged_features
from ..utils.calibration import Calibration
from . import card_description, median_ms
from .make_bench_forest import make_depth  # VGA depth in mm with 2% holes

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resources", "bench_forest.dat",
)
NUM_FEATURES = 366
H, W, STRIDE = 480, 640, 2  # the real-feature frame


def make_rows(kind: str, rows_kind: str, mode: str, dev: torch.device):
    """(rows [P, row_bytes] uint8, their layout): noise or one VGA frame's
    features, as packed rows or as float32 rows of 366 features."""
    rng = np.random.default_rng(0)
    config = FeatureConfig()
    layout = (feature_row_layout(config) if rows_kind == "packed"
              else RowLayout.float32(NUM_FEATURES))
    if kind == "random":
        n = 76800 if mode == "bench" else 4096
        if rows_kind == "float":
            x = rng.normal(size=(n, NUM_FEATURES)).astype(np.float32) * 2.0
            return torch.from_numpy(x).to(dev).view(torch.uint8), layout
        pc = layout.patch_bytes
        k = layout.num_features - pc
        rows = torch.zeros((n, layout.row_bytes), dtype=torch.uint8)
        rows[:, :pc] = torch.from_numpy(
            rng.integers(0, 256, (n, pc), dtype=np.uint8))
        tail_view(rows, layout)[:, :k] = torch.from_numpy(
            rng.normal(size=(n, k)).astype(np.float32) * 2.0)
        return rows.to(dev), layout
    calib = Calibration(
        intrinsic=np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1.0]]),
        rotation=np.eye(3), translation=np.zeros(3))
    rgb = np.asarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    depth = make_depth(rng)
    if rows_kind == "float":
        x = FeatureExtractor(config, dev).extract(rgb, depth, calib,
                                                  STRIDE).features
        return x.view(torch.uint8), layout
    rows = torch.empty(((H // STRIDE) * (W // STRIDE), layout.row_bytes),
                       dtype=torch.uint8, device=dev)
    extract_feature_rows(
        *(torch.from_numpy(np.asarray(a)).to(dev) for a in (
            rgb, depth.astype(np.int32), calib.intrinsic_inverse,
            calib.rotation, calib.translation)),
        config, STRIDE, rows, 0,
    )
    return rows, layout


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m rovinasemanticsegmentation_tpu_torch.scripts."
             "exp_descent",
        description="Staged-tile forest descent (C') against kernel B.",
    )
    ap.add_argument("mode", choices=("parity", "bench"))
    ap.add_argument("--rows", choices=("packed", "float"), default="packed")
    ap.add_argument("--features", choices=("random", "real"),
                    default="random")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; bench needs cuda")
    ap.add_argument("--hot", type=int, nargs="+", default=None,
                    help="staged features (default 0 64 128 256 and the "
                         "whole row: 363 packed, 366 float); 0 stages only "
                         "the float tail of packed rows, nothing of float "
                         "rows")
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
    rows, layout = make_rows(args.features, args.rows, args.mode, dev)
    if args.rows == "packed":
        perm, remap = usage_permutation_rows(forest, layout)
        rows_p = permute_rows(rows, layout, perm)
        whole = layout.patch_bytes
    else:
        perm, remap = usage_permutation(forest, NUM_FEATURES)
        x = rows.view(torch.float32)
        rows_p = x[:, torch.from_numpy(perm).to(dev)].contiguous().view(
            torch.uint8)
        whole = NUM_FEATURES
    forest_p = permute_forest_features(forest, remap)
    hots = args.hot if args.hot is not None else [0, 64, 128, 256, whole]

    def plain(r):
        return find_leaves_plain(unpack_rows(r, layout), forest_p.records,
                                 forest_p.max_depth, forest_p.feat_bits)

    base, _ = forest_cuda.forest_predict_rows(rows, layout, forest)
    parity = bool(torch.equal(plain(rows_p), base))

    meta = forest_p.records[..., 0].cpu().numpy()
    fmask = (1 << forest_p.feat_bits) - 1
    split_feats = (meta & fmask)[(meta >> forest_p.feat_bits) != 0]
    num_tail = layout.num_features - layout.patch_bytes

    def fresh(src):
        def make(i):
            r = src.clone()
            tail_view(r, layout)[:, :num_tail] += i * 1e-6
            return r
        return make

    def time_b():  # before and after the variants, for the drift between
        return median_ms(
            lambda r: forest_cuda.forest_predict_rows(r, layout, forest),
            fresh(rows), args.reps)

    bench = args.mode == "bench"
    b_ms = [time_b()] if bench else []
    staged = []
    for hot in hots:
        share = float(staged_features(layout, hot)[split_feats].mean())
        for tp in args.tile_points:
            got = find_leaves_staged_rows(rows_p, layout, forest_p, hot, tp)
            ok = bool(torch.equal(got, base))
            parity &= ok
            row = {"hot": hot, "tile_points": tp, "equal": ok,
                   "hot_split_share": share}
            if bench:
                row["ms"] = median_ms(
                    lambda r, hot=hot, tp=tp: find_leaves_staged_rows(
                        r, layout, forest_p, hot, tp),
                    fresh(rows_p), args.reps,
                )
            staged.append(row)

    result = {
        "script": "exp_descent", "mode": args.mode, "rows": args.rows,
        "features": args.features, "device": str(dev),
        "card": card_description() if dev.type == "cuda" else None,
        "points": int(rows.shape[0]), "trees": forest.num_trees,
        "parity": parity, "staged": staged,
    }
    if bench:
        result["forest_predict_ms"] = b_ms + [time_b()]
        result["plain_ms"] = median_ms(plain, fresh(rows_p), args.reps)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["parity"] else 1)
