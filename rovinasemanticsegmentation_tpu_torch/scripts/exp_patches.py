"""Separable patch resampling on a staged image footprint (D'') against kernel A.

Port of ``scripts/exp_patches.py`` (variant E of the TPU patch kernel: a
band of the packed image in fast memory, the channels unpacked once, a
vertical row stage, then a horizontal column stage). D''
(``ops/patches_separable_cuda.py``) must be bit-equal to kernel A
(``ops/patches_cuda.py``), to the gather plain version
``extract_patches_plain`` and to the separable plain version
``extract_patches_separable_plain``, both on the ``[gh, gw, R, R, 3]`` patch
tensor and on the frame path's packed feature rows (``ops/feature_rows.py``,
384 B at R = 11), written from a nonzero row of a larger buffer whose other
rows must stay as they were.

Usage:

    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_patches parity
    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_patches bench

``parity`` runs at 64x96, patch 21 -> 7, stride 2, on the card, or on the
CPU (plain versions) with ``--device cpu``; ``bench`` runs at VGA, patch 77 -> 11,
stride 2, needs the card, and times each version with CUDA events: median
of ``--reps`` calls, each on a fresh depth grid ``d * (1 + i * 1e-5)``; A is
timed before and after the others; D'' into rows is reported with the
number of its blocks whose footprint exceeded the wrapper's
``FOOTPRINT_CAP``. The last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.color import rgb_to_lab8
from ..ops.geometry import millimetres_to_metres
from ..ops import patches_separable_cuda
from ..ops.feature_rows import RowLayout
from ..ops.patches import (
    extract_patches_plain,
    extract_patches_separable_into_plain,
    extract_patches_separable_plain,
    reflect_pad_image,
)
from ..ops.patches_cuda import (
    extract_patches,
    extract_patches_into,
    extract_patches_into_plain,
)
from ..ops.patches_separable_cuda import (
    extract_patches_separable,
    extract_patches_separable_into,
)
from . import card_description, median_ms


def make_depth(r: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Depth in mm with boxes, noise and 2% holes (``scripts/exp_patches.py``)."""
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (3000.0 + 1500.0 * np.sin(xs / w * np.pi * r.uniform(0.5, 2.0))
             + 1000.0 * (ys / h) * r.uniform(0.5, 3.0))
    for _ in range(6):
        bh, bw = r.integers(h // 8, h // 2), r.integers(w // 8, w // 2)
        y0, x0 = r.integers(0, h - bh), r.integers(0, w - bw)
        depth[y0:y0 + bh, x0:x0 + bw] = r.uniform(700, 2500)
    depth += r.normal(0, 15, (h, w))
    depth[r.random((h, w)) < 0.02] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


ROW0 = 3  # first row of the frame's block in the row buffer


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m rovinasemanticsegmentation_tpu_torch.scripts."
             "exp_patches",
        description="Separable patch kernel (D'') against kernel A.",
    )
    ap.add_argument("mode", choices=("parity", "bench"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; bench needs cuda")
    ap.add_argument("--reps", type=int, default=20)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    bench = args.mode == "bench"
    if bench and dev.type != "cuda":
        raise RuntimeError("bench times the card: run it with --device cuda")
    h, w, b, r, s = (480, 640, 77, 11, 2) if bench else (64, 96, 21, 7, 2)
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(
        rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
    depth = torch.from_numpy(make_depth(rng, h, w).astype(np.int32)).to(dev)
    lab = reflect_pad_image(rgb_to_lab8(rgb), b)
    dgrid = millimetres_to_metres(depth[::s, ::s].to(torch.float32))

    versions = {
        "A": extract_patches,
        "separable": extract_patches_separable,
        "plain": extract_patches_plain,
        "separable_plain": extract_patches_separable_plain,
    }
    outs = {k: fn(lab, dgrid, b, r, s) for k, fn in versions.items()}
    equal = {k: bool(torch.equal(v, outs["plain"])) for k, v in outs.items()}

    # The same patches as packed feature rows, from row ROW0 of a buffer
    # whose other bytes hold a fill value that must survive.
    gh, gw = dgrid.shape
    layout = RowLayout.packed(3 * r * r, 3)
    row_versions = {
        "A": extract_patches_into,
        "separable": extract_patches_separable_into,
        "plain": extract_patches_into_plain,
        "separable_plain": extract_patches_separable_into_plain,
    }

    def into(fn, depth_grid, buf, row0=ROW0):
        fn(lab, depth_grid, b, r, s, buf, row0)
        return buf

    def fill():
        return torch.full((ROW0 + gh * gw + 5, layout.row_bytes), 0xAB,
                          dtype=torch.uint8, device=dev)

    rows = {k: into(fn, dgrid, fill()) for k, fn in row_versions.items()}
    equal_rows = {k: bool(torch.equal(v, rows["plain"]))
                  for k, v in rows.items()}
    block = rows["plain"][ROW0 : ROW0 + gh * gw, : 3 * r * r]
    equal_rows["plain"] &= bool(torch.equal(
        block, outs["plain"].reshape(gh * gw, -1)))
    result = {
        "script": "exp_patches", "mode": args.mode, "device": str(dev),
        "card": card_description() if dev.type == "cuda" else None,
        "frame": [h, w], "patch": b, "reduce": r, "stride": s,
        "shape": list(outs["plain"].shape),
        "row_bytes": layout.row_bytes, "row0": ROW0,
        "parity": all(equal.values()) and all(equal_rows.values()),
        "equal_to_plain": equal, "rows_equal_to_plain": equal_rows,
    }
    if bench:
        def time(fn):
            return median_ms(lambda d: fn(lab, d, b, r, s),
                             lambda i: dgrid * (1.0 + i * 1e-5), args.reps)

        def time_rows(fn):
            buf = fill()
            return median_ms(lambda d: into(fn, d, buf),
                             lambda i: dgrid * (1.0 + i * 1e-5), args.reps)

        ms = {"A": [time(versions["A"])]}
        for k in ("separable", "plain", "separable_plain"):
            ms[k] = time(versions[k])
        ms["A"].append(time(versions["A"]))
        result["ms"] = ms
        ms_rows = {"A": [time_rows(row_versions["A"])]}
        for k in ("separable", "plain", "separable_plain"):
            ms_rows[k] = time_rows(row_versions[k])
        launch, over_cap = patches_separable_cuda.launcher(
            lab, dgrid, b, r, s, fill(), ROW0)
        launch()
        ms_rows["A"].append(time_rows(row_versions["A"]))
        result["ms_rows"] = ms_rows
        result["separable_blocks"] = (-(-gh // patches_separable_cuda.TILE_ROWS)
                                   * -(-gw // patches_separable_cuda.TILE_COLS))
        result["separable_blocks_over_cap"] = int(over_cap.item())
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["parity"] else 1)
