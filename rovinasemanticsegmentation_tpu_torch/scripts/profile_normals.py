"""Stage split of the frame path's surface normals on the card.

Usage (from the repository root; on the card unless ``--device cpu``):

    python -m rovinasemanticsegmentation_tpu_torch.scripts.profile_normals \
        [--frame 480x640] [--reps 3] [--device cuda|cpu]

The port's counterpart of ``scripts/profile_normals.py``, on one depth frame
of the bench (``bench.py::make_depth``, seed 0; Xtion intrinsics 525 and the
frame's centre) at stride 2. Stages (``ops/normals.py``):

  backproject          ``ops/geometry.py::backproject`` of the depth
  change map           ``_depth_change_map`` (``_shift_nan``, ``roll``)
  iterated chamfer     ``chamfer_distance_map(change, saturation=10)``: the
                       frame path's 10 rounds of 3x3 min-plus relaxation
  exact chamfer        ``chamfer_distance_map(change)``: the exact
                       full-height passes of non-integral smoothing sizes
  grads + integral     ``_gradient_integral``: the central differences and
                       the float64 integral image (float64 as in the path)
  normals (plain)      the stages above composed with ``_box_normals``: the
                       plain version, which the card ran before the kernels
  normals (kernels)    ``ops/normals_cuda.py::normal_angles_grid``: the three
                       launches of ``csrc/normals.cu`` (on the card only)
  normals (whole)      ``normal_angles_grid(points, 2)``: the production
                       call, the kernels on the card, the plain version on
                       the CPU

Call i's input: depth + i where it is nonzero (backproject); points + ``i *
1e-6`` m (change map, grads + integral, the three normals rows); one pixel of
the change map
flipped at a position made from i (both chamfers). The summary gives the sum
of change map, iterated chamfer and grads + integral beside the whole, which
also holds the box sums and the angle (the sum is not checked against it).
Checks: the stages composed with ``_box_normals`` equal ``normal_angles_grid``
(masks equal, angles within 2.4e-7 rad); on the card the kernels equal the
plain version bit for bit. The JAX script's banded chamfer and
its tuning record are not ported. Timing method: ``stage_timing``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..bench import FOCAL, make_depth
from ..ops.geometry import backproject
from ..ops.normals import (
    _box_normals,
    _depth_change_map,
    _gradient_integral,
    chamfer_distance_map,
    normal_angles_grid,
)
from ..ops import normals_cuda
from .stage_timing import (
    Stage,
    arguments,
    finish,
    frame_size,
    measure,
    start,
    wall,
)

STRIDE = 2
SMOOTHING = 10.0  # normalSmoothingSize (feature_extractor.h:254-262)
FACTOR = 0.02  # maxDepthChangeFactor
K1, K2 = 8, 32
# The exact passes issue ~18000 launches per call: fewer calls.
EXACT_CALLS = (1, 3)
ANGLE_TOL = 2.4e-7  # rad: 2 float32 ulps near pi/2


def frame(h: int, w: int, dev: torch.device):
    """-> (depth [H, W] int32 mm, K^-1 [3, 3]): the bench's first depth
    frame's draws at this size."""
    depth = make_depth(np.random.default_rng(0), h, w).astype(np.int32)
    kinv = np.linalg.inv(np.array([[FOCAL, 0, w / 2], [0, FOCAL, h / 2],
                                   [0, 0, 1]]))
    return torch.from_numpy(depth).to(dev), kinv


def to_points(depth: torch.Tensor, kinv) -> torch.Tensor:
    return backproject(depth, kinv, np.eye(3), np.zeros(3), 0.5, 15.0)


def chain(points: torch.Tensor) -> torch.Tensor:
    """The stages composed with the box sums: ``normal_angles_grid``."""
    z = points[..., 2]
    distance = chamfer_distance_map(_depth_change_map(z, FACTOR),
                                    saturation=SMOOTHING)
    return _box_normals(_gradient_integral(points), distance, torch.isnan(z),
                        STRIDE, SMOOTHING)


def flip_one(change: torch.Tensor, i: int) -> torch.Tensor:
    """``change`` with the pixel ``(7919 i) mod (H W)`` flipped."""
    out = change.clone()
    flat = out.view(-1)
    k = (7919 * i) % flat.numel()
    flat[k] = ~flat[k]
    return out


def stages(depth: torch.Tensor, kinv) -> List[Stage]:
    points = to_points(depth, kinv)
    change = _depth_change_map(points[..., 2], FACTOR)

    def pts(i):
        return (points + i * 1e-6,)

    return [
        Stage("backproject",
              lambda i: (torch.where(depth > 0, depth + i, depth),),
              lambda d: to_points(d, kinv), (K1, K2)),
        Stage("change map", lambda i: (points[..., 2] + i * 1e-6,),
              lambda z: _depth_change_map(z, FACTOR), (K1, K2)),
        Stage("iterated chamfer", lambda i: (flip_one(change, i),),
              lambda c: chamfer_distance_map(c, saturation=SMOOTHING),
              (K1, K2)),
        Stage("exact chamfer (full-height passes)",
              lambda i: (flip_one(change, i),), chamfer_distance_map,
              EXACT_CALLS),
        Stage("grads + integral (float64)", pts, _gradient_integral, (K1, K2)),
        Stage("normals (plain)", pts, chain, (K1, K2)),
    ] + ([
        Stage("normals (kernels)", pts,
              lambda p: normals_cuda.normal_angles_grid(p, STRIDE), (K1, K2)),
    ] if depth.is_cuda else []) + [
        Stage("normals (whole)", pts,
              lambda p: normal_angles_grid(p, STRIDE), (K1, K2)),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = arguments(__doc__.split("\n")[0])
    ap.add_argument("--frame", type=frame_size, default=(480, 640),
                    help="HxW of the depth frame")
    args = ap.parse_args(argv)
    dev = start(args)
    depth, kinv = frame(*args.frame, dev)
    points = to_points(depth, kinv)
    got, want = chain(points), normal_angles_grid(points, STRIDE)
    mask = want != -2.0
    checks = {
        "stages composed == normal_angles_grid (masks equal, 2.4e-7 rad)":
            bool(torch.equal(got != -2.0, mask))
            and float((got - want).abs().max()) <= ANGLE_TOL,
        "valid grid points": bool(mask.any()),
    }
    if points.is_cuda:
        checks["kernels == plain, bit for bit"] = bool(torch.equal(
            normals_cuda.normal_angles_grid(points, STRIDE), got))
    lines, sums = [], {}
    if all(checks.values()):
        lines = measure("profile_normals", stages(depth, kinv), args.reps, dev)
        sums = {"change map + iterated chamfer + grads + integral": sum(
            wall(lines, s) for s in ("change map", "iterated chamfer",
                                     "grads + integral (float64)")),
            "normals (plain)": wall(lines, "normals (plain)"),
            "normals (whole)": wall(lines, "normals (whole)")}
    return finish("profile_normals", lines, checks, dev,
                  frame=list(args.frame), stride=STRIDE, wall_ms_sums=sums,
                  normals_launches=normals_cuda.launches.value)


if __name__ == "__main__":
    raise SystemExit(main())
