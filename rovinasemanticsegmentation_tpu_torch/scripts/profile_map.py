"""Stage split of the local-map path (dense CRF on) on the card.

Usage (from the repository root; on the card unless ``--device cpu``):

    python -m rovinasemanticsegmentation_tpu_torch.scripts.profile_map \
        [--points 30000] [--frame 480x640] [--iterations 10] [--reps 3] \
        [--device cuda|cpu]

The port's counterpart of ``scripts/profile_map.py``, on the bench's map:
its ``--points`` points and colours (``bench.py::make_workload``), 5
keyframe nodes at the bench's identity poses, each with one camera's
posteriors of ``--frame`` size for the 8 + 9 classes (uniform in [0, 1],
seed 0), and the bench's CRF (xyz 0.5, rgb 4, weight 10, ``--iterations``
mean-field iterations). Stages (``pipelines/local_map.py``,
``models/lattice.py``):

  fuse_unaries          ``LocalMapPipeline.fuse_unaries``, concatenated
  build_lattice_device  the device lattice build over the CRF features
  crf_labels_multi      the fused 2-layer mean field and the labels
  map_fused (whole)     ``LocalMapPipeline.map_fused``: all three

Call i's input: points + ``i * 1e-5`` (fusion and whole), features + ``i *
1e-5`` (build), unaries + ``i * 1e-6`` (mean field). No stage synchronises:
``map_fused`` leaves its vertex count on the device, and the script reads it
once, outside the timed calls. The summary gives the three stages' sum beside
the whole (glue sits between them; the sum is not checked against it), the
vertex count m and the bucket (``stage_timing.MAP_BUCKET``, the port's).
Checks: the stages composed give ``map_fused``'s labels exactly, and m fits
the bucket. Timing method: ``stage_timing``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..bench import CLASS_COUNTS, CRF, FOCAL, UNKNOWN_LABELS
from ..fusion.projector import MultiProjector
from ..models.lattice import build_lattice_device
from ..pipelines.local_map import (
    LocalMapPipeline,
    MapNodeFrames,
    crf_feats,
    crf_labels_multi,
)
from ..pipelines.streaming import pack_poses
from ..utils.calibration import Calibration
from .stage_timing import (
    MAP_BUCKET,
    Stage,
    arguments,
    bench_workload,
    finish,
    frame_size,
    measure,
    same,
    start,
)

KEYFRAMES = 5  # nodes per map (the bench's map_every)
K1, K2 = 4, 16


class MapInputs:
    """The map's host arrays and its pipeline on ``dev``."""

    def __init__(self, points: int, frame, iterations: int, dev):
        h, w = frame
        _, self.points, self.rgb = bench_workload(points, frame)
        calib = Calibration(
            intrinsic=np.array([[FOCAL, 0, w / 2], [0, FOCAL, h / 2],
                                [0, 0, 1]]),
            rotation=np.eye(3), translation=np.zeros(3))
        self.projector = MultiProjector.from_calibrations(
            [calib], h, w, min_distance=0.5, max_distance=15.0)
        self.crf = dataclasses.replace(CRF, iterations=iterations)
        self.blocks, self.unknown = CLASS_COUNTS, UNKNOWN_LABELS
        self.poses = pack_poses(self.projector, [np.eye(4)] * KEYFRAMES)
        rng = np.random.default_rng(0)
        self.posteriors = [
            [rng.uniform(0, 1, (h, w, c)).astype(np.float32)
             for c in CLASS_COUNTS] for _ in range(KEYFRAMES)]
        self.dev = dev
        self.pipeline = LocalMapPipeline(self.projector, CLASS_COUNTS,
                                         UNKNOWN_LABELS, dev, crf=self.crf)
        self.nodes = [
            MapNodeFrames(pose=pose, posteriors=[
                [torch.from_numpy(p).to(dev) for p in layers]])
            for pose, layers in zip(self.poses, self.posteriors)]

    def tensors(self):
        return (torch.from_numpy(self.points).to(self.dev),
                torch.from_numpy(self.rgb).to(self.dev))

    def fuse(self, points):
        return torch.cat(self.pipeline.fuse_unaries(points, self.nodes), dim=1)

    def features(self, points, rgb):
        return crf_feats(points, rgb, self.crf.xyz_kernel, self.crf.rgb_kernel)

    def labels(self, unaries, built):
        return crf_labels_multi(
            unaries, built[:8], self.crf.kernel_weight, self.blocks,
            MAP_BUCKET, self.crf.iterations, self.unknown,
            built[8] > MAP_BUCKET)

    def chain(self, points, rgb):
        """The stages composed: ``map_fused``'s labels."""
        built = build_lattice_device(self.features(points, rgb), MAP_BUCKET)
        return self.labels(self.fuse(points), built)

    def whole(self, points, rgb):
        return self.pipeline.map_fused(points, rgb, self.nodes, MAP_BUCKET)

    def stages(self) -> List[Stage]:
        points, rgb = self.tensors()
        feats = self.features(points, rgb)
        fused = self.fuse(points)
        built = build_lattice_device(feats, MAP_BUCKET)

        def pts(i):
            return (points + i * 1e-5,)

        return [
            Stage("fuse_unaries", pts, self.fuse, (K1, K2)),
            Stage("build_lattice_device", lambda i: (feats + i * 1e-5,),
                  lambda f: build_lattice_device(f, MAP_BUCKET), (K1, K2)),
            Stage(f"crf_labels_multi ({self.crf.iterations} it)",
                  lambda i: (fused + i * 1e-6,),
                  lambda u: self.labels(u, built), (K1, K2)),
            Stage("map_fused (whole)", pts,
                  lambda p: self.whole(p, rgb), (K1, K2)),
        ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = arguments(__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--frame", type=frame_size, default=(480, 640),
                    help="HxW of the keyframes' posteriors")
    ap.add_argument("--iterations", type=int, default=10)
    args = ap.parse_args(argv)
    dev = start(args)
    maps = MapInputs(args.points, args.frame, args.iterations, dev)
    points, rgb = maps.tensors()
    labels, m = maps.whole(points, rgb)
    m = int(m)
    checks = {
        "stages composed == map_fused labels": same(maps.chain(points, rgb),
                                                    labels),
        f"m <= bucket {MAP_BUCKET}": m <= MAP_BUCKET,
    }
    lines, sums = [], {}
    if all(checks.values()):
        lines = measure("profile_map", maps.stages(), args.reps, dev,
                        unit="map")
        sums = {"three stages": sum(line["wall_ms"] for line in lines[:3]),
                "map_fused (whole)": lines[3]["wall_ms"]}
    return finish("profile_map", lines, checks, dev, points=args.points,
                  frame=list(args.frame), iterations=args.iterations, m=m,
                  bucket=MAP_BUCKET, wall_ms_sums=sums)


if __name__ == "__main__":
    raise SystemExit(main())
