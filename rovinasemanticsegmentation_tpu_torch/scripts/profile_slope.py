"""Stage split of the frame path (features, descent, labels) on the card.

Usage (from the repository root; on the card unless ``--device cpu``):

    python -m rovinasemanticsegmentation_tpu_torch.scripts.profile_slope \
        [--batch 1] [--frame 480x640] [--reps 3] [--device cuda|cpu]

The port's counterpart of ``scripts/profile_slope.py``: the stages of
``SingleFramePipeline.run_batch_stacked`` over the bench's first ``--batch``
keyframes (``bench.py::make_workload``, seed 0; the JAX script's ``BATCH``,
1 by default; at 10 the stages take the bench's batch), at full width:
patch 77 -> 11, stride 2, 366 features, the fixture forest
``resources/bench_forest.dat`` (4 trees, 8 + 9 classes). Every stage runs
per frame as the path does, and the descent once over the batch's rows:

  lab+pad               ``patch_inputs``: 8-bit Lab, the reflect-padded
                        image, and the patch kernel's grid depth
  patches               kernel A and its ``pack_lab`` into the batch's
                        packed rows (``ops/patches_cuda.py``)
  backproject+normals   ``_tail_features``: the backprojection, the normal
                        angles (``ops/normals.py``), depth and height
  descent               kernel B over the packed rows, the leaf-histogram
                        sum fused (``ops/forest_cuda.py``)
  leaf-hist sum         a row of nulls: fused into the descent
  resize+argmax         ``SingleFramePipeline.results``: the bilinear
                        resize and the floored argmax of both layers
                        (one launch a frame on the card,
                        ``ops/resize_argmax_cuda.py``)

Numbers are per keyframe (a call's over ``--batch``). Call i's input: the
RGB XORed with i and depth + i where it is nonzero (``bench.py::perturb``;
lab+pad and normals), the grid depth times ``1 + i * 1e-5`` (patches), the
rows' depth feature + ``i * 1e-5`` where it is nonzero (descent), the
posteriors + ``i * 1e-6`` (resize). The summary gives the stages' sum and
the launches of A, ``pack_lab`` and B. Check: the stages composed (with the
path's grid depth and tail write between them) give ``run_batch_stacked``'s
posteriors and labels exactly. Timing method: ``stage_timing``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..bench import CLASS_COUNTS, FIXTURE, FOCAL, STRIDE, perturb
from ..features.extractor import (
    FeatureConfig,
    _grid_depth,
    _tail_features,
    _write_tail,
    feature_row_layout,
    patch_inputs,
)
from ..models.forest import load_forest
from ..ops.feature_rows import tail_view
from ..ops.forest_cuda import forest_predict_rows
from ..ops.patches_cuda import extract_patches_into
from ..pipelines.single_frame import SingleFramePipeline
from .stage_timing import (
    Stage,
    arguments,
    bench_workload,
    finish,
    frame_size,
    measure,
    same,
    start,
)

K1, K2 = 8, 32


class FrameInputs:
    """A batch of the bench's keyframes on ``dev``, and the path's stages
    over it."""

    def __init__(self, batch: int, frame, dev):
        h, w = frame
        frames, _, _ = bench_workload(frame=frame)
        if not 1 <= batch <= len(frames):
            raise ValueError(f"--batch must be 1..{len(frames)}")
        frames = frames[:batch]
        self.dev, self.batch, self.shape, self.stride = dev, batch, frame, STRIDE
        self.rgb = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
        self.depth = torch.from_numpy(
            np.stack([f[1] for f in frames]).astype(np.int32)).to(dev)
        kinv = np.linalg.inv(np.array([[FOCAL, 0, w / 2], [0, FOCAL, h / 2],
                                       [0, 0, 1]]))
        self.calib = [
            torch.from_numpy(np.tile(np.asarray(a, np.float32)[None],
                                     (batch,) + (1,) * np.ndim(a))).to(dev)
            for a in (kinv, np.eye(3), np.zeros(3))]
        self.cfg = FeatureConfig()
        self.layout = feature_row_layout(self.cfg)
        self.pipeline = SingleFramePipeline(
            self.cfg, load_forest(FIXTURE, class_counts=list(CLASS_COUNTS)),
            STRIDE, dev, fill_value=0.0)
        gh, gw = self.pipeline.grid_shape(h, w)
        self.points = gh * gw

    def new_rows(self) -> torch.Tensor:
        return torch.empty((self.batch * self.points, self.layout.row_bytes),
                           dtype=torch.uint8, device=self.dev)

    # The stages, each over the batch.
    def lab_pad(self, rgb, depth):
        return [patch_inputs(rgb[b], depth[b], self.cfg, self.stride)
                for b in range(self.batch)]

    def patches(self, padded, depth_grids, rows):
        for b in range(self.batch):
            extract_patches_into(padded[b], depth_grids[b], self.cfg.patch_size,
                                 self.cfg.patch_size_reduce, self.stride, rows,
                                 b * self.points)

    def normals(self, depth_f, depth_m):
        kinv, rot, trans = self.calib
        return [_tail_features(depth_f[b], depth_m[b], kinv[b], rot[b],
                               trans[b], self.cfg, self.stride)
                for b in range(self.batch)]

    def descent(self, rows):
        return forest_predict_rows(rows, self.layout, self.pipeline.forest)

    def resize(self, post, masks):
        return self.pipeline.results(post, masks, self.shape)

    # The path's glue between them.
    def grid_depth(self, depth):
        """-> (float depth, grid depth in metres, masks) per frame."""
        depth_f = [depth[b].to(torch.float32) for b in range(self.batch)]
        grid = [_grid_depth(d, self.cfg, self.stride) for d in depth_f]
        return depth_f, [g[1] for g in grid], [g[0].reshape(-1) for g in grid]

    def write_tails(self, rows, parts, masks):
        p = self.points
        for b in range(self.batch):
            _write_tail(rows[b * p : (b + 1) * p], self.layout, parts[b],
                        masks[b])

    def chain(self):
        """The stages composed: ``run_batch_stacked``'s results, and the
        stages' inputs at call 0."""
        inputs = self.lab_pad(self.rgb, self.depth)
        padded, grids = [x[0] for x in inputs], [x[1] for x in inputs]
        rows = self.new_rows()
        self.patches(padded, grids, rows)
        depth_f, depth_m, masks = self.grid_depth(self.depth)
        self.write_tails(rows, self.normals(depth_f, depth_m), masks)
        _, post = self.descent(rows)
        return self.resize(post, masks), (padded, grids, rows, post, masks)

    def production(self):
        return self.pipeline.run_batch_stacked(self.rgb, self.depth,
                                               *self.calib)

    def stages(self) -> List[Stage]:
        _, (padded, grids, rows0, post, masks) = self.chain()
        out_rows = self.new_rows()

        def frames(i):
            return perturb(self.rgb, self.depth, i)

        def tails(i):
            depth_f, depth_m, _ = self.grid_depth(frames(i)[1])
            return depth_f, depth_m

        def rows(i):
            r = rows0.clone()
            t = tail_view(r, self.layout)[:, 0]
            t.copy_(torch.where(t > 0, t + i * 1e-5, t))
            return (r,)

        return [
            Stage("lab+pad", frames, self.lab_pad, (K1, K2)),
            Stage("patches (A + pack_lab)",
                  lambda i: (padded, [g * (1.0 + i * 1e-5) for g in grids],
                             out_rows), self.patches, (K1, K2)),
            Stage("backproject+normals", tails, self.normals, (K1, K2)),
            Stage("descent (B)", rows, self.descent, (K1, K2)),
            Stage("leaf-hist sum", fused_into="descent (B)"),
            Stage("resize+argmax", lambda i: (post + i * 1e-6, masks),
                  self.resize, (K1, K2)),
        ]


def same_results(a, b) -> bool:
    return len(a) == len(b) and all(
        same(x.posteriors, y.posteriors) and same(x.labels, y.labels)
        for x, y in zip(a, b))


def main(argv: Optional[List[str]] = None) -> int:
    ap = arguments(__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1,
                    help="keyframes per call (the bench's is 10)")
    ap.add_argument("--frame", type=frame_size, default=(480, 640),
                    help="HxW of the keyframes")
    args = ap.parse_args(argv)
    dev = start(args)
    frames = FrameInputs(args.batch, args.frame, dev)
    checks = {"stages composed == run_batch_stacked": same_results(
        frames.chain()[0], frames.production())}
    lines, sums = [], {}
    if all(checks.values()):
        lines = measure("profile_slope", frames.stages(), args.reps, dev,
                        per=args.batch, unit="keyframe")
        sums = {"stages": sum(line["wall_ms"] for line in lines
                              if line["wall_ms"] is not None)}
    return finish("profile_slope", lines, checks, dev, batch=args.batch,
                  frame=list(args.frame), wall_ms_sums=sums)


if __name__ == "__main__":
    raise SystemExit(main())
