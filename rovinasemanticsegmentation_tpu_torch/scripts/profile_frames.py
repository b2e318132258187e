"""Device time of the frame path per keyframe, from one ``torch.profiler`` window.

Usage (on a machine with an NVIDIA GPU, from the repository root):

    python rovinasemanticsegmentation_tpu_torch/scripts/profile_frames.py \
        [--root DIR] [--reps 3]

Makes ``FRAMES`` (8) VGA keyframes from ``FRAME_SEED`` (random colour,
piecewise-smooth indoor depth with 2% holes), runs ``SingleFramePipeline.run_batch_stacked``
on them at full width (patch 77 -> 11, stride 2, 366 features, the fixture
forest ``resources/bench_forest.dat`` with 8 + 9 classes) once to warm up,
then ``--reps`` times under ``torch.profiler``, and prints the card's name
and power limit, then one JSON line: device time per keyframe (the sum of the
device activities' durations, and their union), wall time per keyframe
(unprofiled, median of ``--reps``), the top kernels by device time, the
device time of the port's own kernels (A, its Lab pack, B), and the float32
``cat``/``where``/``to`` ops whose operand has the features' width.

``--root`` imports the package from another checkout, such as an unpacked
``git archive`` of an earlier commit, so that two versions compare in one
call on one card. The script uses only the frame path's public API, which
both sides have.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

H, W, STRIDE = 480, 640, 2
# One serving batch of keyframes, and the seed they are made from (the first
# FRAMES keyframes of ``chip_smoke.py``'s run).
FRAMES, FRAME_SEED = 8, 0
# The widths of the patch columns (11 x 11 x 3) and of the whole feature row
# (with depth, height and normal angle), and the float32 passes over [P, D]
# matrices of those widths that the packed rows remove from the card.
FEATURE_WIDTHS = (363, 366)
FLOAT_PASSES = ("aten::cat", "aten::where", "aten::_to_copy", "aten::to",
                "aten::copy_")
# The port's hand-written kernels on the frame path, by their CUDA names.
PORT_KERNELS = ("pack_lab_kernel", "patches_kernel", "forest_descent_kernel")


def make_depth(rng, h, w):
    """Piecewise-smooth indoor-style depth in mm with 2% sensor holes."""
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (
        3000.0
        + 1500.0 * np.sin(xs / w * np.pi * rng.uniform(0.5, 2.0))
        + 1000.0 * (ys / h) * rng.uniform(0.5, 3.0)
    )
    for _ in range(6):  # furniture-like fronto-parallel boxes
        y0, x0 = rng.integers(0, h - h // 6), rng.integers(0, w - w // 5)
        bh, bw = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        depth[y0 : y0 + bh, x0 : x0 + bw] = rng.uniform(700, 2500)
    depth += rng.normal(0, 15, (h, w))
    depth[rng.random((h, w)) < 0.02] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


def make_frames(rng, n, h=H, w=W):
    """``n`` (rgb [h, w, 3] uint8, depth [h, w] uint16 mm) keyframes."""
    return [
        (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), make_depth(rng, h, w))
        for _ in range(n)
    ]


def frame_stacks(frames, intrinsic_inverse, device):
    """``run_batch_stacked``'s inputs: the frames on the card, identity
    rotation, zero translation."""
    b = len(frames)
    return (
        torch.from_numpy(np.stack([f[0] for f in frames])).to(device),
        torch.from_numpy(np.stack([f[1] for f in frames]).astype(np.int32))
        .to(device),
        np.tile(intrinsic_inverse[None], (b, 1, 1)).astype(np.float32),
        np.tile(np.eye(3)[None], (b, 1, 1)).astype(np.float32),
        np.zeros((b, 3), np.float32),
    )


def _has_feature_width(shapes) -> bool:
    """Whether a profiler event's input shapes (nested for tensor lists)
    hold a 2-D shape of a feature width."""
    for s in shapes or []:
        if s and all(isinstance(v, int) for v in s):
            if len(s) == 2 and s[-1] in FEATURE_WIDTHS:
                return True
        elif isinstance(s, (list, tuple)) and _has_feature_width(s):
            return True
    return False


def profile_batch(pipeline, stacks, reps: int, top: int = 8) -> dict:
    """Profile ``reps`` calls of ``pipeline.run_batch_stacked(*stacks)``
    after one warm-up call; -> per-keyframe device and wall times, the top
    kernels, and the float passes over ``[P, D]`` feature operands."""
    from torch.profiler import ProfilerActivity, profile

    b = stacks[0].shape[0]
    pipeline.run_batch_stacked(*stacks)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipeline.run_batch_stacked(*stacks)
        torch.cuda.synchronize()
        walls.append(1000 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            pipeline.run_batch_stacked(*stacks)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type.name != "CPU"]
    busy_us, edge = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, edge), e.time_range.end
        busy_us += max(0.0, hi - lo)  # union of activity intervals
        edge = max(edge, hi)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    frames = b * reps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    float_passes = sorted({
        f"{e.name}{e.input_shapes}" for e in events
        if e.device_type.name == "CPU" and e.name in FLOAT_PASSES
        and _has_feature_width(e.input_shapes)
    })
    return {
        "frames": b,
        "reps": reps,
        "device_ms_per_keyframe":
            sum(v[0] for v in by_name.values()) / 1000 / frames,
        "busy_ms_per_keyframe": busy_us / 1000 / frames,
        "device_activities_per_batch": len(device) / reps,
        "wall_ms_per_keyframe": statistics.median(walls) / b,
        "top_kernels": [
            {"name": name[:90], "us_per_keyframe": us / frames,
             "launches_per_batch": n / reps}
            for name, (us, n) in ranked
        ],
        "port_kernels": {
            k: {"us_per_keyframe": sum(
                    us for name, (us, _) in by_name.items() if k in name
                ) / frames,
                "launches_per_batch": sum(
                    n for name, (_, n) in by_name.items() if k in name
                ) / reps}
            for k in PORT_KERNELS
        },
        "float_feature_passes": float_passes,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose package is profiled (default: this one)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the frame profile measures the card: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rovinasemanticsegmentation_tpu_torch.features.extractor import (
        FeatureConfig,
    )
    from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
    from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
        SingleFramePipeline,
    )
    from rovinasemanticsegmentation_tpu_torch.scripts import card_description

    forest = load_forest(os.path.join(root, "resources", "bench_forest.dat"),
                         class_counts=[8, 9])
    kinv = np.linalg.inv(np.array([[525.0, 0, W / 2], [0, 525.0, H / 2],
                                   [0, 0, 1]]))
    stacks = frame_stacks(make_frames(np.random.default_rng(FRAME_SEED),
                                      FRAMES), kinv, "cuda")
    pipeline = SingleFramePipeline(FeatureConfig(), forest, STRIDE, "cuda",
                                   fill_value=0.0)
    out = dict(profile_batch(pipeline, stacks, args.reps), root=root)
    print(card_description())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
