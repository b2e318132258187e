"""Drive the PyTorch/CUDA port of the keyframe-to-labelled-map path on one GPU.

Usage (from the repository root, on a machine with an NVIDIA GPU):

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``rovinasemanticsegmentation_tpu_torch/csrc`` with nvcc;
2. kernel A (patches) and its ``pack_lab`` against their plain PyTorch
   versions on the card: bit-exact at VGA / stride 2 on piecewise-smooth
   depth with 2% holes, and on a 240x320 frame at strides 1 and 5, in both
   output strides: 363-byte rows (the ``[gh, gw, R, R, 3]`` tensor) and
   384-byte packed feature rows (``ops/feature_rows.py``) from a nonzero
   batch row, the rows around the frame's block untouched;
2b. kernel D' (separable patches on planar channels) on the same inputs:
   bit-exact with kernel A, ``extract_patches_plain`` and its own plain
   version ``extract_patches_separable_plain``;
3. kernel B (forest descent + leaf-histogram sum) against its plain version
   with the trained fixture forest, on phase 2's frame and on a batch of 8
   VGA keyframes (the serving path's shape), each as float32 rows and as
   packed rows: equal leaf ids and equal posteriors; the frame's packed rows
   unpack to its float features bit for bit;
3b. kernel C' (descent over a staged feature tile) on the frame's features
   after the usage permutation, at hot = 128 and 366: leaf ids equal to B's
   and to the plain descent's, and the posteriors summed from them equal to
   B's;
3c. one ``torch.profiler`` window over ``run_batch_stacked`` on 8 VGA
   keyframes, in a process of its own (``scripts/profile_frames.py``):
   device time per keyframe, the top kernels and the port's kernels; kernels
   A and B must run, and no float32 ``cat``, ``where`` or ``to`` over
   ``[P, 363]`` or ``[P, 366]`` features may run;

Phases 2-3b time each kernel's launch alone (CUDA events around launches
whose inputs were prepared first, queued behind a spin kernel so that the
card's time is measured and not the host's) beside its wrapper, and compute
its bound from this run's inputs: the larger of the bytes it must move
(each input read once, each output written once; for a descent, the
features, node records and leaf histograms that this data's paths read)
over 3.35 TB/s and its 32-bit instructions on the busiest issue pipe (FMA
or ALU) over that pipe's rate.
4. serving: the port's ``Segmenter`` at full width (patch 77 -> 11, stride
   2, 366 features, 8 + 9 classes, dense CRF on with 10 mean-field
   iterations, the configuration of ``bench.py``) behind its HTTP services
   takes 10 VGA keyframes and 2 local maps of 30000 points; each map's ms,
   lattice vertex count and vertex bucket are printed; all three query
   services are called, every label is checked to be in range, both layers
   must have points that are not Unknown, and both kernels' launch counts
   must have risen during this phase;
5. reference: one VGA keyframe and one 30000-point map through the same
   pipelines on the CPU (plain versions) and on the card, with the dense CRF
   off and on, must agree on >= 99.9% of the map labels; on the card the
   device lattice build must equal the CPU's and the host build (native
   builder, padded, sorted stream: same vertex count, equal offsets and
   blur tables up to the native builder's vertex numbering, barycentric
   weights within 1e-5), and the mean-field marginals from the two builds
   must agree within rtol 2e-4 / atol 2e-5;
6. the kernel-experiment entry points (``scripts/exp_descent.py`` on random
   and on real VGA features, ``scripts/exp_patches.py`` at VGA) run in bench
   mode: each must report parity, and the launch counts of C' and D' must
   have risen during this phase;
7. one ``torch.profiler`` window over one CRF map (30000 points, 5
   keyframes): device time of fusion, lattice build and mean field, the
   wall time, the device's busy time and idle share; and the same map's
   unprofiled ms with the dense CRF on and off;
8. the streaming step: ``StreamingPipeline.run_staged`` over the 10 VGA
   keyframes and both maps (dense CRF on, 10 iterations) after one
   validating ``run_device`` map; frame and map labels must equal the
   separate paths' (``run_batch_stacked``, then ``run_device`` per map) in
   the same call, kernels A and B must launch; ms per batch and per
   keyframe of both;
9. the evaluation CLI: ``cli.test_multi`` of the port over a synthetic
   4-image VGA dataset (the fixture forest as its shared model) on the card
   and on the CPU; the confusion matrices must agree on >= 99.9% of the
   counted pixels, kernels A and B must launch; the card's time per image;
10. the 2D dense CRF: ``cli.dense_inference.run`` on a 320x240 image with
   21 labels, half of its annotation unknown, with both lattice builds on
   the card and on the CPU; card and CPU labels, and the two builds, must
   agree on >= 99.99% of the pixels; ms per build on the card (median of
   3) and the vertex counts.

The last lines are the card's name and power limit, one JSON object of
per-kernel results, and ``{"ok": true, "device": {...}}``. Inputs and
weights are made from fixed seeds; nothing here uses JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "resources", "bench_forest.dat")
H, W, STRIDE = 480, 640, 2
MAP_EVERY = 5  # keyframes per local map
MAP_POINTS = 30000
N_KEYFRAMES = 10
DRIFT = np.array([0.1, 0.04, 0.0])  # per-keyframe camera motion (passes the gate)

CONFIG = {
    "root_dir": "",
    "color_codings": [
        {
            "name": "material",
            "coding": [
                *({"name": f"m{i}", "color": [30 * i, 0, 0], "label": i}
                  for i in range(7)),
                {"name": "Unknown", "color": [50, 50, 50], "label": 7},
                {"name": "Void", "color": [0, 0, 0], "label": -1},
            ],
        },
        {
            "name": "object",
            "coding": [
                *({"name": f"o{i}", "color": [0, 30 * i, 0], "label": i}
                  for i in range(8)),
                {"name": "Unknown", "color": [50, 50, 50], "label": 8},
                {"name": "Void", "color": [0, 0, 0], "label": -1},
            ],
        },
    ],
    "use_dense_crf": True,
    "dcrf_xyz_kernel": 0.5,
    "dcrf_rgb_kernel": 4.0,
    "dcrf_kernel_weight": 10.0,
    "dcrf_iterations": 10,
    "rf_prediction_stride": STRIDE,
    "depth_min": 0.5,
    "depth_max": 15.0,
    "keyframe_skip_rotation": 0.1,
    "keyframe_skip_translation": 0.07,
    "patch_size": 77,
    "patch_size_reduce": 11,
    "feature_color_patch": True,
    "feature_depth": True,
    "feature_height": True,
    "feature_normal": True,
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def make_cloud(rng, frames, first):
    """Backprojected surface points of ``MAP_EVERY`` keyframes, world frame."""
    fx = fy = 525.0
    cx, cy = W / 2, H / 2
    per_frame = MAP_POINTS // MAP_EVERY
    pts, cols = [], []
    for f in range(first, first + MAP_EVERY):
        d = frames[f][1].astype(np.float32) / 1000.0
        ys = rng.integers(0, H, per_frame)
        xs = rng.integers(0, W, per_frame)
        z = d[ys, xs]
        z = np.where(z > 0, z, 2.0)
        pts.append(
            np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=1)
            + DRIFT * f
        )
        cols.append(frames[f][0][ys, xs].astype(np.float32) / 255.0)
    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(cols).astype(np.float32),
    )


def make_demo_pair(rng, h, w, labels=21):
    """A dense_inference input: an image of noisy piecewise-constant colour
    regions (Voronoi cells of 24 seeds) and its annotation, each region in
    one of ``labels`` colours, half of the pixels unknown (black)."""
    ys, xs = np.mgrid[0:h, 0:w]
    seeds = rng.uniform([0, 0], [h, w], (24, 2))
    region = np.argmin((ys[..., None] - seeds[:, 0]) ** 2
                       + (xs[..., None] - seeds[:, 1]) ** 2, axis=-1)
    region_label = np.concatenate([np.arange(labels),
                                   rng.integers(0, labels, 24 - labels)])
    colours = rng.integers(30, 226, (24, 3))
    im = colours[region] + rng.normal(0, 12, (h, w, 3))
    i = np.arange(labels)[:, None]
    palette = np.concatenate([(i * 37 + 20) % 256, (i * 91 + 40) % 256,
                              (i * 53 + 60) % 256], axis=1)
    anno = palette[region_label[region]]
    anno[rng.random((h, w)) < 0.5] = 0
    return (np.clip(im, 0, 255).astype(np.uint8), anno.astype(np.uint8))


def write_eval_dataset(root, rng, frames, calib):
    """A dataset in the reference layout (as tests/test_cli.py builds it)
    from VGA ``frames``, with ground truth from depth bands, and its
    config -> config path. The fixture forest is the shared model."""
    from rovinasemanticsegmentation_tpu_torch.utils.imageio import save_color
    from rovinasemanticsegmentation_tpu_torch.utils.labels import RgbLabelConversion

    for sub in ("rgb", "depth", "mat_labels", "obj_labels", "calibration",
                "splits", "models"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    codings = {c["name"]: c["coding"] for c in CONFIG["color_codings"]}
    mat_conv = RgbLabelConversion(codings["material"])
    obj_conv = RgbLabelConversion(codings["object"])
    names = [f"img{i}" for i in range(len(frames))]
    for name, (rgb, depth) in zip(names, frames):
        save_color(f"{root}/rgb/{name}.png", rgb)
        with open(f"{root}/depth/{name}.pgm", "wb") as f:
            f.write(b"P5\n%d %d\n65535\n" % (W, H))
            f.write(depth.astype(">u2").tobytes())
        mat = np.digitize(depth, [1500, 2500, 3000, 3500, 4000, 4500, 5000])
        mat = mat.astype(np.int8)
        mat[rng.random((H, W)) < 0.05] = -1  # void
        save_color(f"{root}/mat_labels/{name}_L.png", mat_conv.label_to_rgb(mat))
        obj = np.digitize(depth, np.linspace(1000, 5500, 8))
        obj = (obj + (np.arange(W) >= W // 2)) % 9
        save_color(f"{root}/obj_labels/{name}_L.png",
                   obj_conv.label_to_rgb(obj.astype(np.int8)))
        calib.save_to_file(f"{root}/calibration/{name}.json")
    with open(f"{root}/splits/test.json", "w") as f:
        json.dump(names, f)
    shutil.copy(FIXTURE, f"{root}/models/forest_shared.dat")
    config = dict(
        CONFIG, root_dir=root, color_dir="rgb/", color_ext=".png",
        depth_dir="depth/", depth_ext=".pgm",
        material_label_dir="mat_labels/", material_label_ext="_L.png",
        object_label_dir="obj_labels/", object_label_ext="_L.png",
        material_result_dir="mat_results/", material_result_ext=".png",
        object_result_dir="obj_results/", object_result_ext=".png",
        calibration_dir="calibration/", calibration_ext=".json",
        file_names_test="splits/test.json", training_label_prefix="shared",
        forest_file_name="models/forest_shared.dat",
    )
    path = f"{root}/config.json"
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def pose_of(f):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = DRIFT * f
    return p


def time_cuda(fn, reps, warmup=2) -> float:
    """Mean ms per call on the card, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Card clock cycles to spin per timed launch, about 100 us at 1.98 GHz: several
# times what the host takes to issue one launch through its wrapper.
SPIN_CYCLES_PER_LAUNCH = 200_000


def time_launch(launch, reps, warmup=2) -> float:
    """Mean device ms per kernel launch. The launches are queued behind a
    spin kernel, so the CUDA events time the card running them back to back
    and not the host issuing them, which is slower than a kernel of a few
    microseconds."""
    import torch

    for _ in range(warmup):
        launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_LAUNCH * reps)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# H100 SXM data sheet (700 W): device memory at 3.35 TB/s. Integer work is
# counted as 32-bit instructions per issue pipe: the FMA pipe (IMUL, IMAD)
# and the ALU pipe (shifts, logic, compares, IADD3) each issue 64 per SM per
# clock and run at the same time (the CUDA programming guide's throughput
# table for compute capability 9.0), 132 SMs at the 1.98 GHz boost clock of
# the data sheet's float32 peak of 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PIPE_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit instructions per output byte of a bilinear 8U resample, by pipe:
# four multiplies and two multiply-adds with the rounding term, one shift.
RESAMPLE_OPS = {"fma": 6, "alu": 1}
# Per descent level: field shift and mask, the compare, the child add.
LEVEL_OPS = {"alu": 4}
# Per pixel of the Lab pack: two shifts and two ors.
PACK_OPS = {"alu": 4}


def bound(nbytes: float, ops: dict, count: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the busiest pipe's instructions (``ops`` per unit times
    ``count`` units) over its rate."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    pipe_ops = max(ops.values()) * count
    by_ops = 1e3 * pipe_ops / PIPE_OPS_PER_S
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(pipe_ops))


def descent_reads(feats, forest):
    """What the descent must read on ``feats``, from the plain descent on
    the card: a [P, D] mask of the (point, feature) pairs it compares, the
    number of distinct (tree, node) records it loads, the distinct (tree,
    leaf) histograms it sums, its levels, and its leaf ids."""
    import torch

    records = forest.records
    num_trees, n_nodes, _ = records.shape
    p, d = feats.shape
    dev = feats.device
    fmask = (1 << forest.feat_bits) - 1
    trees = torch.arange(num_trees, device=dev)[None, :]
    points = torch.arange(p, device=dev)[:, None].expand(p, num_trees)
    node = torch.zeros((p, num_trees), dtype=torch.int64, device=dev)
    touched = torch.zeros((p, d), dtype=torch.bool, device=dev)
    visited = torch.zeros((num_trees, n_nodes), dtype=torch.bool, device=dev)
    levels = 0
    for _ in range(forest.max_depth):
        meta = records[..., 0][trees, node]
        visited[trees.expand(p, num_trees), node] = True
        left = meta >> forest.feat_bits
        active = left != 0
        n_active = int(active.sum())
        if n_active == 0:
            break
        levels += n_active
        f = (meta & fmask).long()
        touched[points[active], f[active]] = True
        x = feats[points, f]
        thr = records[..., 1].view(torch.float32)[trees, node]
        node = torch.where(active, left.long() + (x >= thr).long(), node)
    reached = torch.zeros_like(visited)
    reached[trees.expand(p, num_trees), node] = True
    return dict(touched=touched, records=int(visited.sum()),
                leaves=int(reached.sum()), levels=levels,
                leaf_ids=node.to(torch.int32))


def descent_bound(reads, forest, layout, with_histograms=True) -> dict:
    """Kernel B's (or C''s, without histograms) bound on rows in ``layout``:
    each compared feature once (a patch byte, or 4 bytes), each loaded node
    record (8 B) and summed leaf histogram once, the outputs once."""
    touched = reads["touched"]
    p, d = touched.shape
    pc = layout.patch_bytes
    feature_bytes = (int(touched[:, :pc].sum())
                     + 4 * int(touched[:, pc:].sum()))
    num_trees, _, num_layers, c_max = forest.leaf_hist.shape
    nbytes = feature_bytes + 8 * reads["records"] + 4 * p * num_trees
    if with_histograms:
        lc = num_layers * c_max
        nbytes += 4 * lc * reads["leaves"] + 4 * p * lc
    return dict(bound(nbytes, LEVEL_OPS, reads["levels"]),
                feature_bytes=feature_bytes)


def resample_bound(image_bytes, depth_grid, patch_bytes, row_bytes) -> dict:
    """Kernel A's (and D''s) bound: the image and depth grid read once,
    every output row written once, ``RESAMPLE_OPS`` per patch byte of a
    point with depth."""
    points = depth_grid.numel()
    valid = int((depth_grid > 0).sum())
    nbytes = image_bytes + 4 * points + row_bytes * points
    return bound(nbytes, RESAMPLE_OPS, patch_bytes * valid)


def http_json(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def run(card: str) -> dict:
    import torch

    from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
    from rovinasemanticsegmentation_tpu_torch.utils.config import Config
    from rovinasemanticsegmentation_tpu_torch.csrc.build import load_kernels
    from rovinasemanticsegmentation_tpu_torch.device import resolve_device
    from rovinasemanticsegmentation_tpu_torch.features.extractor import (
        FeatureConfig,
        extract_feature_rows,
        extract_features,
        feature_row_layout,
        patch_inputs,
    )
    from rovinasemanticsegmentation_tpu_torch.fusion.projector import (
        MultiProjector,
    )
    from rovinasemanticsegmentation_tpu_torch.models.crf import (
        potts_mean_field_multi_t,
    )
    from rovinasemanticsegmentation_tpu_torch.models.forest import (
        find_leaves_plain,
        forest_from_numpy,
        load_forest,
        permute_forest_features,
        sum_leaf_histograms_plain,
        usage_permutation,
    )
    from rovinasemanticsegmentation_tpu_torch.ops import forest_cuda
    from rovinasemanticsegmentation_tpu_torch.ops.feature_rows import (
        RowLayout,
        unpack_rows,
    )
    from rovinasemanticsegmentation_tpu_torch.ops import forest_staged_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import patches_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import patches_planar_cuda
    from rovinasemanticsegmentation_tpu_torch.ops.patches import (
        extract_patches_plain,
        extract_patches_separable_plain,
    )
    from rovinasemanticsegmentation_tpu_torch.models.lattice import (
        attach_sorted_stream,
        build_lattice,
        build_lattice_device,
        lattice_filter_t,
        lattice_tensors,
        pad_lattice,
    )
    from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
        CrfParams,
        LocalMapPipeline,
        MapNodeFrames,
        crf_feats,
        crf_labels_multi,
    )
    from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
        SingleFramePipeline,
    )
    from rovinasemanticsegmentation_tpu_torch.serve.segmenter import (
        LocalMapData,
        MapNode,
        Segmenter,
    )
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        exp_descent,
        exp_patches,
    )
    from rovinasemanticsegmentation_tpu_torch.scripts.profile_frames import (
        FRAME_SEED,
        FRAMES,
        make_frames,
    )
    from rovinasemanticsegmentation_tpu_torch.serve.services import (
        SegmentationServiceServer,
    )
    from rovinasemanticsegmentation_tpu_torch.utils.imageio import save_ppm
    from rovinasemanticsegmentation_tpu_torch.cli import dense_inference
    from rovinasemanticsegmentation_tpu_torch.cli import (
        test_multi as cli_test_multi,
    )
    from rovinasemanticsegmentation_tpu_torch.models.crf2d_device import (
        _dense2d_device_impl,
    )
    from rovinasemanticsegmentation_tpu_torch.pipelines.streaming import (
        StreamingPipeline,
        pack_poses,
    )

    counters = (patches_cuda.launches, patches_cuda.pack_launches,
                forest_cuda.launches, forest_staged_cuda.launches,
                patches_planar_cuda.launches)

    def reset_counts():
        for counter in counters:
            counter.reset()

    # ---- phase 1: device and build
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    load_kernels()
    build_s = time.perf_counter() - t0
    print(f"phase 1: kernels built and loaded in {build_s:.3f} s ({card})")

    rng = np.random.default_rng(FRAME_SEED)
    cfg = FeatureConfig()
    calib = Calibration(
        intrinsic=np.array([[525.0, 0, W / 2], [0, 525.0, H / 2], [0, 0, 1]]),
        rotation=np.eye(3),
        translation=np.zeros(3),
    )
    frames = make_frames(rng, N_KEYFRAMES)

    def frame_tensors(rgb, depth):
        return (torch.from_numpy(rgb).to(dev),
                torch.from_numpy(depth.astype(np.int32)).to(dev))

    # ---- phase 2: kernel A (and its pack_lab) vs plain, in both strides
    results = {}
    layout = feature_row_layout(cfg)
    pc = layout.patch_bytes
    rgb_t, depth_t = frame_tensors(*frames[0])
    padded, dgrid = patch_inputs(rgb_t, depth_t, cfg, STRIDE)
    p0 = dgrid.numel()
    hp, wp, _ = padded.shape
    packed_img = patches_cuda.pack_lab(padded)
    torch.cuda.synchronize()
    check(torch.equal(packed_img, patches_cuda.pack_lab_plain(padded)),
          "pack_lab differs from its plain version")
    ms_pack = time_launch(patches_cuda.pack_launcher(padded)[0], 50)
    wrapper_ms_pack = time_cuda(lambda: patches_cuda.pack_lab(padded), 50)
    plain_ms_pack = time_cuda(lambda: patches_cuda.pack_lab_plain(padded), 20)
    results["pack_lab"] = dict(max_abs_err=0, ms=ms_pack,
                               wrapper_ms=wrapper_ms_pack,
                               plain_ms=plain_ms_pack,
                               **bound(7 * hp * wp, PACK_OPS, hp * wp))
    got = patches_cuda.extract_patches(padded, dgrid, 77, 11, STRIDE)
    want = extract_patches_plain(padded, dgrid, 77, 11, STRIDE)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "kernel A differs from its plain version "
          "at VGA stride 2")
    err_a = int((got.int() - want.int()).abs().max())

    def check_packed_a(lab, grid, s, row0):
        """Kernel A into packed rows from ``row0`` == its plain version, and
        the rows around the frame's block untouched."""
        n = grid.numel()
        buf = torch.full((row0 + n + 5, layout.row_bytes), 0xAB,
                         dtype=torch.uint8, device=dev)
        ref = buf.clone()
        patches_cuda.extract_patches_into(lab, grid, 77, 11, s, buf, row0)
        patches_cuda.extract_patches_into_plain(lab, grid, 77, 11, s, ref,
                                                row0)
        torch.cuda.synchronize()
        check(torch.equal(buf, ref), f"kernel A differs from its plain "
              f"version in packed rows from row {row0} at stride {s}")
        return buf[row0 : row0 + n, :pc]

    for row0 in (3 * p0, 1):  # frame 3 of a batch; an odd first row
        block = check_packed_a(padded, dgrid, STRIDE, row0)
        check(torch.equal(block, want.reshape(p0, pc)), "kernel A's packed "
              "rows differ from its [gh, gw, R, R, 3] output")
    out363 = torch.empty_like(got)
    rows_a = torch.empty((p0, layout.row_bytes), dtype=torch.uint8, device=dev)
    ms_a363 = time_launch(patches_cuda.launcher(
        padded, dgrid, 77, 11, STRIDE, out363, 0, pc), 50)
    ms_a = time_launch(patches_cuda.launcher(
        padded, dgrid, 77, 11, STRIDE, rows_a, 0, layout.row_bytes), 50)
    wrapper_ms_a363 = time_cuda(
        lambda: patches_cuda.extract_patches(padded, dgrid, 77, 11, STRIDE), 50
    )
    wrapper_ms_a = time_cuda(
        lambda: patches_cuda.extract_patches_into(padded, dgrid, 77, 11,
                                                  STRIDE, rows_a, 0), 50
    )
    plain_ms_a = time_cuda(
        lambda: patches_cuda.extract_patches_into_plain(
            padded, dgrid, 77, 11, STRIDE, rows_a, 0), 5
    )
    bound_a = resample_bound(4 * hp * wp, dgrid, pc, layout.row_bytes)
    bound_a363 = resample_bound(4 * hp * wp, dgrid, pc, pc)
    print(f"phase 2: pack_lab == plain: device time alone {ms_pack:.4f} ms, "
          f"wrapper {wrapper_ms_pack:.4f} ms, plain {plain_ms_pack:.4f} ms; "
          f"bound {results['pack_lab']['bound_ms']:.4f} ms, "
          f"{results['pack_lab']['bound_ms'] / ms_pack:.1%} of it ({card})")
    print(f"phase 2: kernel A == plain at VGA stride 2 into {pc}-B rows "
          f"([gh, gw, R, R, 3]) and into {layout.row_bytes}-B packed rows from "
          f"rows {3 * p0} and 1; device time alone {ms_a363:.4f} / "
          f"{ms_a:.4f} ms, wrapper (pack_lab, taps, launch) "
          f"{wrapper_ms_a363:.4f} / {wrapper_ms_a:.4f} ms; bound "
          f"{bound_a363['bound_ms']:.4f} / {bound_a['bound_ms']:.4f} ms by "
          f"{bound_a['bound_by']} ({bound_a['bound_bytes']} B, "
          f"{bound_a['bound_ops']} instructions on the busiest pipe), "
          f"{bound_a363['bound_ms'] / ms_a363:.1%} / "
          f"{bound_a['bound_ms'] / ms_a:.1%} of it; plain {plain_ms_a:.4f} ms "
          f"({card})")
    results["patches"] = dict(max_abs_err=err_a, ms=ms_a,
                              wrapper_ms=wrapper_ms_a, ms_363=ms_a363,
                              plain_ms=plain_ms_a, **bound_a)

    got_d = patches_planar_cuda.extract_patches_planar(
        padded, dgrid, 77, 11, STRIDE
    )
    want_d = extract_patches_separable_plain(padded, dgrid, 77, 11, STRIDE)
    torch.cuda.synchronize()
    check(torch.equal(got_d, got), "kernel D' differs from kernel A at VGA "
          "stride 2")
    check(torch.equal(want_d, want), "the separable plain version differs "
          "from extract_patches_plain at VGA stride 2")
    err_d = int((got_d.int() - want_d.int()).abs().max())
    launch_d, _ = patches_planar_cuda.launcher(padded, dgrid, 77, 11, STRIDE)
    ms_d = time_launch(launch_d, 50)
    wrapper_ms_d = time_cuda(
        lambda: patches_planar_cuda.extract_patches_planar(
            padded, dgrid, 77, 11, STRIDE), 50
    )
    plain_ms_d = time_cuda(
        lambda: extract_patches_separable_plain(padded, dgrid, 77, 11, STRIDE),
        5,
    )
    bound_d = resample_bound(3 * hp * wp, dgrid, pc, pc)
    print(f"phase 2b: kernel D' == kernel A == both plain versions at VGA "
          f"stride 2; device time alone {ms_d:.4f} ms, wrapper (with the "
          f"planar copy) {wrapper_ms_d:.4f} ms; bound "
          f"{bound_d['bound_ms']:.4f} ms by {bound_d['bound_by']}, "
          f"{bound_d['bound_ms'] / ms_d:.1%} of it; separable plain "
          f"{plain_ms_d:.4f} ms ({card})")
    small = make_frames(np.random.default_rng(1), 1, 240, 320)[0]
    for s in (1, 5):
        srgb, sdepth = frame_tensors(*small)
        sp, sd = patch_inputs(srgb, sdepth, cfg, s)
        a = patches_cuda.extract_patches(sp, sd, 77, 11, s)
        b = extract_patches_plain(sp, sd, 77, 11, s)
        d = patches_planar_cuda.extract_patches_planar(sp, sd, 77, 11, s)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"kernel A differs at 240x320 stride {s}")
        check(torch.equal(check_packed_a(sp, sd, s, 7),
                          b.reshape(sd.numel(), pc)),
              f"kernel A's packed rows differ at 240x320 stride {s}")
        print(f"phase 2: kernel A == plain at 240x320 stride {s}, both "
              f"strides")
        check(torch.equal(d, a), f"kernel D' differs at 240x320 stride {s}")
        print(f"phase 2b: kernel D' == kernel A at 240x320 stride {s}")
    results["patches_planar"] = dict(
        max_abs_err=err_d, ms=ms_d, wrapper_ms=wrapper_ms_d,
        plain_ms=plain_ms_d, **bound_d
    )

    # ---- phase 3: kernel B vs plain, fixture forest, float and packed rows
    forest_np = load_forest(FIXTURE, class_counts=[8, 9])
    forest = forest_from_numpy(forest_np, dev)
    kinv = torch.from_numpy(calib.intrinsic_inverse).to(dev)
    rot = torch.from_numpy(calib.rotation).to(dev)
    trans = torch.from_numpy(calib.translation).to(dev)
    feats, mask = extract_features(rgb_t, depth_t, kinv, rot, trans, cfg, STRIDE)
    check(tuple(feats.shape) == ((H // 2) * (W // 2), 366),
          f"feature shape {tuple(feats.shape)}")
    check(bool(torch.isfinite(feats).all()), "non-finite features")
    float_layout = RowLayout.float32(feats.shape[1])
    leaves, post = forest_cuda.forest_predict(feats, forest)
    want_leaves, want_post = forest_cuda.forest_predict_plain(feats, forest)
    torch.cuda.synchronize()
    check(torch.equal(leaves, want_leaves), "kernel B leaf ids differ")
    check(torch.equal(post, want_post), "kernel B posteriors differ")
    err_b = float((post - want_post).abs().max())
    rows0 = torch.empty((p0, layout.row_bytes), dtype=torch.uint8, device=dev)
    mask_r = extract_feature_rows(rgb_t, depth_t, kinv, rot, trans, cfg,
                                  STRIDE, rows0, 0)
    check(torch.equal(mask_r, mask), "packed rows give another mask")
    check(torch.equal(unpack_rows(rows0, layout).view(torch.int32),
                      feats.view(torch.int32)),
          "the frame's packed rows unpack to other features")
    leaves_r, post_r = forest_cuda.forest_predict_rows(rows0, layout, forest)
    torch.cuda.synchronize()
    check(torch.equal(leaves_r, want_leaves) and torch.equal(post_r, want_post),
          "kernel B on packed rows differs from the plain version")
    print(f"phase 3: kernel B == plain on the frame's {tuple(feats.shape)} "
          f"float rows and its {tuple(rows0.shape)} packed rows, "
          f"{forest.num_trees} trees")

    # The main path's shape: one descent over a batch of 8 keyframes.
    nb = FRAMES
    rows8 = torch.empty((nb * p0, layout.row_bytes), dtype=torch.uint8,
                        device=dev)
    feats8 = []
    for i in range(nb):
        rgb_i, depth_i = frame_tensors(*frames[i])
        extract_feature_rows(rgb_i, depth_i, kinv, rot, trans, cfg, STRIDE,
                             rows8, i * p0)
        feats8.append(extract_features(rgb_i, depth_i, kinv, rot, trans, cfg,
                                       STRIDE)[0])
    feats8 = torch.cat(feats8)
    l8r, p8r = forest_cuda.forest_predict_rows(rows8, layout, forest)
    l8f, p8f = forest_cuda.forest_predict(feats8, forest)
    l8p, p8p = forest_cuda.forest_predict_plain(feats8, forest)
    torch.cuda.synchronize()
    check(torch.equal(l8r, l8p) and torch.equal(p8r, p8p),
          "kernel B on the batch's packed rows differs from the plain version")
    check(torch.equal(l8f, l8p) and torch.equal(p8f, p8p),
          "kernel B on the batch's float rows differs from the plain version")
    reads8 = descent_reads(feats8, forest)
    reads0 = descent_reads(feats, forest)
    check(torch.equal(reads8["leaf_ids"], l8p)
          and torch.equal(reads0["leaf_ids"], want_leaves),
          "the read count's descent differs from the plain descent")
    launch_b, _, _ = forest_cuda.launcher(rows8, layout, forest)
    launch_bf, _, _ = forest_cuda.launcher(feats8.view(torch.uint8),
                                           float_layout, forest)
    launch_b1, _, _ = forest_cuda.launcher(rows0, layout, forest)
    launch_b1f, _, _ = forest_cuda.launcher(feats.view(torch.uint8),
                                            float_layout, forest)
    ms_b, ms_bf, ms_b1, ms_b1f = (time_launch(fn, 20) for fn in (
        launch_b, launch_bf, launch_b1, launch_b1f))
    wrapper_ms_b = time_cuda(
        lambda: forest_cuda.forest_predict_rows(rows8, layout, forest), 20
    )
    plain_ms_b = time_cuda(
        lambda: forest_cuda.forest_predict_plain(unpack_rows(rows8, layout),
                                                 forest), 2, warmup=1
    )
    bounds_b = {
        name: descent_bound(reads, forest, lay)
        for name, reads, lay in (("batch packed", reads8, layout),
                                 ("batch float", reads8, float_layout),
                                 ("frame packed", reads0, layout),
                                 ("frame float", reads0, float_layout))
    }
    pairs = reads8["touched"].shape[0] * forest.num_trees
    print(f"phase 3: the descent on {nb} keyframes: "
          f"{reads8['levels'] / pairs:.3f} levels per (point, tree), "
          f"{int(reads8['touched'].sum()) / (nb * p0):.3f} distinct features "
          f"per point, {reads8['records']} node records, "
          f"{reads8['leaves']} leaf histograms")
    for (name, bnd), ms in zip(bounds_b.items(), (ms_b, ms_bf, ms_b1, ms_b1f)):
        print(f"phase 3: kernel B on the {name} rows: device time alone "
              f"{ms:.4f} ms; bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']} ({bnd['bound_bytes']} B, of them "
              f"{bnd['feature_bytes']} B of features), {bnd['bound_ms'] / ms:.1%}"
              f" of it ({card})")
    print(f"phase 3: kernel B == plain on the batch's {tuple(rows8.shape)} "
          f"packed rows and {tuple(feats8.shape)} float rows; wrapper "
          f"{wrapper_ms_b:.4f} ms, plain (unpack, descent, sum) "
          f"{plain_ms_b:.4f} ms ({card})")
    bound_b = dict(bounds_b["batch packed"])
    bound_b.pop("feature_bytes")
    results["forest_descent"] = dict(
        max_abs_err=err_b, ms=ms_b, wrapper_ms=wrapper_ms_b,
        plain_ms=plain_ms_b, **bound_b
    )
    del feats8, rows8, reads8, l8r, p8r, l8f, p8f, l8p, p8p

    # ---- phase 3b: kernel C' on the usage-permuted features
    perm, remap = usage_permutation(forest, feats.shape[1])
    forest_p = permute_forest_features(forest, remap)
    feats_p = feats[:, torch.from_numpy(perm).to(dev)].contiguous()

    def plain_c():
        return find_leaves_plain(
            feats_p, forest_p.records, forest_p.max_depth, forest_p.feat_bits
        )

    want_c = plain_c()
    check(torch.equal(want_c, want_leaves), "the plain descent on permuted "
          "features differs from the unpermuted one")
    ms_c, wrapper_ms_c = {}, {}
    for hot in (128, 366):
        got_c = forest_staged_cuda.find_leaves_staged(feats_p, forest_p, hot)
        torch.cuda.synchronize()
        check(torch.equal(got_c, leaves),
              f"kernel C' (hot {hot}) leaf ids differ from kernel B's")
        check(torch.equal(got_c, want_c),
              f"kernel C' (hot {hot}) leaf ids differ from the plain descent")
        check(torch.equal(sum_leaf_histograms_plain(forest.leaf_hist, got_c),
                          post),
              f"posteriors from kernel C' (hot {hot}) leaves differ from B's")
        err_c = int((got_c - want_c).abs().max())
        launch_c, _ = forest_staged_cuda.launcher(feats_p, forest_p, hot)
        ms_c[hot] = time_launch(launch_c, 50)
        wrapper_ms_c[hot] = time_cuda(
            lambda hot=hot: forest_staged_cuda.find_leaves_staged(
                feats_p, forest_p, hot), 50
        )
        print(f"phase 3b: kernel C' (hot {hot}, "
              f"{forest_staged_cuda.TILE_POINTS} points per block) == B == "
              f"plain; device time alone {ms_c[hot]:.4f} ms, wrapper "
              f"{wrapper_ms_c[hot]:.4f} ms ({card})")
    plain_ms_c = time_cuda(plain_c, 5)
    bound_c = descent_bound(reads0, forest, float_layout,
                            with_histograms=False)
    bound_c.pop("feature_bytes")
    print(f"phase 3b: C' bound {bound_c['bound_ms']:.4f} ms by "
          f"{bound_c['bound_by']}, {bound_c['bound_ms'] / ms_c[366]:.1%} of "
          f"it at hot 366; plain descent on permuted features "
          f"{plain_ms_c:.4f} ms ({card})")
    results["forest_descent_staged"] = dict(
        max_abs_err=err_c, ms=ms_c[366], wrapper_ms=wrapper_ms_c[366],
        plain_ms=plain_ms_c, **bound_c
    )

    # ---- phase 3c: one profiled batch of 8 keyframes through the frame path,
    # in a process of its own (scripts/profile_frames.py on the same seed's
    # first 8 keyframes), so that the profiler's tracing does not stay
    # attached to this process through the phases that time the main path.
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "rovinasemanticsegmentation_tpu_torch",
                                      "scripts", "profile_frames.py"),
         "--reps", "1"],
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0,
          f"scripts/profile_frames.py failed: {proc.stderr[-3000:]}")
    prof3 = json.loads(proc.stdout.strip().splitlines()[-1])
    launches3 = {name: prof3["port_kernels"][name]["launches_per_batch"]
                 for name in ("patches_kernel", "forest_descent_kernel")}
    for name, n in launches3.items():
        check(n > 0, f"kernel {name} did not run in run_batch_stacked")
    check(not prof3["float_feature_passes"], "float passes over the "
          f"features on the frame path: {prof3['float_feature_passes']}")
    print(f"phase 3c: run_batch_stacked, {nb} VGA keyframes under "
          f"torch.profiler: device time {prof3['device_ms_per_keyframe']:.4f} "
          f"ms per keyframe (busy {prof3['busy_ms_per_keyframe']:.4f} ms, "
          f"{prof3['device_activities_per_batch']:.0f} activities per batch), "
          f"wall {prof3['wall_ms_per_keyframe']:.4f} ms per keyframe; no float "
          f"cat/where/to over [P, 363] or [P, 366] features; kernels run per "
          f"batch {launches3} ({card})")
    for k in prof3["top_kernels"]:
        print(f"phase 3c:   {k['us_per_keyframe']:9.3f} us per keyframe, "
              f"{k['launches_per_batch']:.0f} per batch: {k['name']}")
    for name, k in prof3["port_kernels"].items():
        print(f"phase 3c: port kernel {name}: {k['us_per_keyframe']:.3f} us "
              f"per keyframe, {k['launches_per_batch']:.0f} per batch")

    # ---- phase 4: serving through the HTTP services
    topics = ["/camera_front/rgb/image", "/camera_front/depth/image"]
    maps = []
    map_rng = np.random.default_rng(2)
    for k in range(N_KEYFRAMES // MAP_EVERY):
        maps.append(make_cloud(map_rng, frames, k * MAP_EVERY))

    def serve_session(seg):
        seg.initialize_projector(["camera_front"], [calib], (H, W))
        seg.stop()  # drive the workers' steps inline with drain()
        for f, (rgb, depth) in enumerate(frames):
            seg.push_color("camera_front", f + 1, rgb)
            seg.push_depth("camera_front", f + 1, depth)
            check(seg.on_new_node(MapNode(f + 1, pose_of(f), [f + 1])),
                  f"keyframe {f + 1} was gated out")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg.drain(timeout=600)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        per_map = []  # (ms, vertex count, bucket)
        for k, (pts, cols) in enumerate(maps):
            nodes = [
                MapNode(f + 1, pose_of(f), [f + 1])
                for f in range(k * MAP_EVERY, (k + 1) * MAP_EVERY)
            ]
            seg.on_new_local_map(LocalMapData(k, nodes, pts, cols))
            t0 = time.perf_counter()
            seg.drain(timeout=600)
            torch.cuda.synchronize()
            ms = 1000 * (time.perf_counter() - t0)
            probe = seg._map_pipeline._pending_m[-1]  # this map's count
            per_map.append((ms, probe.value(), probe.bucket))
        seg._map_pipeline.flush()
        return frame_s, per_map

    # A first session warms the allocator and the kernels' first launches.
    serve_session(Segmenter(Config(data=CONFIG), topics, "cuda",
                            forest=forest_np))
    seg = Segmenter(Config(data=CONFIG), topics, "cuda", forest=forest_np)
    server = SegmentationServiceServer(seg)
    server.start()
    try:
        reset_counts()
        frame_s, per_map = serve_session(seg)
        launches = {
            "pack_lab": patches_cuda.pack_launches.value,
            "patches": patches_cuda.launches.value,
            "forest_descent": forest_cuda.launches.value,
        }
        base = server.address + "/semantic_segmentation"
        ids = http_json(base + "/local_map_ids")["local_map_ids"]
        check(ids == [0, 1], f"stored map ids {ids}")
        info = http_json(base + "/information")
        check(info["class_counts"] == [8, 9], f"information {info}")
        for map_id in ids:
            reply = http_json(
                base + "/get_local_map_segmentation",
                {"local_map_id": map_id,
                 "segmentation_layers": ["material", "object"]},
            )
            labels = np.asarray(reply["point_labels"])
            check(labels.shape == (2 * MAP_POINTS,),
                  f"map {map_id}: {labels.shape} labels")
            check(bool(((labels[:MAP_POINTS] >= 0)
                        & (labels[:MAP_POINTS] < 8)).all()),
                  f"map {map_id}: material labels out of range")
            check(bool(((labels[MAP_POINTS:] >= 0)
                        & (labels[MAP_POINTS:] < 9)).all()),
                  f"map {map_id}: object labels out of range")
            known = (labels[:MAP_POINTS] != 7).mean()
            known_obj = (labels[MAP_POINTS:] != 8).mean()
            check(known > 0 and known_obj > 0,
                  f"map {map_id}: a layer is all Unknown")
            print(f"phase 4: map {map_id}: {labels.size} labels in range, "
                  f"{known:.1%} of points with a known material, "
                  f"{known_obj:.1%} with a known object")
    finally:
        server.stop()
        seg.stop()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched while serving")
        results[name]["launches"] = n
    print(f"phase 4: {1000 * frame_s / N_KEYFRAMES:.3f} ms per keyframe "
          f"({N_KEYFRAMES} VGA keyframes) ({card})")
    for k, (ms, m, bucket) in enumerate(per_map):
        check(m <= bucket, f"map {k}: {m} vertices overflow the bucket {bucket}")
        print(f"phase 4: map {k}: {ms:.3f} ms, dense CRF on, {m} lattice "
              f"vertices, bucket {bucket} ({MAP_POINTS} points, {MAP_EVERY} "
              f"keyframes) ({card})")
    print(f"phase 4: {sum(p[0] for p in per_map) / len(per_map):.3f} ms per "
          f"map ({card})")
    print(f"phase 4: launches while serving: {launches}")

    # ---- phase 5: the card against the CPU (plain versions) on one frame
    rgb, depth = frames[0]
    projector = MultiProjector.from_calibrations([calib], H, W, min_distance=0.5)
    pts, cols = maps[0]
    posts, labels5, nodes5 = {}, {}, {}
    for name in ("cpu", "cuda"):
        fp = SingleFramePipeline(cfg, forest_np, STRIDE, name, fill_value=0.0)
        res = fp.run(rgb, depth, calib)
        posts[name] = [p.cpu().numpy() for p in res.posteriors]
        nodes5[name] = [MapNodeFrames(pose=pose_of(0), posteriors=[res.posteriors])]
        for crf_on in (False, True):
            mp = LocalMapPipeline(projector, [8, 9], [7, 8], name,
                                  crf=CrfParams(use_dense_crf=crf_on))
            labels5[name, crf_on] = mp.run(pts, cols, nodes5[name])
            mp.flush()
    for li, (p_cpu, p_gpu) in enumerate(zip(posts["cpu"], posts["cuda"])):
        check(bool(np.isfinite(p_gpu).all()), f"layer {li}: non-finite posterior")
        close = np.isclose(p_gpu, p_cpu, rtol=1e-5, atol=1e-4).all(axis=-1)
        check(close.mean() >= 0.999,
              f"layer {li}: posteriors agree on {close.mean():.4%} of pixels")
    for crf_on in (False, True):
        pairs = zip(labels5["cpu", crf_on], labels5["cuda", crf_on])
        for li, (l_cpu, l_gpu) in enumerate(pairs):
            agree = (l_cpu == l_gpu).mean()
            check(agree >= 0.999, f"layer {li}, dense CRF {crf_on}: map "
                  f"labels agree on {agree:.4%}")
            print(f"phase 5: layer {li}, dense CRF {'on' if crf_on else 'off'}:"
                  f" card vs CPU map labels agree on {agree:.4%} of "
                  f"{l_cpu.size} points")

    # The card's device lattice build against the CPU's and the host build.
    bucket = 1 << 14
    feats_cpu = crf_feats(torch.from_numpy(pts), torch.from_numpy(cols), 0.5, 4.0)
    built = build_lattice_device(feats_cpu.to(dev), bucket)
    built_cpu = build_lattice_device(feats_cpu, bucket)
    for t_gpu, t_cpu in zip(built, built_cpu):
        check(torch.equal(t_gpu.cpu(), t_cpu), "the card's device lattice "
              "build differs from the CPU's")
    m = int(built[-1])
    host = attach_sorted_stream(pad_lattice(build_lattice(feats_cpu.numpy()),
                                            bucket))
    check(host.num_vertices == bucket and m <= bucket,
          f"host build pads to {host.num_vertices}, device m = {m}")
    offsets_t = built[4].cpu().numpy()
    ren = np.full(bucket + 1, bucket)  # host vertex id -> device vertex id
    ren[host.offsets.reshape(-1)] = offsets_t.T.reshape(-1)
    check(np.array_equal(ren[host.offsets], offsets_t.T)
          and len(np.unique(ren[:m])) == m
          and (host.offsets < m).all(),
          "device and host builds differ in vertices or offsets")
    for table, dev_table in (("blur_n1", built[6]), ("blur_n2", built[7])):
        want = np.full((host.dim + 1, bucket), bucket)
        want[:, ren[:m]] = ren[getattr(host, table)[:, :m]]
        check(np.array_equal(want, dev_table.cpu().numpy()),
              f"device and host builds differ in {table}")
    bary_err = float(np.abs(host.barycentric.T - built[5].cpu().numpy()).max())
    check(bary_err <= 1e-5, f"barycentric weights differ by {bary_err}")
    fused = torch.cat(LocalMapPipeline(projector, [8, 9], [7, 8], "cuda")
                      .fuse_unaries(pts, nodes5["cuda"]), dim=1)

    def marginals(lattice, num_vertices):
        ones = torch.ones((1, MAP_POINTS), device=dev)
        norm = 1.0 / torch.sqrt(
            lattice_filter_t(ones, *lattice, num_vertices)[0] + 1e-20)
        return potts_mean_field_multi_t(-fused.T, *lattice, norm, 10.0, (8, 9),
                                        num_vertices, 10)

    q_dev = marginals(built[:8], bucket)
    q_host = marginals(lattice_tensors(host, dev), host.num_vertices)
    q_err = float((q_dev - q_host).abs().max())
    check(bool(torch.isclose(q_dev, q_host, rtol=2e-4, atol=2e-5).all()),
          f"mean field from the device and host builds differs by {q_err}")
    print(f"phase 5: device lattice build == CPU build; == host (native) "
          f"build up to vertex numbering: {m} vertices, barycentric within "
          f"{bary_err:.2e}; marginals from the two builds within {q_err:.2e}")

    # ---- phase 6: the kernel-experiment entry points, in bench mode
    reset_counts()
    runs = [
        exp_descent.main(["bench", "--features", kind, "--reps", "20"])
        for kind in ("random", "real")
    ]
    runs.append(exp_patches.main(["bench", "--reps", "20"]))
    launches = {
        "forest_descent_staged": forest_staged_cuda.launches.value,
        "patches_planar": patches_planar_cuda.launches.value,
    }
    for res in runs:
        check(res["parity"], f"{res['script']} ({res.get('features', '')}) "
              "reports no parity")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the entry points")
        results[name]["launches"] = n
    print(f"phase 6: entry points report parity; launches: {launches}")

    # ---- phase 7: one profiled CRF map, split by stage
    from torch.profiler import ProfilerActivity, profile, record_function

    fp = SingleFramePipeline(cfg, forest_np, STRIDE, "cuda", fill_value=0.0)
    batch = fp.run_batch([f[0] for f in frames[:MAP_EVERY]],
                         [f[1] for f in frames[:MAP_EVERY]],
                         [calib] * MAP_EVERY)
    nodes7 = [MapNodeFrames(pose=pose_of(f), posteriors=[r.posteriors])
              for f, r in enumerate(batch)]
    pts_t = torch.from_numpy(pts).to(dev)
    cols_t = torch.from_numpy(cols).to(dev)
    mp = LocalMapPipeline(projector, [8, 9], [7, 8], "cuda",
                          crf=CrfParams(use_dense_crf=True))
    served = mp.run_device(pts_t, cols_t, nodes7)  # the first map synchronises
    mp.flush()
    torch.cuda.synchronize()

    def median_map_ms(pipeline):
        """The same map unprofiled, median of 3 (steady state: no sync)."""
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipeline.run_device(pts_t, cols_t, nodes7)
            torch.cuda.synchronize()
            runs.append(1000 * (time.perf_counter() - t0))
        pipeline.flush()
        return sorted(runs)[1]

    map_ms = median_map_ms(mp)
    off_ms = median_map_ms(LocalMapPipeline(projector, [8, 9], [7, 8], "cuda"))
    # map_fused's three stages, each in a range that the profiler also
    # draws on the device's timeline; a device activity belongs to the
    # stage whose device-side range holds its start.
    stage_names = ("fusion", "lattice build", "mean field")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(stage_names[0]):
            fused = torch.cat(mp.fuse_unaries(pts_t, nodes7), dim=1)
        with record_function(stage_names[1]):
            built = build_lattice_device(crf_feats(pts_t, cols_t, 0.5, 4.0),
                                         mp._m_bucket)
        with record_function(stage_names[2]):
            staged = crf_labels_multi(
                fused, built[:8], 10.0, [8, 9], mp._m_bucket, 10, [7, 8],
                built[-1] > mp._m_bucket,
            )
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.perf_counter() - t0)
    for a, b in zip(staged, served):
        check(torch.equal(a, b), "the profiled stages differ from run_device")
    device = [e for e in prof.events() if e.device_type.name != "CPU"]
    windows = {e.name: e.time_range for e in device if e.name in stage_names}
    device = [e for e in device if e.name not in stage_names]
    check(len(windows) == 3, f"stage ranges on the device: {sorted(windows)}")
    busy_us = 0.0
    edge = float("-inf")
    for e in sorted(device, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, edge), e.time_range.end
        busy_us += max(0.0, hi - lo)  # union of activity intervals
        edge = max(edge, hi)
    stages = {}
    for name in stage_names:
        r = windows[name]
        inside = [e for e in device if r.start <= e.time_range.start < r.end]
        stages[name] = (sum(e.time_range.elapsed_us() for e in inside) / 1000,
                        len(inside))
    busy_ms = busy_us / 1000
    check(busy_ms > 0, "the profiler saw no device time")
    print(f"phase 7: one CRF map ({MAP_POINTS} points, {MAP_EVERY} keyframes, "
          f"10 iterations) under torch.profiler: device time "
          + ", ".join(f"{k} {ms:.3f} ms ({n} activities)"
                      for k, (ms, n) in stages.items())
          + f"; device busy {busy_ms:.3f} ms ({len(device)} activities) of "
          f"{wall_ms:.3f} ms profiled wall; the same map unprofiled "
          f"{map_ms:.3f} ms (median of 3), device idle share "
          f"{1 - busy_ms / map_ms:.1%} ({card})")
    print(f"phase 7: the same map with the dense CRF off: {off_ms:.3f} ms "
          f"(median of 3) ({card})")

    # ---- phase 8: the streaming step against the separate paths
    b = N_KEYFRAMES
    n_maps = N_KEYFRAMES // MAP_EVERY
    stacks = (
        torch.from_numpy(np.stack([f[0] for f in frames])).to(dev),
        torch.from_numpy(np.stack([f[1] for f in frames]).astype(np.int32)).to(dev),
        np.tile(calib.intrinsic_inverse[None], (b, 1, 1)).astype(np.float32),
        np.tile(calib.rotation[None], (b, 1, 1)).astype(np.float32),
        np.tile(calib.translation[None], (b, 1)).astype(np.float32),
    )
    clouds8 = torch.from_numpy(np.stack([m[0] for m in maps])).to(dev)
    crgb8 = torch.from_numpy(np.stack([m[1] for m in maps])).to(dev)
    poses8 = np.stack([
        pack_poses(projector, [pose_of(f) for f in range(k * MAP_EVERY,
                                                         (k + 1) * MAP_EVERY)])
        for k in range(n_maps)
    ])
    fp8 = SingleFramePipeline(cfg, forest_np, STRIDE, "cuda", fill_value=0.0)
    mp8 = LocalMapPipeline(projector, [8, 9], [7, 8], "cuda",
                           crf=CrfParams(use_dense_crf=True))

    def separate():
        results = fp8.run_batch_stacked(*stacks)
        map_labels = []
        for k in range(n_maps):
            nodes = [MapNodeFrames(pose=pose_of(f),
                                   posteriors=[results[f].posteriors])
                     for f in range(k * MAP_EVERY, (k + 1) * MAP_EVERY)]
            map_labels.append(mp8.run_device(clouds8[k], crgb8[k], nodes))
        return [r.labels for r in results], map_labels

    stream = StreamingPipeline(fp8, mp8, MAP_EVERY)

    def staged():
        return stream.run_staged(*stacks, clouds8, crgb8, poses8)

    want8 = separate()  # the first map validates the bucket for 30000 points
    staged()  # warm
    torch.cuda.synchronize()
    mp8.flush()
    reset_counts()
    got8 = staged()
    launches8 = {"patches": patches_cuda.launches.value,
                 "forest_descent": forest_cuda.launches.value}
    torch.cuda.synchronize()
    mp8.flush()
    for f, (a, w) in enumerate(zip(got8[0], want8[0])):
        for la, lw in zip(a, w):
            check(torch.equal(la, lw), f"streaming: frame {f} labels differ "
                  "from the separate path's")
    for k, (a, w) in enumerate(zip(got8[1], want8[1])):
        for la, lw in zip(a, w):
            check(torch.equal(la, lw), f"streaming: map {k} labels differ "
                  "from run_device's")
    for name, n in launches8.items():
        check(n > 0, f"kernel {name} was not launched by the streaming step")

    runs8 = {staged: [], separate: []}
    for _ in range(3):  # interleaved, so that drift of the host hits both
        for fn, runs in runs8.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(1000 * (time.perf_counter() - t0))
            mp8.flush()
    staged_ms, separate_ms = (sorted(r)[1] for r in runs8.values())
    print(f"phase 8: streaming step == separate paths ({b} VGA keyframes, "
          f"{n_maps} maps of {MAP_POINTS} points, dense CRF on); launches "
          f"{launches8}")
    print(f"phase 8: run_staged {staged_ms:.3f} ms per batch, "
          f"{staged_ms / b:.3f} ms per keyframe; separate paths "
          f"{separate_ms:.3f} ms per batch, {separate_ms / b:.3f} ms per "
          f"keyframe (median of 3) ({card})")

    # ---- phase 9: the evaluation CLI on the card and on the CPU
    with tempfile.TemporaryDirectory() as root:
        conf_path = write_eval_dataset(root, np.random.default_rng(3),
                                       frames[:4], calib)
        accs, times = {}, {}
        for name in ("cuda", "cpu"):
            out = io.StringIO()
            if name == "cuda":
                reset_counts()
            with contextlib.redirect_stdout(out):
                accs[name] = cli_test_multi.main(
                    ["--conf", conf_path, "--device", name])
            if name == "cuda":
                launches9 = {"patches": patches_cuda.launches.value,
                             "forest_descent": forest_cuda.launches.value}
            times[name] = [l for l in out.getvalue().splitlines()
                           if l.startswith("Time per image")]
            check(len(times[name]) == 1, f"no time line on {name}")
    for name, n in launches9.items():
        check(n > 0, f"kernel {name} was not launched by cli.test_multi")
    for li, (a_gpu, a_cpu) in enumerate(zip(accs["cuda"], accs["cpu"])):
        moved = int(np.abs(a_gpu.confusion - a_cpu.confusion).sum())
        agree = 1.0 - moved / (2 * a_cpu.total)
        check(a_cpu.total > 0 and agree >= 0.999,
              f"layer {li}: card and CPU confusion matrices agree on "
              f"{agree:.4%} of counted pixels")
        print(f"phase 9: layer {li}: confusion matrices card vs CPU differ "
              f"by {moved} counts over {a_cpu.total} counted pixels "
              f"(agreement >= {agree:.4%}); global accuracy "
              f"{a_gpu.global_accuracy():.2f}% on the card")
    print(f"phase 9: cli.test_multi, 4 VGA images: {times['cuda'][0]} s on "
          f"the card ({card}); {times['cpu'][0]} s on the CPU; launches "
          f"{launches9}")

    # ---- phase 10: the 2D dense CRF demo, both builds, card and CPU
    im, anno = make_demo_pair(np.random.default_rng(10), 240, 320)
    labels10, ms10 = {}, {}
    with tempfile.TemporaryDirectory() as root:
        save_ppm(f"{root}/im.ppm", im)
        save_ppm(f"{root}/anno.ppm", anno)
        for build in (True, False):
            for name in ("cuda", "cpu"):
                labels10[build, name] = dense_inference.run(
                    f"{root}/im.ppm", f"{root}/anno.ppm", f"{root}/out.ppm",
                    device_build=build, device=name)
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dense_inference.run(f"{root}/im.ppm", f"{root}/anno.ppm",
                                    f"{root}/out.ppm", device_build=build,
                                    device="cuda")
                torch.cuda.synchronize()
                runs.append(1000 * (time.perf_counter() - t0))
            ms10[build] = sorted(runs)[1]
    builds = {True: "device build", False: "host build"}
    for build, what in builds.items():
        agree = (labels10[build, "cuda"] == labels10[build, "cpu"]).mean()
        check(agree >= 0.9999, f"dense_inference {what}: card and CPU labels "
              f"agree on {agree:.4%}")
        print(f"phase 10: {what}: card vs CPU labels agree on {agree:.4%} of "
              f"{im.shape[0] * im.shape[1]} pixels")
    agree = (labels10[True, "cuda"] == labels10[False, "cuda"]).mean()
    check(agree >= 0.9999, f"dense_inference: the two builds agree on "
          f"{agree:.4%} on the card")
    lab = dense_inference.annotation_labels(anno)
    _, counts = _dense2d_device_impl(
        torch.from_numpy(im).to(dev), torch.from_numpy(lab.astype(np.int8)).to(dev),
        torch.tensor(dense_inference.annotation_energies(),
                     dtype=torch.float32, device=dev),
        240, 320, dense_inference.M, 5, (1 << 14, 1 << 14),
        ((3.0, 3.0, 3.0), (80.0, 80.0, 13.0, 13.0, 13.0, 10.0)),
    )
    print(f"phase 10: the two builds agree on {agree:.4%} on the card; "
          f"vertex counts (grid, bilateral) {counts.tolist()} in 16384-slot "
          f"buckets; {(lab < 0).mean():.1%} of the annotation unknown")
    print(f"phase 10: dense_inference 320x240, 21 labels, 5 iterations: "
          f"device build {ms10[True]:.3f} ms, host build {ms10[False]:.3f} ms "
          f"per image on the card (median of 3) ({card})")

    # No single PyTorch call computes any of these functions, so no library
    # call is timed beside them.
    return {
        "kernels": [
            {
                "name": "pack_lab",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/patches.cu",
                "replaces": "rovinasemanticsegmentation_tpu/ops/patches_pallas.py:168",
                "library_ms": None,
                **results["pack_lab"],
            },
            {
                "name": "patches",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/patches.cu",
                "replaces": "rovinasemanticsegmentation_tpu/ops/patches_pallas.py:50",
                "library_ms": None,
                **results["patches"],
            },
            {
                "name": "forest_descent",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "forest_descent.cu",
                "replaces": "rovinasemanticsegmentation_tpu/ops/forest_pallas.py:140",
                "library_ms": None,
                **results["forest_descent"],
            },
            {
                "name": "forest_descent_staged",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "forest_descent_staged.cu",
                "replaces": "scripts/exp_descent.py:64",
                "library_ms": None,
                **results["forest_descent_staged"],
            },
            {
                "name": "patches_planar",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "patches_planar.cu",
                "replaces": "scripts/exp_patches.py:49",
                "library_ms": None,
                **results["patches_planar"],
            },
        ],
    }


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: torch is not importable: {e}",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False; this "
              "script measures the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from rovinasemanticsegmentation_tpu_torch.scripts import (
            card_description,
        )

        card = card_description()
        print(f"phase 1: {card}")
        out = run(card)
    except Exception as e:  # report any phase's failure, then exit nonzero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
