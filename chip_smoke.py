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
2b. kernel D'' (separable patches on a staged image footprint) on the same
   inputs: bit-exact with kernel A, ``extract_patches_plain`` and its own
   plain version ``extract_patches_separable_plain``, as the patch tensor
   and in 384-byte packed rows from row 0 and from a nonzero row (the rows
   around untouched), at VGA stride 2 and at 240x320 strides 1 and 5; the
   blocks whose footprint exceeds its cap are counted;
2c. the normals kernels (``csrc/normals.cu``, three launches a frame)
   against the plain normals on the card: angles, masks, the float64
   integral image and the distance at the grid bit-equal, on phase 2's frame
   at strides 2 and 5 and on a frame of the training recipe at stride 2 with
   smoothing sizes 10, 7 and 4, one count a frame; the three launches timed
   alone and each kernel's device time from a profiler window;
3. kernel B (forest descent + leaf-histogram sum) against its plain version
   with the trained fixture forest, on phase 2's frame and on a batch of 8
   VGA keyframes (the serving path's shape), each as float32 rows and as
   packed rows: equal leaf ids and equal posteriors; the frame's packed rows
   unpack to its float features bit for bit;
3b. kernel C'' (descent over the staged hot prefix of each row) on the
   frame's packed rows after the usage permutation of their byte features,
   at hot = 64, 128 and 363 (the whole row), and on its float32 rows after
   the usage permutation at hot = 366: leaf ids equal to B's and to the
   plain descent's, and the posteriors summed from them equal to B's;
3c. one ``torch.profiler`` window over ``run_batch_stacked`` on 8 VGA
   keyframes, in a process of its own (``scripts/profile_frames.py``):
   device time per keyframe, the top kernels and the port's kernels; kernels
   A and B must run, and no float32 ``cat``, ``where`` or ``to`` over
   ``[P, 363]`` or ``[P, 366]`` features may run;
3d. the resize+argmax kernel (``csrc/resize_argmax.cu``, one launch a frame)
   against the plain ``posterior_maps`` on the card: posteriors and labels
   bit-equal on the fixture forest's posteriors of phase 2's frame with the
   offline (-1000) and online (0) fills, one count a frame; the launch timed
   alone beside its byte floor, the wrapper and the plain version; in a
   profiler window, with the launches queued behind a spin, the kernel's
   device activities must equal its launch count, and the plain version's
   activities are counted;

Phases 2-3b and 3d time each kernel's launch alone (CUDA events around launches
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
   must have points that are not Unknown, and the launch counts of A and B
   must have risen during this phase, the normals and resize+argmax kernels'
   by one a keyframe and the mean-field kernels' by one a map;
4b. the mean-field kernels (``csrc/mean_field.cu``) against the plain mean
   field on phase 4's maps with their fused unaries (the first 5 keyframes'
   posteriors through ``fuse_unaries``), on a device lattice in the bucket:
   the normalisation within 1e-6 relative, the marginals within 1e-5, labels
   equal, two runs bit-equal, one count a call, ``crf_labels_multi``'s labels
   equal to the plain mean field's; on map 0 the kernels' device time alone
   (CUDA events, 50 calls), a ``crf_labels_multi`` call's, and from profiler
   windows each kernel's, the normalisation's and the activities, the plain
   mean field's time and activities, and ``port_bench/roofline.py``'s
   mean-field bound; phase 4 must have counted one call a map;
4c. the lattice-build kernels (``csrc/lattice_build.cu``) against the plain
   PyTorch build on phase 4's map 0 (30000 points, d = 6, 16384 slots): all
   twelve results of ``_build_device`` bit-equal to the plain build's on the
   card and on the CPU, one count a build; the build's device time alone
   (CUDA events, 50 builds), a ``build_lattice_device`` call's, each
   kernel's time and the activities a build from a profiler window, the
   plain build's, and ``port_bench/roofline.py``'s ``lattice_build`` bound;
   phase 4 must have counted one build a map;
5. reference: one VGA keyframe and one 30000-point map through the same
   pipelines on the CPU (plain versions) and on the card, with the dense CRF
   off and on, must agree on >= 99.9% of the map labels; on the card the
   device lattice build must equal the CPU's and the host build (native
   builder, padded, sorted stream: same vertex count, equal offsets and
   blur tables up to the native builder's vertex numbering, barycentric
   weights within 1e-5), and the mean-field marginals from the two builds
   must agree within rtol 2e-4 / atol 2e-5;
6. the kernel-experiment entry points (``scripts/exp_descent.py`` on packed
   rows of random and of real VGA features and on float rows of real ones,
   ``scripts/exp_patches.py`` at VGA) run in bench mode: each must report
   parity, and the launch counts of C'' and D'' must have risen during this
   phase;
7. one ``torch.profiler`` window over one CRF map (30000 points, 5
   keyframes): device time of fusion, lattice build and mean field, the
   wall time, the device's busy time and idle share; and the same map's
   unprofiled ms with the dense CRF on and off;
8. the streaming step: ``StreamingPipeline.run_staged`` over the 10 VGA
   keyframes and both maps (dense CRF on, 10 iterations) after one
   validating ``run_device`` map; frame and map labels must equal the
   separate paths' (``run_batch_stacked``, then ``run_device`` per map) in
   the same call, kernels A and B must launch, the normals kernels once
   a keyframe and the lattice-build kernels once a CRF map; ms per batch and per
   keyframe of both;
9. the evaluation CLI: ``cli.test_multi`` of the port over a synthetic
   4-image VGA dataset (the fixture forest as its shared model) on the card
   and on the CPU; the confusion matrices must agree on >= 99.9% of the
   counted pixels, kernels A and B must launch; the card's time per image;
10. the 2D dense CRF: ``cli.dense_inference.run`` on a 320x240 image with
   21 labels, half of its annotation unknown, with both lattice builds on
   the card and on the CPU; card and CPU labels, and the two builds, must
   agree on >= 99.99% of the pixels; ms per build on the card (median of
   3) and the vertex counts; then ``scripts/bench_dense_inference.py
   --reps 1`` in a process of its own, which must exit 0 with a last line
   that parses (golden check skipped, both builds profiled on the card);
11. forest training (``training_phase``), the fixture forest's recipe
   (``scripts/make_bench_forest.py``: 12 VGA frames through kernel A, ~1.45e5
   samples x 366 features, 4 trees of depth <= 30), after kernel A bit-exact
   with its plain version on one of its frames at stride 5: (a) the exact search
   with device growth and (b) the binned search (256 bins), each trained
   twice by ``learn`` (all 4 trees in one level loop; the same forest both
   times) and once by the tree loop (``grow_tree`` per tree), which must
   grow the same forest bit for bit, with the wall seconds and peak
   allocated device memory of each, the seconds of extraction, samples per
   second, nodes per tree and the deepest leaf, beside
   ``resources/bench_forest.dat``'s; (c) the card's trainer against
   the CPU port on 2 frames (2 trees, depth <= 12): differing nodes, each
   tree's first one a near-tie (``train/compare.py``), then the 12 frames'
   features extracted on the CPU against the card's (every column equal but
   the normal angle's, which must agree within 2.4e-7 rad: float64 integral
   images on both sides), and the card's forest trained on them against the
   one trained on its own features (differing nodes); (d) a 13th frame of
   the recipe through kernel B, equal to the plain descent, and the held-out
   accuracy per layer beside the fixture's; (e) ``save_forest`` ->
   ``load_forest`` with equal arrays; (f) a ``BoostedForestTrainer`` on a
   subsample, card equal to CPU (weights, trees, votes). Kernels A and B
   must launch; their launches here are the ``launches_training`` entries;
   before (a), (g) (``split_search_phase``): the exact search's kernels
   (``csrc/split_search.cu``) at ``train_recipe_12img``'s shapes, a shallow
   and a deep level of its forest (K = 20 slots over a 3.47M stream)
   captured from ``learn``: all four results bit-equal to the plain search,
   one search a level, the kernels' time alone, ``_split_search``'s and the
   plain search's, beside the bound;
12. the JAX package's last public functions on the card against the CPU, at
   VGA (a recipe frame): ``normal_angles``, and ``normal_angles_grid`` at
   stride 2 with smoothing sizes 10 and 6.5 (masks equal, angles within
   2.4e-7 rad); ``chamfer_distance_map``, exact and ``iter`` (bit-equal);
   ``resize_bilinear_u8`` from VGA to 11x11, 21x27 and 240x320 (bit-equal,
   and within 1 LSB of ``cv2.resize``, whose SIMD rounding differs; the
   differing bytes are counted); ``StepTimer`` around a CUDA op and, in a
   process of its own (``chip_smoke.py --trace-probe``), ``device_trace``
   around ``normal_angles_grid`` writing a Chrome trace with the three
   normals kernels in it;
13. CRF learning on a synthetic 320x240 image (4 colours, 20% unknown): the
   ``CrfLearner`` value and gradient at its start (logistic unary, two Potts
   terms, 5 iterations, IoU) against the CPU (value within 1e-4 relative,
   gradient within 1e-3 of its largest entry) and bit-equal on a second
   evaluation, one evaluation's ms and device idle share under
   ``torch.profiler``; the DIAG and FULL kernel learners likewise, with
   their lattice rebuilt on the card (gradient within 5e-3 of its largest
   entry); ``cli.dense_learning.run`` on the
   card, each phase not lowering the objective, seconds per phase and per
   evaluation; and at scale 4 on the card and the CPU, histories within
   2e-3.

14. the sharded paths of ``parallel/`` in ``torch.distributed`` worlds of
   processes on the card (``parallel/launch.py``): (a) one rank over nccl:
   the dry run's frame-step probe equal to the single process, the
   point-sharded mean field on a 30000-point map within rtol 2e-4 / atol
   2e-5; (b) 8 ranks sharing the card over gloo (a 2 x 4 data x model mesh):
   whether gloo's ``all_gather`` takes a CUDA tensor, the frame step on 4
   VGA keyframes with the fixture forest (each data rank 2 keyframes, each
   model rank 1 tree; kernels A and B must launch in every rank) within rtol
   1e-6 of the single process's ``run_batch_stacked`` and with labels equal
   except near-ties, the wall ms of both (not a speed-up: 8 processes share
   one card); the points-major, transposed, vertex-sharded and automatic
   mean fields on the map within rtol 2e-4 / atol 2e-5 of
   ``potts_mean_field_multi_t``, the variant chosen and both comm volumes;
   ``LocalMapPipeline(mesh=...).run_device`` on the map's 4 keyframes
   agreeing on >= 99.9% of the labels with the single card's host-lattice
   ``run_device``; the dry run's part 5 (each data rank's streaming share)
   equal to the worker path; (c) ``learn_forest_parallel`` on two slots of
   the card at phase 11(c)'s size, equal to the sequential trainer, and the
   dry run's part 4: the fused forest equal to the tree loop. Its A and
   B launches, summed over the ranks of the frame step, are the
   ``launches_parallel`` entries.
15. retired (it ran the port's first bench harness; ``port_bench/`` is the
   benchmark);
16. the stage profilers of the main path (``scripts/exp_lattice.py``,
   ``exp_filter.py``, ``profile_normals.py``, ``profile_map.py``,
   ``profile_slope.py``) at full size, side by side, each in a process of
   its own with one repeat of its wall slopes (their times are not
   readings): each must exit 0 with a
   summary line whose own checks hold (each stage chain against its
   production call: lattice tables bit-equal, the filter within rtol 2e-4 /
   atol 2e-5, normals' masks equal and angles within 2.4e-7 rad, map and
   frame labels equal; the vertex count within its bucket), on the card,
   with device activities in every timed stage; kernels A, ``pack_lab`` and
   B must have launched in ``profile_slope``'s process (their counts there
   are the ``launches_stage_profilers`` entries). Each stage's wall ms,
   device ms, activities and idle share are printed.

The last lines are the card's name and power limit, one JSON object of
per-kernel results (``launches``: the serving run of phase 4 for A and B,
the entry points of phase 6 for C'' and D''), and ``{"ok": true, "device":
{...}}``. Inputs and weights are made from fixed seeds; nothing here uses
JAX.
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


# Card against CPU for the normal angles: 2 float32 ulps near pi/2 (rad).
NORMAL_TOL = 2.4e-7


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


def time_launch(launch, reps, warmup=2,
                spin_cycles=SPIN_CYCLES_PER_LAUNCH) -> float:
    """Mean device ms per kernel launch. The launches are queued behind a
    spin kernel (``spin_cycles`` a launch), so the CUDA events time the card
    running them back to back and not the host issuing them, which is slower
    than a kernel of a few microseconds."""
    import torch

    for _ in range(warmup):
        launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles * reps)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        usage_permutation_rows,
    )
    from rovinasemanticsegmentation_tpu_torch.ops import forest_cuda
    from rovinasemanticsegmentation_tpu_torch.ops.feature_rows import (
        RowLayout,
        permute_rows,
        unpack_rows,
    )
    from rovinasemanticsegmentation_tpu_torch.ops import forest_staged_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import lattice_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import mean_field_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import normals_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import patches_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import patches_separable_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import resize_argmax_cuda
    from rovinasemanticsegmentation_tpu_torch.ops import split_search_cuda
    from rovinasemanticsegmentation_tpu_torch.ops.patches import (
        extract_patches_plain,
        extract_patches_separable_into_plain,
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
    from rovinasemanticsegmentation_tpu_torch.scripts.bench_dense_inference import (
        make_demo_pair,
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
    from rovinasemanticsegmentation_tpu_torch.utils.profiling import (
        device_busy_ms,
    )
    from rovinasemanticsegmentation_tpu_torch.utils.roofline import (
        PACK_OPS,
        bound,
        descent_bound,
        descent_reads,
        resample_bound,
    )
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
                patches_separable_cuda.launches, normals_cuda.launches,
                mean_field_cuda.launches, lattice_cuda.launches,
                resize_argmax_cuda.launches, split_search_cuda.launches)

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

    # ---- phase 2b: kernel D'' (separable, staged footprint) vs A and plain
    def rows_by(fn, lab, grid, s, row0):
        """``fn``'s packed rows of a frame from ``row0`` in a buffer whose
        other bytes hold 0xAB."""
        buf = torch.full((row0 + grid.numel() + 5, layout.row_bytes), 0xAB,
                         dtype=torch.uint8, device=dev)
        fn(lab, grid, 77, 11, s, buf, row0)
        return buf

    def check_packed_d(lab, grid, s, row0):
        """Kernel D'' into packed rows from ``row0`` == kernel A's rows and
        the separable plain version's, the rows around untouched."""
        got_rows = rows_by(patches_separable_cuda.extract_patches_separable_into,
                           lab, grid, s, row0)
        a_rows = rows_by(patches_cuda.extract_patches_into, lab, grid, s, row0)
        plain_rows = rows_by(extract_patches_separable_into_plain, lab, grid,
                             s, row0)
        torch.cuda.synchronize()
        check(torch.equal(got_rows, a_rows), f"kernel D'' differs from kernel "
              f"A in packed rows from row {row0} at stride {s}")
        check(torch.equal(plain_rows, a_rows), f"the separable plain version "
              f"differs from kernel A in packed rows from row {row0} at "
              f"stride {s}")
        return int((got_rows.int() - plain_rows.int()).abs().max())

    got_d = patches_separable_cuda.extract_patches_separable(
        padded, dgrid, 77, 11, STRIDE
    )
    want_d = extract_patches_separable_plain(padded, dgrid, 77, 11, STRIDE)
    torch.cuda.synchronize()
    check(torch.equal(got_d, got), "kernel D'' differs from kernel A at VGA "
          "stride 2 ([gh, gw, R, R, 3])")
    check(torch.equal(want_d, want), "the separable plain version differs "
          "from extract_patches_plain at VGA stride 2")
    err_d = max(check_packed_d(padded, dgrid, STRIDE, row0)
                for row0 in (0, 3 * p0 + 1))
    rows_d = torch.empty((p0, layout.row_bytes), dtype=torch.uint8,
                         device=dev)
    launch_d, over_cap_d = patches_separable_cuda.launcher(
        padded, dgrid, 77, 11, STRIDE, rows_d, 0)
    launch_d()
    torch.cuda.synchronize()
    blocks_over_cap = int(over_cap_d.item())
    blocks_d = (-(-dgrid.shape[0] // patches_separable_cuda.TILE_ROWS)
                * -(-dgrid.shape[1] // patches_separable_cuda.TILE_COLS))
    ms_d = time_launch(launch_d, 50)
    ms_d363 = time_launch(patches_separable_cuda.launcher(
        padded, dgrid, 77, 11, STRIDE, out363.view(p0, pc), 0)[0], 50)
    wrapper_ms_d = time_cuda(
        lambda: patches_separable_cuda.extract_patches_separable_into(
            padded, dgrid, 77, 11, STRIDE, rows_d, 0), 50
    )
    plain_ms_d = time_cuda(
        lambda: extract_patches_separable_into_plain(
            padded, dgrid, 77, 11, STRIDE, rows_d, 0), 5,
    )
    bound_d = resample_bound(4 * hp * wp, dgrid, pc, layout.row_bytes)
    print(f"phase 2b: kernel D'' == kernel A == both plain versions at VGA "
          f"stride 2, into {pc}-B rows and into {layout.row_bytes}-B packed "
          f"rows from rows 0 and {3 * p0 + 1}; device time alone "
          f"{ms_d363:.4f} / {ms_d:.4f} ms (kernel A {ms_a363:.4f} / "
          f"{ms_a:.4f} ms), wrapper (pack_lab, taps, launch) "
          f"{wrapper_ms_d:.4f} ms; bound {bound_d['bound_ms']:.4f} ms by "
          f"{bound_d['bound_by']}, {bound_d['bound_ms'] / ms_d:.1%} of it; "
          f"{blocks_over_cap} of {blocks_d} blocks over the "
          f"{patches_separable_cuda.FOOTPRINT_CAP}-B footprint cap; separable "
          f"plain {plain_ms_d:.4f} ms ({card})")
    small = make_frames(np.random.default_rng(1), 1, 240, 320)[0]
    for s in (1, 5):
        srgb, sdepth = frame_tensors(*small)
        sp, sd = patch_inputs(srgb, sdepth, cfg, s)
        a = patches_cuda.extract_patches(sp, sd, 77, 11, s)
        b = extract_patches_plain(sp, sd, 77, 11, s)
        d = patches_separable_cuda.extract_patches_separable(sp, sd, 77, 11, s)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"kernel A differs at 240x320 stride {s}")
        check(torch.equal(check_packed_a(sp, sd, s, 7),
                          b.reshape(sd.numel(), pc)),
              f"kernel A's packed rows differ at 240x320 stride {s}")
        print(f"phase 2: kernel A == plain at 240x320 stride {s}, both "
              f"strides")
        check(torch.equal(d, a), f"kernel D'' differs at 240x320 stride {s}")
        for row0 in (0, 7):
            check_packed_d(sp, sd, s, row0)
        print(f"phase 2b: kernel D'' == kernel A at 240x320 stride {s}, as "
              f"the patch tensor and in packed rows from rows 0 and 7")
    results["patches_separable"] = dict(
        max_abs_err=err_d, ms=ms_d, wrapper_ms=wrapper_ms_d, ms_363=ms_d363,
        plain_ms=plain_ms_d, blocks_over_cap=blocks_over_cap,
        blocks=blocks_d, **bound_d
    )

    # ---- phase 2c: the normals kernels vs the plain normals
    results["normals"] = normals_phase(card, dev, frames[0][1], calib)

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

    # ---- phase 3b: kernel C'' on the usage-permuted packed and float rows
    perm_r, remap_r = usage_permutation_rows(forest, layout)
    forest_pr = permute_forest_features(forest, remap_r)
    rows0_p = permute_rows(rows0, layout, perm_r)
    perm, remap = usage_permutation(forest, feats.shape[1])
    forest_p = permute_forest_features(forest, remap)
    feats_p = feats[:, torch.from_numpy(perm).to(dev)].contiguous()
    variants = {  # name: (rows, layout, forest, hot)
        **{f"packed hot {hot}": (rows0_p, layout, forest_pr, hot)
           for hot in (64, 128, pc)},
        "float hot 366": (feats_p.view(torch.uint8), float_layout, forest_p,
                          feats.shape[1]),
    }

    def plain_c(rows_c, lay_c, forest_c):
        return find_leaves_plain(unpack_rows(rows_c, lay_c), forest_c.records,
                                 forest_c.max_depth, forest_c.feat_bits)

    ms_c, wrapper_ms_c, err_c = {}, {}, 0
    for name, (rows_c, lay_c, forest_c, hot) in variants.items():
        want_c = plain_c(rows_c, lay_c, forest_c)
        got_c = forest_staged_cuda.find_leaves_staged_rows(
            rows_c, lay_c, forest_c, hot)
        torch.cuda.synchronize()
        check(torch.equal(want_c, want_leaves), f"the plain descent on the "
              f"permuted {name.split()[0]} rows differs from the unpermuted one")
        check(torch.equal(got_c, leaves),
              f"kernel C'' ({name}) leaf ids differ from kernel B's")
        check(torch.equal(got_c, want_c),
              f"kernel C'' ({name}) leaf ids differ from the plain descent")
        check(torch.equal(sum_leaf_histograms_plain(forest.leaf_hist, got_c),
                          post),
              f"posteriors from kernel C'' ({name}) leaves differ from B's")
        err_c = max(err_c, int((got_c - want_c).abs().max()))
        launch_c, _ = forest_staged_cuda.launcher(rows_c, lay_c, forest_c, hot)
        ms_c[name] = time_launch(launch_c, 50)
        wrapper_ms_c[name] = time_cuda(
            lambda a=(rows_c, lay_c, forest_c, hot):
                forest_staged_cuda.find_leaves_staged_rows(*a), 50
        )
        print(f"phase 3b: kernel C'' ({name}, "
              f"{forest_staged_cuda.TILE_POINTS} points per tile, "
              f"{forest_staged_cuda.stage_row_bytes(lay_c, hot)} B staged per "
              f"row) == B == plain; device time alone {ms_c[name]:.4f} ms, "
              f"wrapper {wrapper_ms_c[name]:.4f} ms ({card})")
    plain_ms_c = time_cuda(lambda: plain_c(rows0_p, layout, forest_pr), 5)
    bound_c = descent_bound(reads0, forest, layout, with_histograms=False)
    bound_cf = descent_bound(reads0, forest, float_layout,
                             with_histograms=False)
    for name, ms in ms_c.items():
        bnd = bound_c if name.startswith("packed") else bound_cf
        print(f"phase 3b: C'' ({name}) bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']} ({bnd['bound_bytes']} B, of them "
              f"{bnd['feature_bytes']} B of features), "
              f"{bnd['bound_ms'] / ms:.1%} of it ({card})")
    print(f"phase 3b: B alone on the frame's packed rows {ms_b1:.4f} ms, "
          f"float rows {ms_b1f:.4f} ms (with its histogram sum); plain "
          f"descent on the permuted packed rows {plain_ms_c:.4f} ms ({card})")
    bound_c.pop("feature_bytes")
    results["forest_descent_staged"] = dict(
        max_abs_err=err_c, ms=ms_c["packed hot 64"],
        wrapper_ms=wrapper_ms_c["packed hot 64"], plain_ms=plain_ms_c,
        ms_by_variant=ms_c, float_bound_ms=bound_cf["bound_ms"], **bound_c
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

    # ---- phase 3d: the resize+argmax kernel vs the plain posterior maps
    results["resize_argmax"] = resize_argmax_phase(card, dev, forest_np,
                                                   frames[0], calib)

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
            "normals": normals_cuda.launches.value,
            "mean_field": mean_field_cuda.launches.value,
            "lattice_build": lattice_cuda.launches.value,
            "resize_argmax": resize_argmax_cuda.launches.value,
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
    check(launches["normals"] == N_KEYFRAMES, f"the normals kernels took "
          f"{launches['normals']} of the {N_KEYFRAMES} keyframes served")
    check(launches["resize_argmax"] == N_KEYFRAMES, f"the resize+argmax kernel "
          f"took {launches['resize_argmax']} of the {N_KEYFRAMES} keyframes "
          "served")
    check(launches["mean_field"] == len(maps), f"the mean-field kernels took "
          f"{launches['mean_field']} of the {len(maps)} maps served")
    check(launches["lattice_build"] == len(maps), f"the lattice-build kernels "
          f"took {launches['lattice_build']} of the {len(maps)} maps served")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched while serving")
        if name in results:
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

    # ---- phase 4b: the mean-field kernels vs the plain mean field
    results["mean_field"] = mean_field_phase(card, dev, frames, maps, calib,
                                             forest_np)
    results["mean_field"]["launches"] = launches["mean_field"]

    # ---- phase 4c: the lattice-build kernels vs the plain build
    results["lattice_build"] = lattice_build_phase(card, dev, maps)
    results["lattice_build"]["launches"] = launches["lattice_build"]

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
        exp_descent.main(["bench", "--rows", rows_kind, "--features", kind,
                          "--reps", "20"])
        for rows_kind, kind in (("packed", "random"), ("packed", "real"),
                                ("float", "real"))
    ]
    runs.append(exp_patches.main(["bench", "--reps", "20"]))
    launches = {
        "forest_descent_staged": forest_staged_cuda.launches.value,
        "patches_separable": patches_separable_cuda.launches.value,
    }
    for res in runs:
        check(res["parity"], f"{res['script']} ({res.get('rows', '')} "
              f"{res.get('features', '')}) reports no parity")
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
    stages = {}
    for name in stage_names:
        r = windows[name]
        inside = [e for e in device if r.start <= e.time_range.start < r.end]
        stages[name] = (sum(e.time_range.elapsed_us() for e in inside) / 1000,
                        len(inside))
    busy_ms = device_busy_ms(device)
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
                 "forest_descent": forest_cuda.launches.value,
                 "normals": normals_cuda.launches.value,
                 "lattice_build": lattice_cuda.launches.value,
                 "resize_argmax": resize_argmax_cuda.launches.value}
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
    check(launches8["normals"] == b, f"the normals kernels took "
          f"{launches8['normals']} of the streaming step's {b} keyframes")
    check(launches8["resize_argmax"] == b, f"the resize+argmax kernel took "
          f"{launches8['resize_argmax']} of the streaming step's {b} keyframes")
    check(launches8["lattice_build"] == n_maps, f"the lattice-build kernels "
          f"took {launches8['lattice_build']} of the streaming step's {n_maps} "
          "CRF maps")

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
    # The timing script, once, in a process of its own.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "rovinasemanticsegmentation_tpu_torch.scripts.bench_dense_inference",
         "--reps", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "scripts/bench_dense_inference.py exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(line["golden"] == "skipped" and line["device"]["platform"] == "gpu"
          and set(line["profile"]) == {"device", "host"} and "value" in line,
          f"scripts/bench_dense_inference.py printed {line}")
    print(f"phase 10: scripts/bench_dense_inference.py --reps 1 in "
          f"{time.perf_counter() - t0:.3f} s: warm ms per image "
          + "; ".join(f"{b} build " + ", ".join(
              f"{r['warm_ms']:.3f}" for r in line["per_image"][b].values())
              for b in ("device", "host"))
          + "; one image profiled: " + "; ".join(
              f"{b} build {p['profiled_wall_ms']:.3f} ms wall, device busy "
              f"{p['device_busy_ms']:.3f} ms, {p['device_activities']} "
              f"activities" for b, p in line["profile"].items())
          + f" ({card})")

    # ---- phase 11: forest training on the card
    results["split_search"] = split_search_phase(card, dev)
    for name, k in training_phase(card, dev, reset_counts).items():
        results[name]["launches_training"] = k

    # ---- phases 12 and 13: the public functions and CRF learning
    t0 = time.perf_counter()
    public_functions_phase(card, dev)
    crf_learning_phase(card, dev)
    print(f"phases 12-13: {time.perf_counter() - t0:.3f} s ({card})")

    # ---- phase 14: the sharded paths in torch.distributed worlds
    launches14 = parallel_phase(card, dev, frames, calib, forest_np, maps[0],
                                projector)
    for name, k in launches14.items():
        results[name]["launches_parallel"] = k

    # ---- phase 16: the stage profilers of the main path
    for name, k in stage_profilers_phase(card).items():
        results[name]["launches_stage_profilers"] = k

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
                "name": "patches_separable",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "patches_separable.cu",
                "replaces": "scripts/exp_patches.py:49",
                "library_ms": None,
                **results["patches_separable"],
            },
            {
                "name": "normals",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "normals.cu",
                "replaces": None,  # XLA ops in the JAX package: no kernel
                "library_ms": None,
                **results["normals"],
            },
            {
                "name": "mean_field",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "mean_field.cu",
                "replaces": None,  # XLA ops in the JAX package: no kernel
                "library_ms": None,
                **results["mean_field"],
            },
            {
                "name": "lattice_build",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "lattice_build.cu",
                "replaces": None,  # XLA ops in the JAX package: no kernel
                "library_ms": None,
                **results["lattice_build"],
            },
            {
                "name": "resize_argmax",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "resize_argmax.cu",
                "replaces": None,  # XLA ops in the JAX package: no kernel
                "library_ms": None,
                **results["resize_argmax"],
            },
            {
                "name": "split_search",
                "route": "cuda",
                "source": "rovinasemanticsegmentation_tpu_torch/csrc/"
                          "split_search.cu",
                "replaces": None,  # XLA ops in the JAX package: no kernel
                "library_ms": None,
                **results["split_search"],
            },
        ],
    }


def normals_phase(card: str, dev, depth, calib) -> dict:
    """Phase 2c: the normals kernels against the plain normals on the card.
    -> the kernels' numbers at VGA, stride 2, size 10 (the frame path's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rovinasemanticsegmentation_tpu_torch.ops import normals, normals_cuda
    from rovinasemanticsegmentation_tpu_torch.ops.geometry import backproject
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        make_bench_forest as recipe,
    )

    def points_of(depth_mm):
        return backproject(torch.from_numpy(depth_mm.astype(np.int32)).to(dev),
                           calib.intrinsic_inverse, np.eye(3), np.zeros(3),
                           0.5, 15.0)

    def compare(points, stride, size, name):
        launch, got, integ, dist = normals_cuda.launcher(points, stride, 0.02,
                                                         size)
        before = normals_cuda.launches.value
        launch()
        torch.cuda.synchronize()
        check(normals_cuda.launches.value == before + 1,
              f"normals kernels ({name}): the frame was not counted once")
        want = normals._normal_angles(points, stride, 0.02, size)
        change = normals._depth_change_map(points[..., 2], 0.02)
        check(torch.equal(integ, normals._gradient_integral(points)[:, 1:, 1:]),
              f"normals kernels ({name}): the integral image differs")
        check(torch.equal(dist, normals.chamfer_distance_map(
            change, saturation=size)[::stride, ::stride]),
              f"normals kernels ({name}): the grid distance differs")
        check(torch.equal(got, want),
              f"normals kernels ({name}): the angles differ from the plain "
              "version's")
        print(f"phase 2c: normals kernels == plain on {name}, stride {stride}, "
              f"size {size:g}: {int((want != -2.0).sum())} valid of "
              f"{want.numel()} grid points, angles, integral image and grid "
              f"distance bit-equal")

    bench_points = points_of(depth)
    compare(bench_points, STRIDE, 10.0, "phase 2's frame")
    compare(bench_points, 5, 10.0, "phase 2's frame")
    _, recipe_depth, _ = next(recipe.frames())
    recipe_points = points_of(recipe_depth)
    for size in (10.0, 7.0, 4.0):
        compare(recipe_points, STRIDE, size, "a recipe frame")

    launch, _, _, _ = normals_cuda.launcher(bench_points, STRIDE, 0.02, 10.0)
    ms = time_launch(launch, 50)
    wrapper_ms = time_cuda(
        lambda: normals_cuda.normal_angles_grid(bench_points, STRIDE), 50)
    plain_ms = time_cuda(
        lambda: normals._normal_angles(bench_points, STRIDE, 0.02, 10.0), 10)
    reps = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        for name in ("normals_prepare_kernel", "normals_row_scan_kernel",
                     "normals_angle_kernel"):
            if e.device_type.name != "CPU" and name in e.name:
                per_kernel[name] = (per_kernel.get(name, 0.0)
                                    + e.time_range.elapsed_us() / 1000 / reps)
    check(len(per_kernel) == 3, f"normals kernels in the profile: {per_kernel}")
    # The bound: port_bench/roofline.py's "normals" stage (200 flops a pixel,
    # 60 a grid point at 67 TFLOP/s; depth read, angles written), and the
    # float64 integral image written and read once at 3.35 TB/s.
    hw = depth.size
    p = -(-depth.shape[0] // STRIDE) * -(-depth.shape[1] // STRIDE)
    stage_ms = 1e3 * max((2 * hw + 4 * p) / 3.35e12,
                         (200 * hw + 60 * p) / 67e12)
    integral_bytes = 8 * normals_cuda.CHANNELS * hw
    floor_ms = 1e3 * 2 * integral_bytes / 3.35e12
    bound_ms = max(stage_ms, floor_ms)
    kernels = ", ".join(f"{k} {v:.4f} ms" for k, v in per_kernel.items())
    print(f"phase 2c: normals kernels at VGA stride 2, size 10: device time "
          f"alone {ms:.4f} ms for the 3 launches ({kernels}); wrapper "
          f"{wrapper_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by the integral image's {integral_bytes} B "
          f"written and read once (the stage's operations {stage_ms:.4f} ms), "
          f"{bound_ms / ms:.1%} of it ({card})")
    return dict(max_abs_err=0, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                per_kernel_ms=per_kernel, bound_ms=bound_ms,
                bound_by="bytes" if floor_ms >= stage_ms else "operations",
                bound_bytes=2 * integral_bytes, stage_bound_ms=stage_ms)


def resize_argmax_phase(card: str, dev, forest_np, frame, calib) -> dict:
    """Phase 3d: the resize+argmax kernel against the plain posterior maps on
    the card, on the fixture forest's posteriors of one VGA keyframe. -> the
    kernel's numbers at VGA, stride 2 (the frame path's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rovinasemanticsegmentation_tpu_torch.features.extractor import (
        FeatureConfig,
    )
    from rovinasemanticsegmentation_tpu_torch.ops import resize_argmax_cuda
    from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
        SingleFramePipeline,
        posterior_maps_plain,
    )
    from rovinasemanticsegmentation_tpu_torch.utils.roofline import bound

    rgb, depth = frame
    pipe = SingleFramePipeline(FeatureConfig(), forest_np, STRIDE, dev)
    post, masks = pipe.stacked_posteriors(
        rgb[None], depth[None], np.asarray(calib.intrinsic_inverse)[None],
        np.eye(3)[None], np.zeros((1, 3)))
    h, w = depth.shape
    args = (post, masks[0], pipe.grid_shape(h, w), pipe.class_counts)
    for fill in (-1000.0, 0.0):
        launch, got_post, got_lbl = resize_argmax_cuda.launcher(*args, fill,
                                                                h, w)
        before = resize_argmax_cuda.launches.value
        launch()
        torch.cuda.synchronize()
        check(resize_argmax_cuda.launches.value == before + 1,
              "resize+argmax kernel: the frame was not counted once")
        want_post, want_lbl = posterior_maps_plain(*args, fill, h, w)
        for li, (a, b) in enumerate(zip(got_post, want_post)):
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"resize+argmax kernel (fill {fill:g}): layer {li}'s "
                  "posteriors differ from the plain version's")
        for li, (a, b) in enumerate(zip(got_lbl, want_lbl)):
            check(torch.equal(a, b), f"resize+argmax kernel (fill {fill:g}): "
                  f"layer {li}'s labels differ from the plain version's")
        print(f"phase 3d: resize+argmax kernel == plain at VGA stride 2, fill "
              f"{fill:g}: both layers' posteriors and labels bit-equal "
              f"({int((want_lbl[1] >= 0).sum())} of {h * w} pixels voted)")

    launch, _, _ = resize_argmax_cuda.launcher(*args, -1000.0, h, w)
    ms = time_launch(launch, 50)
    wrapper_ms = time_cuda(
        lambda: resize_argmax_cuda.posterior_maps(*args, -1000.0, h, w), 50)
    plain_ms = time_cuda(lambda: posterior_maps_plain(*args, -1000.0, h, w), 20)

    def device_events(fn, lead_cycles, reps=10):
        """The device activities of ``reps`` calls of ``fn`` in a profiler
        window, but for the spin kernel of ``lead_cycles`` card cycles queued
        ahead of them, and the kernel's launch count over the same calls."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if lead_cycles:
                torch.cuda._sleep(lead_cycles)
            before = resize_argmax_cuda.launches.value
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counted = resize_argmax_cuda.launches.value - before
        return ([e for e in prof.events() if e.device_type.name != "CPU"
                 and "spin" not in e.name.lower()], counted)

    # Late in this process, a profiler window has lost the device records of
    # its first launches (7 and 9 of 10 kernels, 1118 of 1120 plain
    # activities recorded), though a window in a fresh process records them
    # all. So the launches are queued behind ~5 ms of spin, clear of the
    # window's start, and the kernel's activities must equal its count; the
    # count without the spin is printed beside it.
    lead = 10_000_000
    plain, _ = device_events(
        lambda: posterior_maps_plain(*args, -1000.0, h, w), lead)
    plain_acts = len(plain) / 10
    plain_dev_ms = sum(e.time_range.elapsed_us() for e in plain) / 1000 / 10
    unled, unled_counted = device_events(launch, 0)
    kernel, counted = device_events(launch, lead)
    names = {e.name for e in kernel}
    check(counted == 10 and len(kernel) == counted
          and all("resize_argmax_kernel" in n for n in names),
          f"resize+argmax launches: {len(kernel)} device activities "
          f"{sorted(names)} for {counted} counted launches")
    print(f"phase 3d: resize+argmax kernel in a profiler window: {len(kernel)} "
          f"device activities for {counted} counted launches behind the spin, "
          f"{len(unled)} for {unled_counted} without it")
    kernel_dev_ms = (sum(e.time_range.elapsed_us() for e in kernel) / 1000
                     / len(kernel))
    # The bound: the class values of the stride posteriors that the kernel
    # reads (not the rows' padding) and the mask read once, the
    # full-resolution posteriors and the label planes written once; ~9 float
    # operations a written value.
    classes = sum(pipe.class_counts)
    values = classes * h * w
    grid = masks[0].numel()
    nbytes = (4 * grid * classes + grid + 4 * values
              + len(pipe.class_counts) * h * w)
    bnd = bound(nbytes, {"fma": 9}, values)
    print(f"phase 3d: resize+argmax kernel at VGA stride 2: device time alone "
          f"{ms:.4f} ms ({kernel_dev_ms:.4f} ms in a profile); wrapper "
          f"{wrapper_ms:.4f} ms; plain {plain_ms:.4f} ms, {plain_dev_ms:.4f} "
          f"device ms in {plain_acts:g} activities; bound "
          f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} ({nbytes} B), "
          f"{bnd['bound_ms'] / ms:.1%} of it ({card})")
    return dict(max_abs_err=0, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                plain_device_ms=plain_dev_ms, plain_activities=plain_acts,
                profiled_ms=kernel_dev_ms, **bnd)


def mean_field_phase(card: str, dev, frames, maps, calib, forest_np) -> dict:
    """Phase 4b: the mean-field kernels against the plain mean field on
    phase 4's maps, with their real fused unaries. -> the kernels' numbers
    on map 0 (30000 points, the map path's bucket)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench.roofline import map_stages
    from rovinasemanticsegmentation_tpu_torch.features.extractor import (
        FeatureConfig,
    )
    from rovinasemanticsegmentation_tpu_torch.fusion.projector import (
        MultiProjector,
    )
    from rovinasemanticsegmentation_tpu_torch.models import crf
    from rovinasemanticsegmentation_tpu_torch.models.lattice import (
        build_lattice_device,
        lattice_filter_t,
    )
    from rovinasemanticsegmentation_tpu_torch.ops import mean_field_cuda
    from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
        CrfParams,
        LocalMapPipeline,
        MapNodeFrames,
        _floor_labels,
        crf_feats,
        crf_labels_multi,
    )
    from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
        SingleFramePipeline,
    )

    blocks, unknown, weight, iterations = (8, 9), (7, 8), 10.0, 10
    fp = SingleFramePipeline(FeatureConfig(), forest_np, STRIDE, "cuda",
                             fill_value=0.0)
    projector = MultiProjector.from_calibrations([calib], H, W, min_distance=0.5)
    mp = LocalMapPipeline(projector, list(blocks), list(unknown), "cuda",
                          crf=CrfParams(use_dense_crf=True))
    bucket = mp._m_bucket

    def labels_of(q):
        return [_floor_labels(ql, c, unk) for ql, c, unk
                in zip(torch.split(q, list(blocks)), blocks, unknown)]

    inputs = []
    for k, (pts, cols) in enumerate(maps):
        keys = range(k * MAP_EVERY, (k + 1) * MAP_EVERY)
        batch = fp.run_batch([frames[f][0] for f in keys],
                             [frames[f][1] for f in keys], [calib] * MAP_EVERY)
        nodes = [MapNodeFrames(pose=pose_of(f), posteriors=[r.posteriors])
                 for f, r in zip(keys, batch)]
        pts_t = torch.from_numpy(pts).to(dev)
        cols_t = torch.from_numpy(cols).to(dev)
        fused = torch.cat(mp.fuse_unaries(pts_t, nodes), dim=1)
        *lattice, m = build_lattice_device(
            crf_feats(pts_t, cols_t, 0.5, 4.0), bucket)
        m = int(m)
        check(m <= bucket, f"map {k}: {m} vertices overflow the bucket")
        ones = fused.new_ones((1, fused.shape[0]))
        norm = 1.0 / torch.sqrt(lattice_filter_t(ones, *lattice, bucket)[0]
                                + 1e-20)
        got_norm = mean_field_cuda.symmetric_norm(*lattice, bucket)
        norm_err = float(((got_norm - norm).abs() / norm).max())
        check(norm_err <= 1e-6, f"map {k}: the kernels' normalisation is "
              f"{norm_err:.3g} off the plain one")
        args = (-fused.T, *lattice, norm, weight, blocks, bucket, iterations)
        before = mean_field_cuda.launches.value
        got = mean_field_cuda.potts_mean_field_multi_t(*args)
        again = mean_field_cuda.potts_mean_field_multi_t(*args)
        torch.cuda.synchronize()
        check(mean_field_cuda.launches.value == before + 2,
              f"map {k}: the mean-field kernels were not counted once a call")
        want = crf.potts_mean_field_multi_plain_t(*args)
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"map {k}: the marginals differ by {err:.3g}")
        check(torch.equal(got, again), f"map {k}: two runs of the kernels "
              "differ")
        for li, (a, b) in enumerate(zip(labels_of(got), labels_of(want))):
            check(torch.equal(a, b), f"map {k}, layer {li}: "
                  f"{int((a != b).sum())} labels differ")
        served = crf_labels_multi(fused, lattice, weight, blocks, bucket,
                                  iterations, unknown)
        for a, b in zip(served, labels_of(want)):
            check(torch.equal(a, b), f"map {k}: crf_labels_multi's labels "
                  "differ from the plain mean field's")
        print(f"phase 4b: map {k}: mean-field kernels == plain within "
              f"{err:.3g} ({m} vertices, bucket {bucket}): labels equal, two "
              f"runs bit-equal, normalisation within {norm_err:.3g} relative")
        inputs.append((fused, lattice, args))

    fused, lattice, args = inputs[0]
    launch, _ = mean_field_cuda.launcher(*args)
    launches_per_call = 1 + (2 + lattice[5].shape[0]) * iterations
    # ~4 us of host issue a kernel through the C entry point, spun over
    ms = time_launch(launch, 50, spin_cycles=8000 * launches_per_call)
    wrapper_ms = time_cuda(
        lambda: crf_labels_multi(fused, lattice, weight, blocks, bucket,
                                 iterations, unknown), 50)
    plain_ms = time_cuda(lambda: crf.potts_mean_field_multi_plain_t(*args), 10)

    def profiled(fn, reps=5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type.name != "CPU"]
        per_kernel = {}
        for e in device:
            for name in ("mf_splat_kernel", "mf_blur_kernel", "mf_slice_kernel"):
                if name in e.name:
                    per_kernel[name] = (per_kernel.get(name, 0.0)
                                        + e.time_range.elapsed_us() / 1000 / reps)
        return (sum(e.time_range.elapsed_us() for e in device) / 1000 / reps,
                len(device) / reps, per_kernel)

    dev_ms, acts, per_kernel = profiled(launch)
    norm_ms, norm_acts, _ = profiled(
        lambda: mean_field_cuda.symmetric_norm(*lattice, bucket))
    check(len(per_kernel) == 3, f"mean-field kernels in the profile: "
          f"{per_kernel}")
    plain_dev_ms, plain_acts, _ = profiled(
        lambda: crf.potts_mean_field_multi_plain_t(*args), 2)
    map_dev_ms, map_acts, _ = profiled(
        lambda: crf_labels_multi(fused, lattice, weight, blocks, bucket,
                                 iterations, unknown))
    n = fused.shape[0]
    bound_ms = 1e3 * sum(s for name, s in map_stages(
        n, MAP_EVERY, sum(blocks), lattice[5].shape[0] - 1, bucket, iterations)
        if name.startswith("mean_field_"))
    kernels = ", ".join(f"{k} {v:.4f} ms" for k, v in per_kernel.items())
    print(f"phase 4b: mean-field kernels on map 0 ({n} points, {iterations} "
          f"iterations): device time alone {ms:.4f} ms for "
          f"{launches_per_call} launches ({kernels} in a profile: "
          f"{dev_ms:.4f} ms in {acts:.0f} activities); normalisation "
          f"{norm_ms:.4f} device ms in {norm_acts:.0f} activities; "
          f"crf_labels_multi {wrapper_ms:.4f} ms a call, "
          f"{map_dev_ms:.4f} device ms in {map_acts:.0f} activities; plain "
          f"{plain_ms:.4f} ms a call, {plain_dev_ms:.4f} device ms in "
          f"{plain_acts:.0f} activities; bound (port_bench/roofline.py's "
          f"mean_field stages) {bound_ms:.4f} ms, {bound_ms / ms:.2%} of it; "
          f"mean_field_cuda.launches {mean_field_cuda.launches.value} "
          f"({card})")
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, per_kernel_ms=per_kernel,
                norm_device_ms=norm_ms, device_ms=dev_ms, activities=acts,
                plain_device_ms=plain_dev_ms, plain_activities=plain_acts,
                bound_ms=bound_ms, bound_by="bytes")


LATTICE_KERNELS = ("lb_embed_insert", "lb_key_tiles", "lb_merge",
                   "lb_key_ranks", "lb_row_ranks", "lb_radix_pass", "lb_finish")


def lattice_build_phase(card: str, dev, maps) -> dict:
    """Phase 4c: the lattice-build kernels against the plain PyTorch build
    on phase 4's map 0 (30000 points, d = 6, the map path's 16384 slots):
    all twelve results bit-equal to the plain build on the card and on the
    CPU, one count a build; the kernels' device time alone (CUDA events, 50
    builds), a ``build_lattice_device`` call's, from profiler windows each
    kernel's time and the activities a build, the plain build's time and
    activities, and ``port_bench/roofline.py``'s ``lattice_build`` bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench.roofline import map_stages
    from rovinasemanticsegmentation_tpu_torch.models import lattice as L
    from rovinasemanticsegmentation_tpu_torch.ops import lattice_cuda
    from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
        crf_feats,
    )

    bucket = 1 << 14
    names = ("sorted_points", "sorted_weights", "seg_starts", "seg_ends",
             "offsets_t", "barycentric_t", "blur_n1", "blur_n2", "m",
             "pos_sorted", "rem0", "rank")
    pts, cols = maps[0]
    feats = crf_feats(torch.from_numpy(pts).to(dev),
                      torch.from_numpy(cols).to(dev), 0.5, 4.0)
    n, d = feats.shape
    scale = L._embedding_scale(d).astype(np.float32)
    before = lattice_cuda.launches.value
    got = L._build_device(feats, bucket)
    torch.cuda.synchronize()
    check(lattice_cuda.launches.value == before + 1,
          "lattice-build kernels: the build was not counted once")
    plain = L._build_device_plain(feats, bucket)
    cpu = L._build_device_plain(feats.cpu(), bucket)
    for name, g, p, c in zip(names, got, plain, cpu):
        check(g.dtype == p.dtype and g.shape == p.shape and torch.equal(g, p),
              f"lattice-build kernels: {name} differs from the plain build's "
              "on the card")
        check(torch.equal(g.cpu(), c), f"lattice-build kernels: {name} "
              "differs from the plain build's on the CPU")
    m = int(got[8])
    check(m <= bucket, f"map 0: {m} vertices overflow the bucket {bucket}")

    def launch():
        lattice_cuda.build(feats, bucket, scale)

    # ~100 us of host a build (allocations and the C call's launches)
    ms = time_launch(launch, 50, spin_cycles=400_000)
    wrapper_ms = time_cuda(lambda: L.build_lattice_device(feats, bucket), 50)
    plain_ms = time_cuda(lambda: L._build_device_plain(feats, bucket), 10)

    def profiled(fn, reps=5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type.name != "CPU"]
        per_kernel = {}
        for e in device:
            for name in LATTICE_KERNELS:
                if name in e.name:
                    per_kernel[name] = (per_kernel.get(name, 0.0)
                                        + e.time_range.elapsed_us() / 1000 / reps)
        return (sum(e.time_range.elapsed_us() for e in device) / 1000 / reps,
                len(device) / reps, per_kernel)

    dev_ms, acts, per_kernel = profiled(launch)
    check(set(per_kernel) == set(LATTICE_KERNELS),
          f"lattice-build kernels in the profile: {sorted(per_kernel)}")
    plain_dev_ms, plain_acts, _ = profiled(
        lambda: L._build_device_plain(feats, bucket), 2)
    bound_ms = 1e3 * dict(map_stages(n, MAP_EVERY, 17, d, bucket, 10))[
        "lattice_build"]
    kernels = ", ".join(f"{k} {v:.4f} ms" for k, v in per_kernel.items())
    print(f"phase 4c: lattice-build kernels == plain build on the card and "
          f"the CPU, all 12 results ({n} points, d = {d}, {m} vertices, "
          f"bucket {bucket}); device time alone {ms:.4f} ms a build "
          f"({kernels} in a profile: {dev_ms:.4f} ms in {acts:.0f} "
          f"activities); build_lattice_device {wrapper_ms:.4f} ms a call; "
          f"plain {plain_ms:.4f} ms a call, {plain_dev_ms:.4f} device ms in "
          f"{plain_acts:.0f} activities; bound (port_bench/roofline.py's "
          f"lattice_build) {bound_ms:.6f} ms, {bound_ms / ms:.3%} of it; "
          f"lattice_cuda.launches {lattice_cuda.launches.value} ({card})")
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                per_kernel_ms=per_kernel, device_ms=dev_ms, activities=acts,
                plain_device_ms=plain_dev_ms, plain_activities=plain_acts,
                bound_ms=bound_ms, bound_by="bytes")


# Levels of train_recipe_12img's forest whose searches phase 11(g) times: a
# shallow one (4 nodes a tree) and a deep one (the frontier near its widest).
SPLIT_LEVELS = (2, 14)
SPLIT_SEED = 3_000_000_019
SPLIT_KERNELS = ("ss_stage", "ss_tile_counts", "ss_tile_scan", "ss_heads",
                 "ss_search", "ss_finish")


def split_search_phase(card: str, dev) -> dict:
    """Phase 11(g): the exact split search's kernels at the benchmark's
    training shapes: the levels of ``train_recipe_12img``'s forest (12 VGA
    images x 6 variants at stride 5, 4 trees: K = 20 slots over a ~3.47M
    stream), captured from ``learn`` on the card. At :data:`SPLIT_LEVELS`:
    the kernels against the plain search on the same sorted stream, all
    four results bit for bit, one count a search; the kernels' device time
    alone (CUDA events, 20 searches), ``_split_search`` a call (the sort
    and the kernels), the plain search after the same sort; each kernel's
    time and the sort's in a profiler window; the bound by
    ``utils/roofline.py``'s rule. -> the deep level's numbers, the shallow
    one's under ``shallow``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench import harness
    from port_bench.drivers import train as driver
    from rovinasemanticsegmentation_tpu_torch.ops import split_search_cuda
    from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T
    from rovinasemanticsegmentation_tpu_torch.utils.profiling import counter
    from rovinasemanticsegmentation_tpu_torch.utils.roofline import (
        split_search_bound,
    )

    cell = driver.Cell(harness.load_spec("train_recipe_12img"), SPLIT_SEED,
                       "cuda")
    x, y, _ = cell.last
    captured, shapes = {}, []
    search = T._split_search

    def capture(vals, seg, cls, cw, f, c, weighted=None):
        level = len(shapes)
        shapes.append((f, int((seg < f).sum())))
        if level in SPLIT_LEVELS:
            captured[level] = (vals.clone(), seg.clone(), cls.clone(), cw, f,
                               c, weighted)
        return search(vals, seg, cls, cw, f, c, weighted)

    levels = counter("train.levels")
    before = (levels.value, split_search_cuda.launches.value)
    T._split_search = capture
    try:
        cell.learn(x, y)
    finally:
        T._split_search = search
    torch.cuda.synchronize()
    check(levels.value - before[0] == split_search_cuda.launches.value - before[1]
          == len(shapes), "split search: not one kernel search a level")
    print(f"phase 11(g): train_recipe_12img's forest ({len(x)} rows, seed "
          f"{SPLIT_SEED}): {len(shapes)} levels, one search each; (frontier "
          f"nodes, searched stream entries) a level: {shapes}")

    def profiled(fn, reps=3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type.name != "CPU"]
        per = {}
        for e in device:
            name = next((k for k in SPLIT_KERNELS if k in e.name),
                        "sort" if "Sort" in e.name else None)
            if name is not None:
                per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        return sum(e.time_range.elapsed_us() for e in device) / 1e3 / reps, per

    out = {}
    for level in SPLIT_LEVELS:
        vals, seg, cls, cw, f, c, wm = captured[level]
        k, ns = vals.shape
        key = (seg << 32)[None, :] + T._float_order(vals)
        sk, order = torch.sort(key, dim=1)
        table = T._log2_table(ns, dev)
        args = (sk, order, vals, seg, cls, cw, wm, f, c, table)
        n0 = split_search_cuda.launches.value
        got = split_search_cuda.search(*args)
        want = T._split_search_plain(sk, order, vals, seg, cls, cw, f, c, wm)
        torch.cuda.synchronize()
        check(split_search_cuda.launches.value == n0 + 1,
              "split search: a search was not counted once")
        for name, g, w in zip(("objective", "threshold", "left mass",
                               "right mass"), got, want):
            check(torch.equal(g.view(torch.int32),
                              w.to(torch.float32).view(torch.int32)),
                  f"split search at level {level}: the kernels' {name} "
                  "differs from the plain search's")
        sseg = sk >> 32
        sv = torch.gather(vals, 1, order)
        pv = torch.cat([sv[:, :1], sv[:, :-1]], 1)
        ps = torch.cat([torch.full_like(sseg[:, :1], -1), sseg[:, :-1]], 1)
        active = int((sseg[0] < f).sum())
        valid = int(((sseg < f) & (sseg == ps) & (sv - pv >= 1e-6)).sum())
        # ~60 us of host a search (the allocations and 6 launches)
        ms = time_launch(lambda: split_search_cuda.search(*args), 20,
                         spin_cycles=400_000)
        call_ms = time_cuda(lambda: T._split_search(vals, seg, cls, cw, f, c,
                                                    wm), 10)
        plain_ms = time_cuda(lambda: T._split_search_plain(
            sk, order, vals, seg, cls, cw, f, c, wm), 3, warmup=1)
        dev_ms, per = profiled(lambda: T._split_search(vals, seg, cls, cw, f,
                                                       c, wm))
        check(set(SPLIT_KERNELS) <= set(per),
              f"split-search kernels in the profile: {sorted(per)}")
        bnd = split_search_bound(k, ns, active, valid, f, c)
        kernels = ", ".join(f"{n} {v:.4f}" for n, v in per.items())
        print(f"phase 11(g): level {level} (K {k}, Ns {ns}, {f} frontier "
              f"nodes, {active} searched entries, {valid} valid candidates, "
              f"C {c}): kernels == plain search, all 4 results; device time "
              f"alone {ms:.4f} ms a search; _split_search (sort + kernels) "
              f"{call_ms:.4f} ms a call, {dev_ms:.4f} device ms in a profile "
              f"({kernels} ms); plain after the sort {plain_ms:.4f} ms; bound "
              f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
              f"({bnd['bound_bytes']} B), {bnd['bound_ms'] / ms:.2%} of it "
              f"({card})")
        res = dict(level=level, k=k, ns=ns, segments=f, active=active,
                   valid=valid, ms=ms, wrapper_ms=call_ms, plain_ms=plain_ms,
                   device_ms=dev_ms, per_kernel_ms=per, **bnd)
        out = res if not out else dict(res, shallow=out)
    return out


def training_phase(card: str, dev, reset_counts) -> dict:
    """Phase 11: forest training on the card, the fixture forest's recipe
    (``scripts/make_bench_forest.py``). -> launches of kernels A (with its
    Lab pack) and B on this path, by kernel name."""
    import torch

    from rovinasemanticsegmentation_tpu_torch.features.extractor import (
        FeatureConfig,
        patch_inputs,
    )
    from rovinasemanticsegmentation_tpu_torch.models.forest import (
        build_forest,
        forest_from_numpy,
        load_forest,
        save_forest,
    )
    from rovinasemanticsegmentation_tpu_torch.ops import (
        forest_cuda,
        patches_cuda,
        split_search_cuda,
    )
    from rovinasemanticsegmentation_tpu_torch.ops.patches import (
        extract_patches_plain,
    )
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        make_bench_forest as recipe,
    )
    from rovinasemanticsegmentation_tpu_torch.train import compare
    from rovinasemanticsegmentation_tpu_torch.train.boosting import (
        BoostedForestTrainer,
    )
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        ForestTrainer,
    )

    counts = list(recipe.CLASS_COUNTS)
    gen = recipe.frames()
    frames = [next(gen) for _ in range(recipe.FRAMES + 1)]  # the 13th held out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def timed_peak(fn):
        """-> (result, wall s, peak allocated MB)."""
        torch.cuda.reset_peak_memory_stats()
        out, s = timed(fn)
        return out, s, torch.cuda.max_memory_allocated() / 2**20

    def tree_loop(cfg):
        """The forest grown one tree after another (``grow_tree``)."""
        trainer = ForestTrainer(cfg, dev)
        data = trainer.prepare(x, y, class_counts=counts)
        return build_forest([trainer.grow_tree(data, t)
                             for t in range(cfg.num_trees)],
                            counts, multi_label=data.multi_label)

    def shape(f):
        return f"nodes per tree {f.node_counts}, deepest leaf {f.max_depth}"

    def same_forest(a, b):
        return (a.node_counts == b.node_counts and a.max_depth == b.max_depth
                and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
                    "split_feature", "threshold", "left_child", "leaf_hist")))

    # Kernel A at this path's shape (a VGA frame at the training stride)
    # against its plain version, before the counts are set to 0.
    fcfg = FeatureConfig()
    rgb0, depth0, _ = frames[0]
    padded, dgrid = patch_inputs(
        torch.from_numpy(rgb0).to(dev),
        torch.from_numpy(depth0.astype(np.int32)).to(dev), fcfg,
        recipe.TRAIN_STRIDE)
    got = patches_cuda.extract_patches(padded, dgrid, fcfg.patch_size,
                                       fcfg.patch_size_reduce,
                                       recipe.TRAIN_STRIDE)
    want = extract_patches_plain(padded, dgrid, fcfg.patch_size,
                                 fcfg.patch_size_reduce, recipe.TRAIN_STRIDE)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "kernel A differs from its plain version "
          f"at VGA stride {recipe.TRAIN_STRIDE}")
    print(f"phase 11: kernel A == plain on a recipe frame at VGA stride "
          f"{recipe.TRAIN_STRIDE} ({tuple(dgrid.shape)} grid)")

    reset_counts()
    # (a) the recipe: extraction through kernel A, exact search, device growth
    (x, y), extract_s = timed(lambda: recipe.extract(frames[:recipe.FRAMES], dev))
    n = len(x)
    print(f"phase 11(a): extracted {n} labelled samples x {x.shape[1]} "
          f"features from {recipe.FRAMES} VGA frames at stride "
          f"{recipe.TRAIN_STRIDE} in {extract_s:.3f} s ({card})")
    forests = {}
    for part, mode, kw in (("a", "exact", {}), ("b", "binned", {"split_bins": 256})):
        cfg = recipe.trainer_config(**kw)
        runs = []
        for _ in range(2):
            runs.append(timed_peak(lambda: ForestTrainer(cfg, dev).learn(
                x, y, class_counts=counts, progress=False)))
        check(same_forest(runs[0][0], runs[1][0]),
              f"two {mode} trainings on the card grew different forests")
        loop, loop_s, loop_mb = timed_peak(lambda: tree_loop(cfg))
        check(same_forest(loop, runs[0][0]),
              f"the fused {mode} forest differs from the tree loop's")
        forests[mode] = runs[0][0]
        print(f"phase 11({part}): {mode} search, 4 trees, depth <= 30, all "
              f"in one level loop: {runs[0][1]:.3f} s (peak {runs[0][2]:.1f} "
              f"MB allocated), again {runs[1][1]:.3f} s ({runs[1][2]:.1f} MB; "
              f"the same forest); {n / runs[1][1]:.0f} samples/s; "
              f"{shape(runs[0][0])} ({card})")
        print(f"phase 11({part}): the tree loop (grow_tree per tree) grew the "
              f"same forest bit for bit in {loop_s:.3f} s (peak {loop_mb:.1f} "
              f"MB allocated) ({card})")
    fixture = load_forest(FIXTURE, class_counts=counts)
    print(f"phase 11(a): resources/bench_forest.dat: {shape(fixture)}")

    # (c) the card's trainer against the CPU port at a reduced size
    x2, y2 = recipe.extract(frames[:2], dev)
    cfg2 = recipe.trainer_config(num_trees=2, max_depth=12)
    on_card, card_s = timed(lambda: ForestTrainer(cfg2, dev).learn(
        x2, y2, class_counts=counts, progress=False))
    x2_cpu = x2.cpu()
    t0 = time.perf_counter()
    on_cpu = ForestTrainer(cfg2, "cpu").learn(x2_cpu, y2, class_counts=counts,
                                              progress=False)
    cpu_s = time.perf_counter() - t0
    ties = compare.near_ties(on_card, on_cpu, x2_cpu.numpy(), y2, cfg2)
    differ = sum(int(compare.differing_nodes(on_card, on_cpu, t).sum())
                 for t in range(on_card.num_trees))
    print(f"phase 11(c): 2 frames ({len(x2)} samples), 2 trees, depth <= 12: "
          f"card {card_s:.3f} s, CPU {cpu_s:.3f} s; {differ} of "
          f"{sum(on_card.node_counts)} nodes differ; near-ties: {ties or 'none'}")
    # The recipe's features extracted on the CPU, and the card's trainer on
    # them: what separates the card's forest from the CPU's is extraction.
    (x_cpu, y_cpu), cpu_extract_s = timed(
        lambda: recipe.extract(frames[:recipe.FRAMES], "cpu"))
    check(np.array_equal(y_cpu, y), "card and CPU extraction label differently")
    # Every column equal but the normal angle (the last one), which may
    # differ by 2 float32 ulps near pi/2: the float64 integral images round
    # the same box sums on both sides.
    normal_col = x.shape[1] - 1
    differs = (x.cpu() != x_cpu).numpy()
    cols = np.nonzero(differs.any(0))[0].tolist()
    worst = float((x.cpu() - x_cpu).abs().max())
    check(set(cols) <= {normal_col} and worst <= NORMAL_TOL,
          f"the card's features of the recipe's frames differ from the CPU's "
          f"in columns {cols}, by up to {worst:.6g}")
    from_cpu = ForestTrainer(recipe.trainer_config(), dev).learn(
        x_cpu.to(dev), y_cpu, class_counts=counts, progress=False)
    own = forests["exact"]
    differ_own = sum(int(compare.differing_nodes(own, from_cpu, t).sum())
                     for t in range(own.num_trees))
    print(f"phase 11(c): the 12 frames extracted on the CPU in "
          f"{cpu_extract_s:.3f} s: {int(differs.sum())} values differ from the "
          f"card's, in columns {cols}, by at most {worst:.6g}; the card's "
          f"forest on the CPU's features {shape(from_cpu)}, on its own "
          f"{shape(own)}: {differ_own} differing nodes")

    # (d) the held-out 13th frame through kernel B, against the plain descent
    x13, y13 = recipe.extract(frames[recipe.FRAMES:], dev)
    acc = {}
    for name, f in (("card-trained", forests["exact"]), ("binned", forests["binned"]),
                    ("bench_forest.dat", fixture)):
        tf = forest_from_numpy(f, dev)
        leaves, post = forest_cuda.forest_predict(x13, tf)
        if name == "card-trained":
            want_leaves, want_post = forest_cuda.forest_predict_plain(x13, tf)
            torch.cuda.synchronize()
            check(torch.equal(leaves, want_leaves) and torch.equal(post, want_post),
                  "kernel B differs from the plain descent on the card-trained "
                  "forest")
        acc[name] = [float((post[:, l, :c].argmax(1).cpu().numpy() == y13[:, l]).mean())
                     for l, c in enumerate(counts)]
    print(f"phase 11(d): held-out frame ({len(x13)} samples): kernel B == plain "
          f"descent on the card-trained forest; accuracy per layer "
          + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in acc.items()))

    # (e) the card-trained forest through forest.dat and back
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "forest.dat")
        save_forest(path, forests["exact"])
        check(same_forest(load_forest(path, class_counts=counts), forests["exact"]),
              "the card-trained forest changed through save_forest/load_forest")
    print("phase 11(e): save_forest -> load_forest: equal arrays")

    # (f) boosting on a subsample: card against CPU
    sub, ysub = x[::10], y[::10, 0]
    cfg_b = recipe.trainer_config(num_trees=3, max_depth=10)
    (boosted, boost_s) = timed(lambda: BoostedForestTrainer(cfg_b, dev).learn(
        sub, ysub, class_counts=counts[:1]))
    boosted_cpu = BoostedForestTrainer(cfg_b, "cpu").learn(
        sub.cpu(), ysub, class_counts=counts[:1])
    check(np.array_equal(boosted.weights, boosted_cpu.weights)
          and same_forest(boosted.forest, boosted_cpu.forest),
          "boosting on the card and on the CPU grew different forests")
    votes = boosted.class_log_posterior(sub)
    check(torch.equal(votes.cpu(), boosted_cpu.class_log_posterior(sub.cpu())),
          "boosted votes on the card differ from the CPU's")
    launches = {"pack_lab": patches_cuda.pack_launches.value,
                "patches": patches_cuda.launches.value,
                "forest_descent": forest_cuda.launches.value,
                "split_search": split_search_cuda.launches.value}
    print(f"phase 11(f): boosting, 3 trees on {len(sub)} samples: {boost_s:.3f} s "
          f"on the card, weights {boosted.weights.tolist()}; card == CPU; "
          f"votes equal")
    for name, k in launches.items():
        check(k > 0, f"kernel {name} was not launched by the training phase")
    print(f"phase 11: launches on the training path {launches}")
    return launches


def public_functions_phase(card: str, dev) -> None:
    """Phase 12: the JAX package's last public functions, ported, on the
    card against the CPU at VGA (a frame of the training recipe)."""
    import cv2
    import torch

    from rovinasemanticsegmentation_tpu_torch.ops import geometry, normals, resize
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        make_bench_forest as recipe,
    )
    from rovinasemanticsegmentation_tpu_torch.utils.profiling import StepTimer

    rgb, depth, _ = next(recipe.frames())
    pts_cpu = geometry.backproject(
        torch.from_numpy(depth.astype(np.int32)),
        recipe.calibration().intrinsic_inverse, np.eye(3), np.zeros(3), 0.5, 15.0)
    pts = pts_cpu.to(dev)
    for name, fn in (
        ("normal_angles", normals.normal_angles),
        ("normal_angles_grid stride 2, size 10",
         lambda p: normals.normal_angles_grid(p, 2)),
        ("normal_angles_grid stride 2, size 6.5",
         lambda p: normals.normal_angles_grid(p, 2, normal_smoothing_size=6.5)),
    ):
        got, want = fn(pts).cpu(), fn(pts_cpu)
        check(torch.equal(got == -2.0, want == -2.0), f"{name}: masks differ")
        valid = want != -2.0
        err = float((got[valid] - want[valid]).abs().max())
        check(err <= NORMAL_TOL, f"{name}: card and CPU differ by {err:.3g} rad")
        ms = time_cuda(lambda: fn(pts), 3, warmup=1)
        print(f"phase 12: {name} {tuple(got.shape)}: masks equal, {int(valid.sum())} "
              f"angles within {err:.3g} rad of the CPU's; {ms:.3f} ms ({card})")

    rng = np.random.default_rng(12)
    change_cpu = torch.isnan(pts_cpu[..., 2]) | torch.from_numpy(
        rng.random(depth.shape) < 0.002)
    change = change_cpu.to(dev)
    for name, sat in (("exact", None), ("iter, saturation 10", 10.0)):
        got = normals.chamfer_distance_map(change, sat)
        check(torch.equal(got.cpu(), normals.chamfer_distance_map(change_cpu, sat)),
              f"chamfer_distance_map ({name}) differs from the CPU's")
        ms = time_cuda(lambda: normals.chamfer_distance_map(change, sat), 3, warmup=1)
        print(f"phase 12: chamfer_distance_map ({name}) at VGA == CPU; "
              f"{ms:.3f} ms ({card})")

    rgb_cpu = torch.from_numpy(rgb)
    rgb_dev = rgb_cpu.to(dev)
    for oh, ow in ((11, 11), (21, 27), (240, 320)):
        got = resize.resize_bilinear_u8(rgb_dev, oh, ow).cpu()
        check(torch.equal(got, resize.resize_bilinear_u8(rgb_cpu, oh, ow)),
              f"resize_bilinear_u8 to {oh}x{ow} differs from the CPU's")
        cv = cv2.resize(rgb, (ow, oh), interpolation=cv2.INTER_LINEAR)
        lsb = np.abs(got.numpy().astype(int) - cv.astype(int))
        check(lsb.max() <= 1, f"resize_bilinear_u8 to {oh}x{ow} is {lsb.max()} "
              "LSB from cv2")
        ms = time_cuda(lambda: resize.resize_bilinear_u8(rgb_dev, oh, ow), 5)
        print(f"phase 12: resize_bilinear_u8 VGA -> {oh}x{ow} == CPU; cv2 "
              f"{cv2.__version__} differs in {int((lsb > 0).sum())} of {lsb.size} "
              f"bytes, by 1 LSB; {ms:.3f} ms ({card})")

    timer = StepTimer()
    big = torch.rand(1 << 24, device=dev)
    out = timer.time("cumsum", lambda: torch.cumsum(big, 0))
    check(timer.stats["cumsum"].count == 1 and out.is_cuda, "StepTimer.time")
    # device_trace in a process of its own: by this phase a profiler window
    # in this process loses device records, the parent commit's too (around
    # one kernel it records none, around the plain normals' ~850 launches
    # all but ~9), and normal_angles_grid is three launches.
    probe = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--trace-probe"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(probe.returncode == 0, f"the device_trace probe failed: "
          f"{probe.stderr[-2000:]}")
    traced = json.loads(probe.stdout.strip().splitlines()[-1])
    check(traced["kernels"] == traced["launches"] == 3,
          f"device_trace around normal_angles_grid: {traced}")
    print(f"phase 12: StepTimer around a 2^24-element cumsum on the card "
          f"{1000 * timer.stats['cumsum'].mean:.3f} ms; device_trace (in a "
          f"process of its own) around normal_angles_grid wrote "
          f"{traced['events']} events, {traced['kernels']} of them kernels, "
          f"the normals kernels' {traced['launches']} launches ({card})")


def trace_probe() -> dict:
    """``device_trace`` around ``normal_angles_grid`` at VGA on a recipe
    frame, in a fresh process: the trace's events, kernels, and the launches
    the normals kernels counted."""
    import torch

    from rovinasemanticsegmentation_tpu_torch.ops import geometry, normals
    from rovinasemanticsegmentation_tpu_torch.ops import normals_cuda
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        make_bench_forest as recipe,
    )
    from rovinasemanticsegmentation_tpu_torch.utils.profiling import (
        device_trace,
    )

    _, depth, _ = next(recipe.frames())
    pts = geometry.backproject(
        torch.from_numpy(depth.astype(np.int32)).cuda(),
        recipe.calibration().intrinsic_inverse, np.eye(3), np.zeros(3), 0.5,
        15.0)
    normals.normal_angles_grid(pts, 2)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = normals_cuda.launches.value
    with tempfile.TemporaryDirectory() as root:
        with device_trace(root):
            normals.normal_angles_grid(pts, 2)
            torch.cuda.synchronize()
        with open(os.path.join(root, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    return {"events": len(events),
            "kernels": sum(1 for e in events if e.get("cat") == "kernel"),
            "launches": 3 * (normals_cuda.launches.value - before)}


def parallel_phase(card: str, dev, frames, calib, forest_np, cloud,
                   projector) -> dict:
    """Phase 14: the sharded paths of ``parallel/`` in worlds of processes on
    the card, held against the single process. -> launches of kernels A
    (with its Lab pack) and B in the 8-rank frame step, summed over ranks."""
    import torch

    from rovinasemanticsegmentation_tpu_torch.features.extractor import (
        FeatureConfig,
    )
    from rovinasemanticsegmentation_tpu_torch.models.lattice import (
        build_lattice,
    )
    from rovinasemanticsegmentation_tpu_torch.parallel import dryrun
    from rovinasemanticsegmentation_tpu_torch.parallel.launch import (
        Call,
        run_world,
    )
    from rovinasemanticsegmentation_tpu_torch.parallel.mesh import mesh_shape
    from rovinasemanticsegmentation_tpu_torch.parallel.tree_parallel import (
        learn_forest_parallel,
    )
    from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
        CrfParams,
        LocalMapPipeline,
        MapNodeFrames,
        crf_feats,
    )
    from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
        SingleFramePipeline,
    )
    from rovinasemanticsegmentation_tpu_torch.scripts import (
        make_bench_forest as recipe,
    )
    from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
        ForestTrainer,
    )

    t_phase = time.perf_counter()
    ranks, b = 8, 4
    shape = mesh_shape(ranks)
    cfg = FeatureConfig()
    stacks = (
        np.stack([f[0] for f in frames[:b]]),
        np.stack([f[1] for f in frames[:b]]),
        np.tile(calib.intrinsic_inverse[None], (b, 1, 1)).astype(np.float32),
        np.tile(calib.rotation[None], (b, 1, 1)).astype(np.float32),
        np.tile(calib.translation[None], (b, 1)).astype(np.float32),
    )

    # The single process: the frame step on the whole forest, and the map
    # path with the host lattice on the 4 keyframes' posteriors.
    fp = SingleFramePipeline(cfg, forest_np, STRIDE, dev, fill_value=0.0)
    ref = fp.run_batch_stacked(*stacks)
    single_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp.run_batch_stacked(*stacks)
        torch.cuda.synchronize()
        single_ms.append(1000 * (time.perf_counter() - t0))
    want_p = [[p.cpu().numpy() for p in r.posteriors] for r in ref]
    want_l = [[l.cpu().numpy() for l in r.labels] for r in ref]
    pts, cols = cloud
    nodes = [MapNodeFrames(pose=pose_of(f), posteriors=[want_p[f]])
             for f in range(b)]
    crf = CrfParams(use_dense_crf=True)
    single_map = LocalMapPipeline(projector, [8, 9], [7, 8], dev, crf=crf,
                                  use_device_lattice=False)
    want_map = [l.cpu().numpy() for l in single_map.run_device(pts, cols, nodes)]
    energies = -torch.cat(single_map.fuse_unaries(pts, nodes), dim=1).cpu().numpy()
    lattice = build_lattice(crf_feats(torch.from_numpy(pts), torch.from_numpy(cols),
                                      crf.xyz_kernel, crf.rgb_kernel).numpy())
    want_q, norm = dryrun.lattice_reference(lattice, energies, crf.kernel_weight,
                                            (8, 9), crf.iterations, dev)
    want_q1, _ = dryrun.lattice_reference(lattice, energies, crf.kernel_weight,
                                          (17,), crf.iterations, dev)
    field_args = ("model", energies, lattice, norm, crf.kernel_weight, (8, 9),
                  crf.iterations)

    # (a) a one-rank nccl world: the probe frame step and the mean field
    t0 = time.perf_counter()
    out = run_world(1, [
        Call("parallel.mesh:shard_batch_pipeline"),
        Call("parallel.dryrun:mean_field_variants", field_args,
             {"variants": ("transposed",)}),
    ], device="cuda", timeout=300)
    dryrun.check_frames(*out[0][0], *dryrun.probe_reference(1, dev))
    err_a = dryrun.check_fields(out[0][1], want_q, ("transposed",))
    print(f"phase 14(a): 1 rank: probe frame step == single process, "
          f"mean field on the {len(pts)}-point map within {err_a:.2e}; "
          f"{time.perf_counter() - t0:.3f} s")

    # (b) 8 ranks sharing the card (gloo): the frame step at full width, the
    # sharded mean fields, the map path, and the dry run's part 5.
    case = dryrun.streaming_inputs(shape["data"])
    t0 = time.perf_counter()
    out = run_world(ranks, [
        Call("parallel.dryrun:probe_cuda_all_gather"),
        Call("parallel.dryrun:timed_frame_step",
             (forest_np, cfg, STRIDE, stacks, 0.0)),
        Call("parallel.dryrun:mean_field_variants", field_args),
        Call("parallel.dryrun:map_labels",
             (projector, pts, cols, [8, 9], [7, 8], crf), {"nodes": nodes}),
        Call("parallel.dryrun:streaming_share", (case,)),
    ], device="cuda", timeout=600)
    world_s = time.perf_counter() - t0
    print(f"phase 14(b): gloo all_gather of a CUDA tensor over the data axis: "
          f"{out[0][0]}")
    differ = 0
    launches = {"pack_lab": 0, "patches": 0, "forest_descent": 0}
    for rank, rank_out in enumerate(out):
        step = rank_out[1]
        for i, f in enumerate(step["frames"]):
            differ += dryrun.check_frames(step["posteriors"][i], step["labels"][i],
                                          want_p[f], want_l[f])
        for name, k in step["launches"].items():
            check(k > 0, f"rank {rank}: kernel {name} was not launched by the "
                  "frame step")
            launches[name] += k
    rank_ms = [float(np.median(o[1]["ms"][1:])) for o in out]
    print(f"phase 14(b): frame step, {b} VGA keyframes, {ranks} ranks "
          f"({shape['data']} data x {shape['model']} model, "
          f"{forest_np.num_trees // shape['model']} tree(s) each): posteriors "
          f"within rtol 1e-6 of the single process on every rank, {differ} "
          f"labels differ (near-ties); launches {launches}")
    print(f"phase 14(b): frame step wall {max(rank_ms):.3f} ms on the slowest "
          f"rank, {min(rank_ms):.3f} ms on the fastest (median of runs 2-3, the "
          f"ranks' sub-forests built before them; 8 processes sharing one "
          f"card), single process "
          f"{sorted(single_ms)[1]:.3f} ms (median of 3): not a speed-up ({card})")
    def med(key):
        return [float(np.median(o[1][key][1:])) for o in out]

    print(f"phase 14(b): the step's halves alone, slowest / fastest rank "
          f"(median of runs 2-3): posterior partial {max(med('partial_ms')):.3f}"
          f" / {min(med('partial_ms')):.3f} ms, gloo all_reduce of its "
          f"{out[0][1]['partial_bytes']} bytes over the model axis "
          f"{max(med('all_reduce_ms')):.3f} / {min(med('all_reduce_ms')):.3f} ms "
          f"({card})")
    fields = out[0][2]
    err_b = dryrun.check_fields(fields, want_q, ("transposed", "vertex", "auto"))
    err_b = max(err_b, dryrun.check_fields(fields, want_q1, ("points",)))
    for rank_out in out[1:]:
        for v in ("points", "transposed", "vertex", "auto"):
            check(np.array_equal(rank_out[2][v], fields[v]),
                  f"ranks disagree on the {v} mean field")
    print(f"phase 14(b): sharded mean fields (points-major, transposed, "
          f"vertex-sharded, auto) on the {len(pts)}-point map, 10 iterations, "
          f"within {err_b:.2e} of potts_mean_field_multi_t; auto chose "
          f"{fields['variant']} (halo {fields['halo_comms']} vs all_reduce "
          f"{fields['replicated_comms']} values per filter and channel)")
    agree = 1.0
    for rank_out in out:
        for li, (g, w) in enumerate(zip(rank_out[3]["labels"], want_map)):
            agree = min(agree, float((g == w).mean()))
            check(agree >= 0.999, f"phase 14(b): layer {li}: sharded map "
                  f"labels agree on {agree:.4%} with the single card")
    print(f"phase 14(b): LocalMapPipeline(mesh=...).run_device "
          f"({out[0][3]['variant']}) agrees on {agree:.4%} of the labels (least "
          "over ranks and layers) with the single card's host-lattice run_device")
    dryrun.check_streaming([o[4] for o in out], case, dev)
    print(f"phase 14(b): dry run part 5 (streaming shares) == worker path; "
          f"world {world_s:.3f} s")

    # (c) tree-parallel training on two slots of the card
    gen = recipe.frames()
    x2, y2 = recipe.extract([next(gen) for _ in range(2)], dev)
    cfg2 = recipe.trainer_config(num_trees=2, max_depth=12)
    counts = list(recipe.CLASS_COUNTS)
    t0 = time.perf_counter()
    seq = ForestTrainer(cfg2, dev).learn(x2, y2, class_counts=counts,
                                         progress=False)
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    par = learn_forest_parallel(cfg2, x2, y2, class_counts=counts,
                                devices=[dev, dev])
    par_s = time.perf_counter() - t0
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        check(np.array_equal(getattr(par, f), getattr(seq, f)),
              f"tree-parallel training differs from sequential in {f}")
    print(f"phase 14(c): learn_forest_parallel on [{dev}, {dev}] == the "
          f"sequential trainer ({len(x2)} samples, 2 trees, nodes "
          f"{par.node_counts}): {par_s:.3f} s, sequential {seq_s:.3f} s ({card})")
    inp = dryrun.crf_inputs()
    fused = dryrun.check_fused_forest(inp["xs"], inp["ys"], dev)
    print(f"phase 14(c): dry run part 4: the fused forest == the tree loop on "
          f"the card (nodes {fused.node_counts})")
    print(f"phase 14: {time.perf_counter() - t_phase:.3f} s ({card})")
    return launches


STAGE_PROFILERS = ("exp_lattice", "exp_filter", "profile_normals",
                   "profile_map", "profile_slope")


def stage_profilers_phase(card: str) -> dict:
    """Phase 16: each stage profiler at full size in a process of its own,
    one repeat of each wall slope; -> the launches of A, ``pack_lab`` and B
    in ``profile_slope``. The five processes run side by side to keep the
    phase short, so their times are not readings: ``PERF.md``'s come from
    each script run alone."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for script in STAGE_PROFILERS:
                out = open(os.path.join(tmp, f"{script}.out"), "w")
                err = open(os.path.join(tmp, f"{script}.err"), "w")
                with out, err:
                    procs[script] = subprocess.Popen(
                        [sys.executable, "-m", "rovinasemanticsegmentation_"
                         f"tpu_torch.scripts.{script}", "--reps", "1"],
                        cwd=ROOT, stdout=out, stderr=err, text=True)
            seconds = {}
            while len(seconds) < len(procs):
                check(time.perf_counter() - t_phase < 300,
                      f"stage profilers still running after 300 s: "
                      f"{sorted(set(procs) - set(seconds))}")
                for script, proc in procs.items():
                    if script not in seconds and proc.poll() is not None:
                        seconds[script] = time.perf_counter() - t_phase
                time.sleep(0.1)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        outputs = {}
        for script, proc in procs.items():
            with open(os.path.join(tmp, f"{script}.out")) as f:
                stdout = f.read()
            with open(os.path.join(tmp, f"{script}.err")) as f:
                stderr = f.read()
            check(proc.returncode == 0, f"{script} exited {proc.returncode}: "
                  f"{stdout[-2000:]} {stderr[-3000:]}")
            outputs[script] = stdout
    launches = {}
    for script in STAGE_PROFILERS:
        lines = [json.loads(line) for line in outputs[script].splitlines()
                 if line.startswith("{")]
        summary = lines[-1] if lines else {}
        check(summary.get("summary") is True and summary.get("ok") is True,
              f"{script}: summary {summary}")
        check(summary["device"] == "cuda", f"{script} ran on {summary['device']}")
        if "m" in summary:
            check(summary["m"] <= summary["bucket"], f"{script}: "
                  f"{summary['m']} vertices overflow {summary['bucket']}")
        check([line["stage"] for line in lines[:-1]] == summary["stages"],
              f"{script}: stage lines {lines[:-1]}")
        for line in lines[:-1]:
            if line.get("fused_into") is not None:
                continue
            check(line["activities"] > 0,
                  f"{script}: stage {line['stage']} ran no device activity")
            top = ", ".join(f"{op['name'][:40]} {op['count']:.1f}x "
                            f"{op['ms']:.3f} ms" for op in line["top_ops"][:3])
            print(f"phase 16: {script}: {line['stage']}: wall "
                  f"{line['wall_ms']:.4f} ms, device {line['device_ms']:.4f} "
                  f"ms in {line['activities']:.1f} activities per "
                  f"{line['unit']}, idle {line['idle_share']:.1%}; top {top}")
        print(f"phase 16: {script} passed its checks "
              f"{sorted(summary['checks'])}; ended after "
              f"{seconds[script]:.1f} s")
        if script == "profile_slope":
            launches = summary["launches"]
            for kernel, n in launches.items():
                check(n > 0, f"profile_slope: kernel {kernel} was not launched")
    print(f"phase 16: the stage profilers passed in "
          f"{time.perf_counter() - t_phase:.3f} s, side by side on the card "
          f"(their times are not readings); launches {launches} ({card})")
    return launches


def crf_learning_phase(card: str, dev) -> None:
    """Phase 13: CRF learning on the card against the CPU, on a synthetic
    320x240 image with a 4-colour annotation, 20% unknown."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rovinasemanticsegmentation_tpu_torch.cli import dense_learning as dl
    from rovinasemanticsegmentation_tpu_torch.models.crf_learning import (
        CrfLearner,
        DiagKernelCrfLearner,
        FullKernelCrfLearner,
        intersection_over_union,
    )
    from rovinasemanticsegmentation_tpu_torch.utils.imageio import save_ppm
    from rovinasemanticsegmentation_tpu_torch.utils.profiling import (
        StepTimer,
        device_busy_ms,
    )

    im, anno = dl.synthetic_pair(240, 320, seed=13)
    values, grads, learners = {}, {}, {}
    for name in ("cuda", "cpu"):
        model = dl.demo_model(im, anno, 0, dev if name == "cuda" else "cpu")
        learner = CrfLearner(model.unary, [model.gauss, model.bilateral], model.gt,
                             dl.NIT, intersection_over_union,
                             device=dev if name == "cuda" else "cpu")
        params = learner.init_params([1.0, -1.0])
        x0 = learner.flatten(params)
        values[name], grads[name] = learner.objective_and_gradient(x0, params)
        learners[name] = (learner, x0, params, model)
    learner, x0, params, model = learners["cuda"]
    again = learner.objective_and_gradient(x0, params)
    check(again[0] == values["cuda"] and np.array_equal(again[1], grads["cuda"]),
          "the card's CrfLearner gradient differs between two evaluations")
    err_v = abs(values["cuda"] - values["cpu"]) / abs(values["cpu"])
    err_g = np.abs(grads["cuda"] - grads["cpu"]).max() / np.abs(grads["cpu"]).max()
    check(err_v <= 1e-4 and err_g <= 1e-3, f"CrfLearner card vs CPU: value "
          f"{err_v:.3g} relative, gradient {err_g:.3g} of its largest entry")
    print(f"phase 13: CrfLearner (logistic unary + 2 Potts, {dl.NIT} iterations, "
          f"IoU) at its start on 320x240: value {values['cuda']:.7f} (CPU "
          f"{values['cpu']:.7f}, {err_v:.3g} relative), gradient within "
          f"{err_g:.3g} of its largest entry; twice on the card: bit-equal")

    # The idle share of one objective-and-gradient evaluation.
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner.objective_and_gradient(x0, params)
        runs.append(1000 * (time.perf_counter() - t0))
    eval_ms = sorted(runs)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        learner.objective_and_gradient(x0, params)
    device = [e for e in prof.events() if e.device_type.name != "CPU"]
    busy = device_busy_ms(device)
    check(busy > 0, "the profiler saw no device time in phase 13")
    print(f"phase 13: one evaluation {eval_ms:.3f} ms (median of 3); device busy "
          f"{busy:.3f} ms ({len(device)} activities) under torch.profiler: idle "
          f"share {1 - busy / eval_ms:.1%} ({card})")

    # Kernel learners (phase 3's, and DIAG), card against CPU and again.
    unary_now = {}
    for name in ("cuda", "cpu"):
        _, _, _, m = learners[name]
        with torch.no_grad():
            unary_now[name] = m.unary.get().cpu().numpy()
    full = np.diag(dl.BILATERAL_SCALE)
    full[0, 2] = full[3, 1] = 1e-3
    for kind, cls, p0 in (("DIAG", DiagKernelCrfLearner, dl.BILATERAL_SCALE),
                          ("FULL", FullKernelCrfLearner, full)):
        out = {}
        for name in ("cuda", "cpu"):
            m = learners[name][3]
            kl = cls(unary_now["cpu"], m.bilateral_base, m.gt, dl.NIT,
                     intersection_over_union, [m.gauss], [1.0],
                     device=dev if name == "cuda" else "cpu")
            t0 = time.perf_counter()
            out[name] = kl._neg_obj_and_grad(-1.0, p0)
            if name == "cuda":
                ms = 1000 * (time.perf_counter() - t0)
                twice = kl._neg_obj_and_grad(-1.0, p0)
                check(twice[0] == out[name][0] and twice[1] == out[name][1]
                      and np.array_equal(twice[2], out[name][2]),
                      f"{kind} kernel learner: two card evaluations differ")
        (vc, wc, gc), (vh, wh, gh) = out["cuda"], out["cpu"]
        gc, gh = np.append(gc.ravel(), wc), np.append(gh.ravel(), wh)
        ev = abs(vc - vh) / abs(vh)
        eg = np.abs(gc - gh).max() / np.abs(gh).max()
        # The lattice follows the transformed features' last bit, which the
        # two sides' float32 products round differently, and the CPU's own
        # summation order moves with its build: FULL read 9.1e-4 and 9.2e-4.
        check(ev <= 1e-4 and eg <= 5e-3, f"{kind} kernel learner card vs CPU: "
              f"value {ev:.3g} relative, gradient {eg:.3g} of its largest entry")
        print(f"phase 13: {kind} kernel learner: value {vc:.7f} (CPU {vh:.7f}), "
              f"gradient within {eg:.3g} of its largest entry; twice on the card "
              f"bit-equal; {ms:.3f} ms per evaluation with its lattice build "
              f"({card})")

    with tempfile.TemporaryDirectory() as root:
        save_ppm(f"{root}/im.ppm", im)
        save_ppm(f"{root}/anno.ppm", anno)
        timer = StepTimer()
        with contextlib.redirect_stdout(io.StringIO()):
            history = dl.run(f"{root}/im.ppm", f"{root}/anno.ppm", f"{root}/out.ppm",
                             device=dev, timer=timer)
        for k in range(2):
            check(history[k + 1] >= history[k] - 1e-4,
                  f"dense_learning phase {k + 2} lowered the objective: {history}")
        ev = timer.stats["evaluation"]
        print(f"phase 13: cli.dense_learning 320x240 on the card: IoU objective "
              f"{history}; phases "
              + ", ".join(f"{timer.stats[f'phase {k}'].total:.3f}"
                          for k in (1, 2, 3))
              + f" s; {ev.count} evaluations in phases 1-2, {1000 * ev.mean:.3f} ms "
              f"each ({card})")
        small = {}
        for name in ("cuda", "cpu"):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                small[name] = dl.run(f"{root}/im.ppm", f"{root}/anno.ppm",
                                     f"{root}/out.ppm", scale=4,
                                     device=dev if name == "cuda" else "cpu")
            small[name + " s"] = time.perf_counter() - t0
    diff = np.abs(np.subtract(small["cuda"], small["cpu"])).max()
    check(diff <= 2e-3, f"dense_learning at scale 4: card {small['cuda']} vs CPU "
          f"{small['cpu']}")
    print(f"phase 13: cli.dense_learning at scale 4 (80x60): card {small['cuda']} "
          f"in {small['cuda s']:.3f} s, CPU {small['cpu']} in "
          f"{small['cpu s']:.3f} s; within {diff:.3g}")


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
    if sys.argv[1:] == ["--trace-probe"]:
        print(json.dumps(trace_probe()))
        return 0
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
