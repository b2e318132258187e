"""The port's streaming step on the published rig of three cameras, on the
CPU at a small size: ``StreamingPipeline.run_staged`` takes whole keyframe
nodes (each camera's frame, node-major and camera-minor, each with its
camera's extrinsic: the yaws of ``port_bench/configs/rovina_3cam_crf10.json``)
and fuses every camera of a node into its maps. Its frame and map labels
equal the port's separate paths (``SingleFramePipeline.run_batch``, then
``LocalMapPipeline.run`` a map) and the benchmark's plain reference
(``port_bench/reference/rig.py``); a batch that is not whole nodes is
refused; its counters and its span count what they claim; with one camera
it is the one-camera step. Seeded random forest, 24x32 frames.
"""

import json
import os

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu_torch.models.forest import random_forest, save_forest
from rovinasemanticsegmentation_tpu_torch.pipelines import local_map, single_frame, streaming
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
    CrfParams,
    LocalMapPipeline,
    MapNodeFrames,
)
from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import SingleFramePipeline
from rovinasemanticsegmentation_tpu_torch.pipelines.streaming import (
    StreamingPipeline,
    pack_poses,
)
from rovinasemanticsegmentation_tpu_torch.utils import profiling
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from port_bench.reference import frame as ref_frame
from port_bench.reference import rig as ref_rig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "port_bench", "configs", "rovina_3cam_crf10.json")) as _f:
    _RIG_CONF = json.load(_f)
RIG = ref_rig.extrinsics(_RIG_CONF)  # (name, rotation, translation)
H, W = 24, 32
K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
COUNTS, UNKNOWN = [3, 4], [2, 3]
NODES, MAP_EVERY = 4, 2  # a batch of 4 nodes: 2 maps
SEEN, UNSEEN = 20, 6  # map points a (node, camera) view gives, points behind
CONF = dict(
    {k: _RIG_CONF[k] for k in ("rf_prediction_stride", "depth_min", "depth_max",
                               "dcrf_xyz_kernel", "dcrf_rgb_kernel",
                               "dcrf_kernel_weight", "feature_color_patch",
                               "feature_depth", "feature_height", "feature_normal")},
    patch_size=15, patch_size_reduce=5, dcrf_iterations=5,
    color_codings=[{"name": name, "coding": [
        {"name": f"{name}{i}", "color": [i, 0, 0], "label": i} for i in range(n - 1)]
        + [{"name": "Unknown", "color": [50, 50, 50], "label": n - 1}]}
        for name, n in (("material", 3), ("object", 4))],
)


@pytest.fixture(scope="module")
def forest():
    """A seeded random forest whose thresholds fall inside the features'
    ranges; every other split is on depth, height or angle, the features
    the extrinsic moves."""
    rng = np.random.default_rng(0)
    f = random_forest(rng, num_trees=2, depth=6, num_features=78,
                      class_counts=COUNTS, max_nodes=61)
    inner = np.argwhere(f.left_child > 0)[::2]
    f.split_feature[tuple(inner.T)] = rng.integers(75, 78, len(inner))
    lo = np.select([f.split_feature == 75, f.split_feature == 76], [0.6, -3.0], 0.0)
    hi = np.select([f.split_feature < 75, f.split_feature == 75, f.split_feature == 76],
                   [255.0, 9.0, 3.0], 3.0)
    f.threshold[:] = rng.uniform(lo, hi).astype(np.float32)
    return f


def _pose(node):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = 0.1 * node
    p[1, 3] = 0.02 * node
    return p


def _rig(cameras):
    return RIG[:cameras]


@pytest.fixture(scope="module")
def inputs():
    """Per (node, camera): (rgb, depth in mm); per map: its points, from
    every view of its nodes under the camera's extrinsic and the node's
    pose, then points behind the base, which no camera sees, and colours.
    Drawn for three cameras; one camera takes the first of each node."""
    rng = np.random.default_rng(7)
    frames = {(n, c): (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                       rng.integers(600, 9000, (H, W)).astype(np.uint16))
              for n in range(NODES) for c in range(3)}
    kinv = np.linalg.inv(K.astype(np.float64))
    clouds = {}
    for cameras in (1, 3):
        maps = []
        for m in range(NODES // MAP_EVERY):
            pts = []
            for n in range(m * MAP_EVERY, (m + 1) * MAP_EVERY):
                for c, (_, rot, trans) in enumerate(_rig(cameras)):
                    depth = frames[n, c][1]
                    ys, xs = rng.integers(0, H, SEEN), rng.integers(0, W, SEEN)
                    z = depth[ys, xs] * 0.001
                    cam = (kinv @ np.stack([xs * z, ys * z, z])).T
                    pts.append((cam @ rot.T + trans) @ _pose(n)[:3, :3].T
                               + _pose(n)[:3, 3])
            pts.append(np.stack([rng.uniform(-4, -2, UNSEEN), rng.uniform(-1, 1, UNSEEN),
                                 rng.uniform(-1, 1, UNSEEN)], axis=1))
            pts = np.concatenate(pts).astype(np.float32)
            maps.append((pts, rng.uniform(0, 1, (len(pts), 3)).astype(np.float32)))
        clouds[cameras] = maps
    return frames, clouds


def _calibs(cameras):
    return [Calibration(intrinsic=K, rotation=r, translation=t) for _, r, t in _rig(cameras)]


def _pipelines(forest, cameras, crf=True):
    fp = SingleFramePipeline(FeatureConfig.from_config(Config(data=CONF)), forest,
                             CONF["rf_prediction_stride"], "cpu", fill_value=0.0)
    proj = MultiProjector.from_calibrations(_calibs(cameras), H, W,
                                            min_distance=CONF["depth_min"],
                                            max_distance=CONF["depth_max"])
    mp = LocalMapPipeline(proj, COUNTS, UNKNOWN, "cpu", crf=CrfParams(
        use_dense_crf=crf, xyz_kernel=CONF["dcrf_xyz_kernel"],
        rgb_kernel=CONF["dcrf_rgb_kernel"], kernel_weight=CONF["dcrf_kernel_weight"],
        iterations=CONF["dcrf_iterations"]))
    return fp, mp, proj


def _batch(inputs, cameras):
    """The step's arguments for the batch's nodes: frames node-major and
    camera-minor, each with its camera's calibration."""
    frames, _ = inputs
    keys = [(n, c) for n in range(NODES) for c in range(cameras)]
    calibs = _calibs(cameras)
    return (torch.from_numpy(np.stack([frames[k][0] for k in keys])),
            torch.from_numpy(np.stack([frames[k][1] for k in keys]).astype(np.int32)),
            np.stack([calibs[c].intrinsic_inverse for _, c in keys]).astype(np.float32),
            np.stack([calibs[c].rotation for _, c in keys]).astype(np.float32),
            np.stack([calibs[c].translation for _, c in keys]).astype(np.float32))


def _run_staged(stream, proj, inputs, cameras):
    maps = inputs[1][cameras]
    poses = np.stack([pack_poses(proj, [_pose(n) for n in range(m * MAP_EVERY,
                                                                   (m + 1) * MAP_EVERY)])
                      for m in range(len(maps))])
    return stream.run_staged(*_batch(inputs, cameras), np.stack([p for p, _ in maps]),
                             np.stack([c for _, c in maps]), poses)


def _separate_paths(fp, mp, inputs, cameras):
    """Each node's frames through ``run_batch``, then each map through
    ``LocalMapPipeline.run``: -> (frame labels, map labels)."""
    frames, clouds = inputs
    keys = [(n, c) for n in range(NODES) for c in range(cameras)]
    calibs = _calibs(cameras)
    results = fp.run_batch([frames[k][0] for k in keys], [frames[k][1] for k in keys],
                           [calibs[c] for _, c in keys])
    post = {k: r.posteriors for k, r in zip(keys, results)}
    maps = [mp.run(pts, cols, [MapNodeFrames(_pose(n), [post[n, c] for c in range(cameras)])
                               for n in range(m * MAP_EVERY, (m + 1) * MAP_EVERY)])
            for m, (pts, cols) in enumerate(clouds[cameras])]
    return [r.labels for r in results], maps


@pytest.mark.parametrize("cameras", [1, 3])
def test_run_staged_equals_the_separate_paths(forest, inputs, cameras, monkeypatch):
    """Frame labels equal ``run_batch``'s and map labels ``run``'s on the
    same nodes, bit for bit, in one descent a call."""
    fp, mp, proj = _pipelines(forest, cameras)
    want_frames, want_maps = _separate_paths(fp, mp, inputs, cameras)
    stream = StreamingPipeline(fp, mp, MAP_EVERY)
    descents = []
    descend = single_frame.forest_predict_rows
    monkeypatch.setattr(single_frame, "forest_predict_rows",
                        lambda *a: descents.append(1) or descend(*a))
    frames, maps = _run_staged(stream, proj, inputs, cameras)
    mp.flush()
    assert len(descents) == 1
    assert len(frames) == NODES * cameras and len(maps) == NODES // MAP_EVERY
    for got, want in zip(frames, want_frames, strict=True):
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
    for got, want in zip(maps, want_maps, strict=True):
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a.numpy().astype(np.uint8), b)


def _reference(forest, inputs, tmp_path, crf):
    """The frames' and maps' labels from the plain reference: each frame
    through ``reference/frame.py`` under its camera's extrinsic, each map
    through the rig's fusion and labels of ``reference/rig.py``."""
    frames, clouds = inputs
    path = str(tmp_path / "forest.dat")
    save_forest(path, forest)
    ref_forest = ref_frame.Forest(ref_frame.read_forest(path, COUNTS), "cpu")
    fcfg = ref_frame.FrameConfig.from_config(CONF)
    kinv = np.linalg.inv(K).astype(np.float32)
    out = {}
    for (n, c), (rgb, depth) in frames.items():
        _, rot, trans = RIG[c]
        out[n, c] = ref_frame.run_frame(
            torch.from_numpy(rgb), torch.from_numpy(depth.astype(np.int32)), kinv, rot,
            trans, fcfg, ref_forest, COUNTS, 0.0)
    conf = dict(CONF, use_dense_crf=crf)
    maps = []
    for m, (pts, cols) in enumerate(clouds[3]):
        nodes = [(_pose(n), [out[n, c][0] for c in range(3)])
                 for n in range(m * MAP_EVERY, (m + 1) * MAP_EVERY)]
        p = torch.from_numpy(pts)
        u = ref_rig.unaries(p, nodes, K, [(r, t) for _, r, t in RIG], conf["depth_min"],
                            conf["depth_max"], H, W)
        maps.append(ref_rig.labels(u, p, torch.from_numpy(cols), conf, COUNTS, UNKNOWN))
    return [out[n, c][1] for n in range(NODES) for c in range(3)], maps


@pytest.mark.parametrize("crf", [False, True])
def test_rig_step_equals_the_reference(forest, inputs, tmp_path, crf):
    """Three cameras, the dense CRF off and on: the frame labels of
    ``run_staged`` equal the plain reference's under each camera's
    extrinsic, and its map labels equal the reference's fusion of every
    camera of a node, then its plain labels or its dense CRF."""
    fp, mp, proj = _pipelines(forest, 3, crf=crf)
    frames, maps = _run_staged(StreamingPipeline(fp, mp, MAP_EVERY), proj, inputs, 3)
    mp.flush()
    want_frames, want_maps = _reference(forest, inputs, tmp_path, crf)
    for got, want in zip(frames, want_frames, strict=True):
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
    known = 0
    for got, want in zip(maps, want_maps, strict=True):
        for a, b, unk in zip(got, want, UNKNOWN, strict=True):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            known += int((b != unk).sum())
    assert known > 0  # not every point fell to Unknown


@pytest.mark.parametrize("frames,message", [
    (NODES * 3 - 1, "11 frames are not whole nodes of 3 cameras"),
    (2 * 3, "2 clouds for 1 maps"),
])
def test_a_batch_of_part_nodes_is_refused(forest, inputs, frames, message):
    fp, mp, proj = _pipelines(forest, 3)
    rgb, depth, kinv, rot, trans = (a[:frames] for a in _batch(inputs, 3))
    clouds = np.stack([p for p, _ in inputs[1][3]])
    with pytest.raises(ValueError, match=message):
        StreamingPipeline(fp, mp, MAP_EVERY).run_staged(
            rgb, depth, kinv, rot, trans, clouds, clouds[0],
            np.zeros((2, MAP_EVERY, 3, 3, 4), np.float32))


@pytest.mark.parametrize("cameras", [1, 3])
def test_counters_and_step_span(forest, inputs, cameras):
    """``streaming.frames`` adds the frames a call takes and ``fusion.views``
    the (node, camera) views its maps fuse; the call is one ``stream.step``
    span that records its nodes and cameras and holds the frame path's and
    the map path's spans."""
    fp, mp, proj = _pipelines(forest, cameras)
    stream = StreamingPipeline(fp, mp, MAP_EVERY)
    frames0 = streaming.streaming_frames.value
    views0 = local_map.fusion_views.value
    with profiling.tracing(True):
        profiling.take()
        _run_staged(stream, proj, inputs, cameras)
        spans = profiling.take()
    mp.flush()
    assert streaming.streaming_frames.value - frames0 == NODES * cameras
    assert local_map.fusion_views.value - views0 == NODES * cameras
    (step,) = [s for s in spans if s.name == "stream.step"]
    assert step.attrs == {"nodes": NODES, "cameras": cameras}
    inside = {s.name for s in spans if s.parent == step.id}
    assert {"frame.descent", "frame.results", "map.fusion", "map.lattice_build",
            "map.mean_field"} <= inside
    assert all(step.start_ns <= s.start_ns and s.end_ns <= step.end_ns
               for s in spans if s.parent == step.id)
