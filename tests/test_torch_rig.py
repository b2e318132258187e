"""The port's online node on the published rig of three cameras, on the CPU
at a small size: a batch of frames with one calibration each equals the
frames run one by one; ``Segmenter`` with three cameras (each its own pair
of topics and extrinsic, the yaws of ``port_bench/configs/
rovina_3cam_nocrf.json``) serves maps whose labels equal the benchmark's
plain reference (``port_bench/reference/rig.py``) and the JAX package's
``Segmenter``, with the dense CRF off and on; its frame worker batches whole
nodes, and with one camera as before; its counters and the frame batch's
span count what they claim; a camera's lost frame leaves that view out of
the map, and points no camera saw are Unknown.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.serve import segmenter as jseg
from rovinasemanticsegmentation_tpu.utils.config import Config as JaxConfig
from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
from rovinasemanticsegmentation_tpu_torch.models.forest import (
    random_forest,
    save_forest,
)
from rovinasemanticsegmentation_tpu_torch.pipelines import local_map, single_frame
from rovinasemanticsegmentation_tpu_torch.serve import segmenter as tseg
from rovinasemanticsegmentation_tpu_torch.utils import profiling
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from port_bench.reference import frame as ref_frame
from port_bench.reference import rig as ref_rig

from test_serve import CONFIG, H, W

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "port_bench", "configs", "rovina_3cam_nocrf.json")) as _f:
    RIG = ref_rig.extrinsics(json.load(_f))  # (name, rotation, translation)
NAMES = [name for name, _, _ in RIG]
K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
COUNTS, UNKNOWN = [3, 4], [2, 3]
NODES = [1, 2, 3, 4]
SEEN, UNSEEN = 25, 8  # map points a (node, camera) frame gives, points behind


def _calibs(cameras=3):
    return [Calibration(intrinsic=K, rotation=r, translation=t)
            for _, r, t in RIG[:cameras]]


def _config(crf=False):
    return dict(CONFIG, use_dense_crf=crf, dcrf_iterations=5)


def _forest(tail_splits):
    """A seeded random forest whose thresholds fall inside the features'
    ranges (Lab patch values 0..255, then depth, height and angle); with
    ``tail_splits``, every other split is on depth, height or angle, the
    features the extrinsic moves."""
    rng = np.random.default_rng(0)
    f = random_forest(rng, num_trees=2, depth=6, num_features=78,
                      class_counts=COUNTS, max_nodes=61)
    if tail_splits:
        inner = np.argwhere(f.left_child > 0)[::2]
        f.split_feature[tuple(inner.T)] = rng.integers(75, 78, len(inner))
    lo = np.select([f.split_feature == 75, f.split_feature == 76], [0.6, -3.0], 0.0)
    hi = np.select([f.split_feature < 75, f.split_feature == 75, f.split_feature == 76],
                   [255.0, 9.0, 3.0], 3.0)
    f.threshold[:] = rng.uniform(lo, hi).astype(np.float32)
    return f


@pytest.fixture(scope="module")
def forest():
    return _forest(tail_splits=True)


def _pose(node):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = 0.1 * node
    p[1, 3] = 0.02 * node
    return p


def _inputs(cameras=3, subpixel=False):
    """Per (node, camera): (rgb, depth in mm); the map's points (from every
    frame under its camera's extrinsic and its node's pose, then points
    behind the base, which no camera sees) and colours. A frame's points
    are backprojected from whole pixel coordinates, as the benchmark's
    generator makes them, or with ``subpixel`` from points inside pixels."""
    rng = np.random.default_rng(7)
    frames = {(n, c): (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                       rng.integers(600, 9000, (H, W)).astype(np.uint16))
              for n in NODES for c in range(cameras)}
    kinv = np.linalg.inv(K.astype(np.float64))
    pts = []
    for (n, c), (_, depth) in frames.items():
        ys, xs = rng.integers(0, H, SEEN), rng.integers(0, W, SEEN)
        z = depth[ys, xs] * 0.001
        off = rng.uniform(0.05, 0.95, (2, SEEN)) if subpixel else np.zeros((2, SEEN))
        cam = (kinv @ np.stack([(xs + off[0]) * z, (ys + off[1]) * z, z])).T
        _, rot, trans = RIG[c]
        pts.append((cam @ rot.T + trans) @ _pose(n)[:3, :3].T + _pose(n)[:3, 3])
    behind = np.stack([rng.uniform(-4, -2, UNSEEN), rng.uniform(-1, 1, UNSEEN),
                       rng.uniform(-1, 1, UNSEEN)], axis=1)
    pts = np.concatenate(pts + [behind]).astype(np.float32)
    cols = rng.uniform(0, 1, (len(pts), 3)).astype(np.float32)
    return frames, pts, cols


def _drive(seg, frames, pts, cols, cameras=3, lost=None):
    """Nodes 1-4, each with a frame from every camera (camera ``c``'s seq of
    node ``n`` is ``10 n``), then one map over them; ``lost`` = (camera,
    node): that camera's depth frame of that node was lost in transport
    (the node then finds the next one, seq ``10 n + 1``, and drops the
    frame). Drained inline; -> the map's flattened labels."""
    seg.initialize_projector(NAMES[:cameras], _calibs(cameras), (H, W))
    seg.stop()
    for n in NODES:
        for c in range(cameras):
            rgb, depth = frames[n, c]
            seg.push_color(NAMES[c], 10 * n, rgb)
            seg.push_depth(NAMES[c], 10 * n + int((c, n) == lost), depth)
        assert seg.on_new_node(tseg.MapNode(n, _pose(n), [10 * n] * cameras))
    seg.on_new_local_map(tseg.LocalMapData(
        3, [tseg.MapNode(n, _pose(n), [10 * n] * cameras) for n in NODES], pts, cols))
    seg.drain()
    assert seg.stored_semantics_ids() == [3]
    _, labels = seg.get_local_map_segmentation(3, ["material", "object"])
    return np.asarray(labels)


def _port(forest, crf=False, cameras=3, lost=None, subpixel=False):
    frames, pts, cols = _inputs(cameras, subpixel)
    seg = tseg.Segmenter(Config(data=_config(crf)),
                         [f"/{n}/{k}/image" for n in NAMES[:cameras] for k in ("rgb", "depth")],
                         "cpu", forest=forest)
    return _drive(seg, frames, pts, cols, cameras, lost)


def _reference(forest, tmp_path, crf=False, lost=None):
    """The map's labels from the plain reference: each frame through
    ``reference/frame.py`` under its camera's extrinsic, the rig's fusion
    and the labels of ``reference/rig.py``."""
    path = str(tmp_path / "forest.dat")
    save_forest(path, forest)
    ref_forest = ref_frame.Forest(ref_frame.read_forest(path, COUNTS), "cpu")
    conf = _config(crf)
    fcfg = ref_frame.FrameConfig.from_config(conf)
    kinv = np.linalg.inv(K).astype(np.float32)
    frames, pts, cols = _inputs()
    nodes = []
    for n in NODES:
        cams = []
        for c, (_, rot, trans) in enumerate(RIG):
            rgb, depth = frames[n, c]
            cams.append(None if (c, n) == lost else ref_frame.run_frame(
                torch.from_numpy(rgb), torch.from_numpy(depth.astype(np.int32)),
                kinv, rot, trans, fcfg, ref_forest, COUNTS, 0.0)[0])
        nodes.append((_pose(n), cams))
    p = torch.from_numpy(pts)
    u = ref_rig.unaries(p, nodes, K, [(r, t) for _, r, t in RIG], conf["depth_min"],
                        1.0e9, H, W)
    got = ref_rig.labels(u, p, torch.from_numpy(cols), conf, COUNTS, UNKNOWN)
    return np.concatenate([g.numpy() for g in got])


def _pitched(deg):
    """The front camera pitched down by ``deg`` about the base's y axis."""
    a = np.radians(deg)
    pitch = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    return Calibration(intrinsic=K, rotation=(pitch @ RIG[0][1]).astype(np.float32),
                       translation=np.array([0.0, 0.0, 0.4], np.float32))


@pytest.mark.parametrize("nodes", [1, 2])
@pytest.mark.parametrize("calibrations", ["rig", "mixed"])
def test_batch_of_calibrations_equals_frame_by_frame(forest, calibrations, nodes):
    """One ``run_batch`` over ``nodes`` nodes' three frames, each with its
    own calibration, is bit-equal to each frame run alone: the rig's three
    cameras, or three whose extrinsics give other heights and normal angles
    (the rig's front camera, the one-camera configurations' identity, one
    pitched and raised). The rig's yaws leave the frame's features as they
    are; the mixed calibrations do not."""
    frames, _, _ = _inputs()
    keys = [(n, c) for n in NODES[:nodes] for c in range(3)]
    calibs = (_calibs() if calibrations == "rig" else
              [_calibs()[0], Calibration(intrinsic=K), _pitched(20.0)])
    fp = single_frame.SingleFramePipeline(
        FeatureConfig.from_config(Config(data=CONFIG)), forest, 2, "cpu", fill_value=0.0)
    batch = fp.run_batch([frames[k][0] for k in keys], [frames[k][1] for k in keys],
                         [calibs[c] for _, c in keys])
    for (n, c), got in zip(keys, batch):
        want = fp.run(*frames[n, c], calibs[c])
        for a, b in zip(got.posteriors + got.labels, want.posteriors + want.labels):
            assert torch.equal(a, b)
    for c in (1, 2):  # the same frame under the first camera's calibration
        other = fp.run(*frames[keys[c]], calibs[0])
        same = all(torch.equal(a, b) for a, b in zip(other.posteriors, batch[c].posteriors))
        assert same == (calibrations == "rig")


CASES = [(False, None), (True, None), (False, (1, 2)), (True, (2, 3))]


@pytest.mark.parametrize("crf,lost", CASES)
def test_rig_maps_equal_reference(forest, tmp_path, caplog, crf, lost):
    """Three cameras through ``Segmenter`` serve the reference's labels,
    mismatch 0; a lost frame takes the "Couldn't find a semantic map" path
    and its view is left out; without the dense CRF, the points behind the
    base, which no camera saw, are Unknown."""
    with caplog.at_level(logging.ERROR, logger=tseg.__name__):
        got = _port(forest, crf, lost=lost)
    missing = [r for r in caplog.records if "Couldn't find a semantic map" in r.getMessage()]
    assert len(missing) == (lost is not None)
    want = _reference(forest, tmp_path, crf, lost)
    np.testing.assert_array_equal(got, want)
    n = len(NODES) * 3 * SEEN + UNSEEN
    material, objects = got[:n], got[n:]
    assert (material[:-UNSEEN] != UNKNOWN[0]).mean() > 0.5
    if not crf:  # the mean field labels unseen points from their neighbours
        assert (material[-UNSEEN:] == UNKNOWN[0]).all()
        assert (objects[-UNSEEN:] == UNKNOWN[1]).all()


@pytest.mark.parametrize("crf", [False, True])
def test_rig_maps_equal_jax(forest, crf):
    """The same three cameras through the JAX package's ``Segmenter``, on
    map points inside pixels. A point on the edge between two pixel rows or
    columns, to within rounding (such as one backprojected from the
    principal row, which every camera of the level rig sees on its own
    principal row), lands on either side by the last bit of ``v / z``,
    which XLA:CPU and the port round differently."""
    frames, pts, cols = _inputs(subpixel=True)
    seg = jseg.Segmenter(JaxConfig(data=_config(crf)),
                         [f"/{n}/{k}/image" for n in NAMES for k in ("rgb", "depth")],
                         forest=forest)
    want = _drive(seg, frames, pts, cols)
    np.testing.assert_array_equal(_port(forest, crf, subpixel=True), want)


def _spy(monkeypatch):
    """Record each ``run_batch``'s calibrations and count the descents."""
    calls = {"batches": [], "descents": 0}
    run_batch = single_frame.SingleFramePipeline.run_batch
    descend = single_frame.forest_predict_rows

    def batch(self, rgbs, depths, calibrations):
        calls["batches"].append(list(calibrations))
        return run_batch(self, rgbs, depths, calibrations)

    def descent(*a):
        calls["descents"] += 1
        return descend(*a)

    monkeypatch.setattr(single_frame.SingleFramePipeline, "run_batch", batch)
    monkeypatch.setattr(single_frame, "forest_predict_rows", descent)
    return calls


@pytest.mark.parametrize("cameras", [1, 3])
def test_frame_worker_batches_whole_nodes(forest, monkeypatch, cameras):
    """Seven nodes queued, then drained: batches of 4, 2 and 1 nodes, one
    descent each; a batch holds all its nodes' frames, node by node and
    camera by camera, each with its camera's calibration. With one camera
    that is the ladder over the camera's backlog, as before whole nodes."""
    calls = _spy(monkeypatch)
    seg = tseg.Segmenter(Config(data=_config()),
                         [f"/{n}/{k}/image" for n in NAMES[:cameras] for k in ("rgb", "depth")],
                         "cpu", forest=forest)
    seg.initialize_projector(NAMES[:cameras], _calibs(cameras), (H, W))
    seg.stop()
    rng = np.random.default_rng(2)
    for n in range(1, 8):
        for c in range(cameras):
            seg.push_color(NAMES[c], n, rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
            seg.push_depth(NAMES[c], n, rng.integers(600, 9000, (H, W)).astype(np.uint16))
        assert seg.on_new_node(tseg.MapNode(n, _pose(n), [n] * cameras))
    seg.drain()
    order = [seg.cameras[name].calibration for name in NAMES[:cameras]]
    assert [len(b) for b in calls["batches"]] == [4 * cameras, 2 * cameras, cameras]
    assert all(b == order * (len(b) // cameras) for b in calls["batches"])
    assert calls["descents"] == 3
    for c in range(cameras):  # every posterior in its camera's queue, in seq order
        assert [seq for seq, _ in seg._result_queues[c]] == list(range(1, 8))


@pytest.mark.parametrize("lost", [None, (1, 2)])
def test_counters_and_batch_span(forest, lost):
    """``segmenter.frames`` adds the frames segmented, ``fusion.views`` the
    (node, camera) views projected (a node's cameras are projected together,
    its lost frame's too); the frame batch's span serves its nodes and
    records how many cameras it spans."""
    frames0 = tseg.frames_segmented.value
    views0 = local_map.fusion_views.value
    with profiling.tracing(True):
        profiling.take()
        _port(forest, lost=lost)
        spans = profiling.take()
    assert tseg.frames_segmented.value - frames0 == len(NODES) * 3 - (lost is not None)
    assert local_map.fusion_views.value - views0 == len(NODES) * 3
    (batch,) = [s for s in spans if s.name == "runtime.frame_batch"]
    assert batch.request == NODES and batch.attrs == {"cameras": 3}
    keyframes = sorted(s.request for s in spans if s.name == "runtime.keyframe")
    assert keyframes == NODES  # each ended once all its cameras' parts ended
