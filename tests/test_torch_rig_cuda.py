"""The published three-camera rig on the card: a batch of VGA frames with
one calibration each through kernels A and B and the normals kernels, and
the map fusion over every (node, camera) view, each held to the plain path;
``Segmenter`` with the rig and the dense CRF on, and the streaming step in
whole rig nodes, each held to the benchmark's plain reference; and the
streaming step with one camera, held to its own calls as before.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is
false. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_rig_cuda.py -q

This file imports nothing of JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from port_bench import gen
from port_bench.reference import rig as ref_rig
from rovinasemanticsegmentation_tpu_torch.features import extractor
from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
from rovinasemanticsegmentation_tpu_torch.fusion.projector import (
    MultiProjector,
    project_winners,
)
from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
from rovinasemanticsegmentation_tpu_torch.ops import (
    forest_cuda,
    normals_cuda,
    patches_cuda,
)
from rovinasemanticsegmentation_tpu_torch.ops.feature_rows import unpack_rows
from rovinasemanticsegmentation_tpu_torch.pipelines import local_map, single_frame
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "port_bench", "configs", "rovina_3cam_nocrf.json")) as _f:
    CONF = json.load(_f)
H, W = CONF["camera"]["height"], CONF["camera"]["width"]
K = np.array([[CONF["camera"]["fx"], 0, CONF["camera"]["cx"]],
              [0, CONF["camera"]["fy"], CONF["camera"]["cy"]], [0, 0, 1]], np.float32)
COUNTS, UNKNOWN = [8, 9], [7, 8]
RIG = ref_rig.extrinsics(CONF)
CALIBS = [Calibration(intrinsic=K, rotation=r, translation=t) for _, r, t in RIG]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _pose(node):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = 0.08 * node
    return p


def _pipeline(device):
    forest = load_forest(os.path.join(ROOT, CONF["forest_file"]), class_counts=COUNTS)
    return single_frame.SingleFramePipeline(
        FeatureConfig.from_config(Config(data=CONF)), forest,
        CONF["rf_prediction_stride"], device, fill_value=0.0)


def _plain_frame_path(monkeypatch):
    """Kernel A, kernel B and the normals kernels replaced by their plain
    versions, on the same CUDA tensors."""
    monkeypatch.setattr(normals_cuda, "engages", lambda *a: False)
    monkeypatch.setattr(extractor, "extract_patches_into",
                        patches_cuda.extract_patches_into_plain)
    monkeypatch.setattr(single_frame, "forest_predict_rows",
                        lambda rows, layout, forest: forest_cuda.forest_predict_plain(
                            unpack_rows(rows, layout), forest))


@pytest.mark.parametrize("nodes", [1, 2])
def test_calibrations_batch_on_card(dev, monkeypatch, nodes):
    """``nodes`` nodes' three VGA frames in one batch, each with its
    camera's calibration: one descent, a normals call a frame, and
    posteriors and labels bit-equal to each frame run alone and to the
    plain path on the card."""
    frames, _ = gen.make_pool(2**31 + 7, 3 * nodes, H, W)
    calibs = CALIBS * nodes
    fp = _pipeline(dev)
    before = (forest_cuda.launches.value, normals_cuda.launches.value,
              patches_cuda.launches.value)
    batch = fp.run_batch([f[0] for f in frames], [f[1] for f in frames], calibs)
    torch.cuda.synchronize(dev)
    after = (forest_cuda.launches.value, normals_cuda.launches.value,
             patches_cuda.launches.value)
    assert [a - b for a, b in zip(after, before)] == [1, 3 * nodes, 3 * nodes]
    alone = [fp.run(rgb, depth, c) for (rgb, depth), c in zip(frames, calibs)]
    _plain_frame_path(monkeypatch)
    before = (forest_cuda.launches.value, normals_cuda.launches.value,
              patches_cuda.launches.value)
    plain = fp.run_batch([f[0] for f in frames], [f[1] for f in frames], calibs)
    after = (forest_cuda.launches.value, normals_cuda.launches.value,
             patches_cuda.launches.value)
    assert after == before  # the plain path launched none of the three
    for got, one, want in zip(batch, alone, plain):
        for a, b, c in zip(got.posteriors + got.labels, one.posteriors + one.labels,
                           want.posteriors + want.labels):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_rig_fusion_on_card(dev):
    """A map of 30000 points fused over 5 nodes of the three cameras on the
    card: the z-buffer winners of every view equal the CPU's, the unaries
    equal the CPU's to float32 rounding and the plain reference's on the
    card, and the labels are equal; 15 views are counted."""
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-2, 12, 30000), rng.uniform(-8, 8, 30000),
                    rng.uniform(-2, 2, 30000)], axis=1).astype(np.float32)
    posts = [[[torch.from_numpy(rng.normal(size=(H, W, c)).astype(np.float32))
               for c in COUNTS] for _ in RIG] for _ in range(5)]
    proj = MultiProjector.from_calibrations(CALIBS, H, W, min_distance=CONF["depth_min"])
    out = {}
    for device in ("cpu", dev):
        mp = local_map.LocalMapPipeline(proj, COUNTS, UNKNOWN, device)
        nodes = [local_map.MapNodeFrames(pose=_pose(n), posteriors=[
            [p.to(device) for p in cam] for cam in posts[n]]) for n in range(5)]
        views = local_map.fusion_views.value
        p = torch.from_numpy(pts).to(device)
        unaries = mp.fuse_unaries(p, nodes)
        assert local_map.fusion_views.value - views == 15
        winners = [project_winners(p, *(torch.from_numpy(a).to(device)
                                        for a in proj.camera_transforms(_pose(n))),
                                   torch.from_numpy(proj.intrinsics).to(device),
                                   proj.min_distance, proj.max_distance, H, W)
                   for n in range(5)]
        out[str(device)] = ([u.cpu() for u in unaries], mp.label_map(unaries),
                            [(w.cpu(), f.cpu()) for w, f in winners])
    (u_cpu, l_cpu, w_cpu), (u_card, l_card, w_card) = out["cpu"], out[str(dev)]
    for (a, b), (c, d) in zip(w_cpu, w_card):
        assert torch.equal(a, c) and torch.equal(b, d)
    for a, b in zip(u_cpu, u_card):
        torch.testing.assert_close(b, a, rtol=2.0**-21, atol=0.0)
    for a, b in zip(l_cpu, l_card):
        assert torch.equal(a, b.cpu())
    ref = ref_rig.unaries(torch.from_numpy(pts).to(dev),
                          [(_pose(n), [[p.to(dev) for p in cam] for cam in posts[n]])
                           for n in range(5)],
                          K, [(r, t) for _, r, t in RIG], CONF["depth_min"], 1.0e9, H, W)
    torch.testing.assert_close(torch.cat(u_card, 1), ref.cpu(), rtol=2.0**-21, atol=0.0)
    assert (torch.cat(u_card, 1) != 0).any(dim=1).float().mean() > 0.3


SEED = 2**31 + 22  # more than 32 signed bits hold


def _spec(workload, config=None, **traffic):
    """A benchmark cell's spec, with another configuration file and traffic
    settings where given."""
    from port_bench import harness

    spec = harness.load_spec(workload)
    if config is not None:
        with open(os.path.join(ROOT, "port_bench", "configs", config + ".json")) as f:
            spec.config = json.load(f)
    spec.traffic = dict(spec.traffic, **traffic)
    return spec


def _cell(spec, device):
    from port_bench import harness

    return harness.load_module("drivers", spec.traffic["driver"]).Cell(spec, SEED, str(device))


def test_rig_with_dense_crf_serves_the_reference(dev):
    """``Segmenter`` with the three cameras and the dense CRF on, driven as
    the online rig cell drives it (VGA nodes at 25/s, maps of 30000 points
    from 15 views): every sampled served map's labels equal the plain
    reference's (``reference/rig.py`` with ``lattice.py::crf_labels``), and
    every map is served."""
    spec = _spec("online_3cam_nocrf", config="rovina_3cam_crf10", check_maps=4)
    assert spec.config["use_dense_crf"] and spec.config["cameras"] == 3
    cell = _cell(spec, dev)
    info = cell.window(2.0)["info"]
    cell.release()
    assert info["maps"] >= 8 and info["counters"]["fusion.views"] == 3 * info["nodes"]
    assert cell.check() == {"map_label_mismatch": 0.0, "maps_never_served": 0}


def test_stream_rig_step_equals_the_reference(dev):
    """``run_staged`` with 10 rig nodes at VGA a call (30 frames in one
    descent, 2 maps of 15 views and 30000 points, the dense CRF on), as the
    cell ``stream_3cam_crf10_b10`` drives it: the sampled batches' frame and
    map labels equal the plain reference's, and each call launches one
    descent and counts its 30 frames and 30 views."""
    spec = _spec("stream_3cam_crf10_b10", check_batches=2)
    cell = _cell(spec, dev)
    info = cell.window(1.0)["info"]
    cell.release()
    batches = info["batches"]
    assert batches >= 2 and info["frames"] == 30 * batches
    assert info["counters"] == {"streaming.frames": 30 * batches,
                                "forest_cuda.launches": batches,
                                "fusion.views": 30 * batches}
    assert cell.check() == {"frame_label_mismatch": 0.0, "map_label_mismatch": 0.0}


def test_one_camera_stream_step_is_unchanged(dev):
    """With one camera, ``run_staged`` is the frame batch and the maps' own
    calls, as before whole nodes: 10 VGA keyframes and 2 maps with the dense
    CRF on give labels bit-equal to ``run_batch_stacked`` and one
    ``run_device`` a map, in one descent and a patches and a normals launch
    a frame."""
    from rovinasemanticsegmentation_tpu_torch.pipelines.streaming import (
        StreamingPipeline, pack_poses)

    with open(os.path.join(ROOT, "port_bench", "configs", "rovina_crf10.json")) as f:
        conf = json.load(f)
    calib = Calibration(intrinsic=K, rotation=np.eye(3), translation=np.zeros(3))
    frames, rng = gen.make_pool(SEED, 10, H, W)
    cloud, cloud_rgb = gen.make_cloud(rng, frames, float(K[0, 0]), H, W, 5, 30000)
    fp = _pipeline(dev)
    proj = MultiProjector.from_calibrations([calib], H, W, min_distance=conf["depth_min"],
                                            max_distance=conf["depth_max"])
    mp = local_map.LocalMapPipeline(proj, COUNTS, UNKNOWN, dev, crf=local_map.CrfParams(
        use_dense_crf=True, xyz_kernel=conf["dcrf_xyz_kernel"],
        rgb_kernel=conf["dcrf_rgb_kernel"], kernel_weight=conf["dcrf_kernel_weight"],
        iterations=conf["dcrf_iterations"]))
    rgb = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    depth = torch.from_numpy(np.stack([f[1] for f in frames]).astype(np.int32)).to(dev)
    kinv, rot, trans = (torch.from_numpy(np.tile(np.asarray(a, np.float32)[None],
                                                 (10,) + (1,) * np.ndim(a))).to(dev)
                        for a in (calib.intrinsic_inverse, calib.rotation, calib.translation))
    clouds = torch.from_numpy(np.stack([cloud, cloud + np.float32(0.001)])).to(dev)
    colours = torch.from_numpy(cloud_rgb).to(dev)
    poses = torch.from_numpy(np.stack([pack_poses(proj, [np.eye(4)] * 5)] * 2)).to(dev)
    results = fp.run_batch_stacked(rgb, depth, kinv, rot, trans)
    want_maps = [mp.run_device(clouds[m], colours, [
        local_map.MapNodeFrames(pose=poses[m, k], posteriors=[results[5 * m + k].posteriors])
        for k in range(5)]) for m in range(2)]
    before = (forest_cuda.launches.value, normals_cuda.launches.value,
              patches_cuda.launches.value)
    frames_got, maps_got = StreamingPipeline(fp, mp, 5).run_staged(
        rgb, depth, kinv, rot, trans, clouds, colours, poses)
    torch.cuda.synchronize(dev)
    after = (forest_cuda.launches.value, normals_cuda.launches.value,
             patches_cuda.launches.value)
    mp.flush()
    assert [a - b for a, b in zip(after, before)] == [1, 10, 10]
    for got, want in zip(frames_got, results, strict=True):
        for a, b in zip(got, want.labels, strict=True):
            assert torch.equal(a, b)
    for got, want in zip(maps_got, want_maps, strict=True):
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
    assert mp.overflow_maps == 0
