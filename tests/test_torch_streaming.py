"""PyTorch port vs JAX reference: the streaming step.

``StreamingPipeline.run_staged`` of the port against the JAX package's
separate paths (``run_batch_stacked`` with ``use_pallas=False``, then one
``run_device`` per map), which the JAX streaming step is held equal to in
``tests/test_fusion.py::TestStreamingPipeline``, on that test's fixture:
32x40 frames, two maps of two keyframes, a depth-7 random forest.
"""

import sys

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.features.extractor import (
    FeatureConfig as JFeatureConfig,
)
from rovinasemanticsegmentation_tpu.fusion.projector import (
    MultiProjector as JMultiProjector,
)
from rovinasemanticsegmentation_tpu.models.forest import random_forest
from rovinasemanticsegmentation_tpu.pipelines import local_map as jlm
from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
    SingleFramePipeline as JSingleFramePipeline,
)
from rovinasemanticsegmentation_tpu.pipelines.streaming import (
    pack_poses as jax_pack_poses,
)
from rovinasemanticsegmentation_tpu.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu_torch.pipelines import local_map as tlm
from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
    SingleFramePipeline,
)
from rovinasemanticsegmentation_tpu_torch.pipelines.streaming import (
    StreamingPipeline,
    pack_poses,
)

torch.set_num_threads(2)

H, W, N_POINTS = 32, 40, 70
MAP_EVERY, BATCH = 2, 4


@pytest.fixture(scope="module")
def fixture():
    """tests/test_fusion.py:459-510, drawn from the same seed in the same
    order."""
    rng = np.random.default_rng(2)
    calib = Calibration(
        intrinsic=np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]),
        rotation=np.eye(3), translation=np.zeros(3),
    )
    forest = random_forest(rng, num_trees=2, depth=7, num_features=366,
                           class_counts=[3, 4], max_nodes=201)
    rgbs = np.stack([rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                     for _ in range(BATCH)])
    depths = np.stack([rng.integers(600, 9000, (H, W)).astype(np.uint16)
                       for _ in range(BATCH)])
    kinv = np.tile(calib.intrinsic_inverse[None], (BATCH, 1, 1)).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32)[None], (BATCH, 1, 1))
    trans = np.zeros((BATCH, 3), np.float32)
    pts = np.stack([rng.uniform(-0.3, 0.3, N_POINTS),
                    rng.uniform(-0.25, 0.25, N_POINTS),
                    rng.uniform(1.5, 2.5, N_POINTS)], axis=1).astype(np.float32)
    clouds = np.stack([pts, pts + 0.01])
    crgb = rng.uniform(0, 1, (N_POINTS, 3)).astype(np.float32)
    return calib, forest, (rgbs, depths, kinv, rot, trans), clouds, crgb


@pytest.fixture(scope="module")
def jax_separate(fixture):
    """The JAX separate paths: the frame batch, then each map."""
    calib, forest, stacks, clouds, crgb = fixture
    fp = JSingleFramePipeline(JFeatureConfig(), forest, stride=2,
                              fill_value=0.0, use_pallas=False)
    mp = jlm.LocalMapPipeline(
        JMultiProjector.from_calibrations([calib], H, W, min_distance=0.5,
                                          max_distance=15.0),
        [3, 4], [2, 3], crf=jlm.CrfParams(use_dense_crf=True, iterations=3),
    )
    results = fp.run_batch_stacked(*stacks)
    maps = []
    for m in range(BATCH // MAP_EVERY):
        nodes = [jlm.MapNodeFrames(pose=np.eye(4), posteriors=[list(r.posteriors)])
                 for r in results[m * MAP_EVERY : (m + 1) * MAP_EVERY]]
        maps.append([np.asarray(l) for l in mp.run_device(clouds[m], crgb, nodes)])
    mp.flush()
    frames = [[np.asarray(l) for l in r.labels] for r in results]
    return frames, maps


def _port(fixture):
    calib, forest, _, _, _ = fixture
    fp = SingleFramePipeline(FeatureConfig(), forest, 2, "cpu", fill_value=0.0)
    proj = MultiProjector.from_calibrations([calib], H, W, min_distance=0.5,
                                            max_distance=15.0)
    mp = tlm.LocalMapPipeline(proj, [3, 4], [2, 3], "cpu",
                              crf=tlm.CrfParams(use_dense_crf=True, iterations=3))
    return fp, mp, proj


def _validate(fixture, fp, mp):
    """One map through run_device validates the bucket for the cloud size."""
    _, _, stacks, clouds, crgb = fixture
    first = fp.run_batch_stacked(*[a[:MAP_EVERY] for a in stacks])
    nodes = [tlm.MapNodeFrames(pose=np.eye(4), posteriors=[r.posteriors])
             for r in first]
    mp.run_device(clouds[0], crgb, nodes)
    mp.flush()


def _run_staged(fixture, stream, proj):
    _, _, stacks, clouds, crgb = fixture
    poses = pack_poses(proj, [np.eye(4)] * MAP_EVERY)
    return stream.run_staged(*stacks, clouds, crgb,
                             np.stack([poses] * (BATCH // MAP_EVERY)))


def test_run_staged_matches_jax_separate_paths(fixture, jax_separate):
    want_frames, want_maps = jax_separate
    fp, mp, proj = _port(fixture)
    _validate(fixture, fp, mp)
    frames, maps = _run_staged(fixture, StreamingPipeline(fp, mp, MAP_EVERY),
                               proj)
    assert len(frames) == BATCH and len(maps) == BATCH // MAP_EVERY
    for got, want in zip(frames, want_frames):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    known = 0
    for got, want in zip(maps, want_maps):
        for g, w, unk in zip(got, want, (2, 3)):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
            known += int((w != unk).sum())
    assert known > 0  # not every point fell to Unknown
    assert len(mp._pending_m) == BATCH // MAP_EVERY
    mp.flush()


def test_run_staged_equals_the_port_separate_paths(fixture):
    """The step is the two pipelines' own calls: the port's frame batch and
    ``run_device`` maps give the same labels."""
    fp, mp, proj = _port(fixture)
    _validate(fixture, fp, mp)
    frames, maps = _run_staged(fixture, StreamingPipeline(fp, mp, MAP_EVERY),
                               proj)
    _, _, stacks, clouds, crgb = fixture
    results = fp.run_batch_stacked(*stacks)
    for m in range(BATCH // MAP_EVERY):
        nodes = [tlm.MapNodeFrames(pose=np.eye(4), posteriors=[r.posteriors])
                 for r in results[m * MAP_EVERY : (m + 1) * MAP_EVERY]]
        for a, b in zip(maps[m], mp.run_device(clouds[m], crgb, nodes)):
            assert torch.equal(a, b)
    for a, r in zip(frames, results):
        for la, lb in zip(a, r.labels):
            assert torch.equal(la, lb)
    mp.flush()


def test_unvalidated_bucket_raises(fixture):
    fp, mp, proj = _port(fixture)
    with pytest.raises(ValueError, match="vertex bucket not validated"):
        _run_staged(fixture, StreamingPipeline(fp, mp, MAP_EVERY), proj)
    _, _, stacks, clouds, crgb = fixture
    _validate(fixture, fp, mp)
    with pytest.raises(ValueError, match="3 clouds for 2 maps"):
        StreamingPipeline(fp, mp, MAP_EVERY).run_staged(
            *stacks, np.concatenate([clouds, clouds[:1]]), crgb,
            np.zeros((3, MAP_EVERY, 1, 3, 4), np.float32))


def _host_reads(monkeypatch):
    """Record every tensor -> Python value conversion (each one waits for
    the device) with the function that asked for it."""
    reads = []
    for name in ("__int__", "__float__", "__bool__", "__index__", "item",
                 "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *args, _orig=orig, _name=name):
            reads.append((_name, sys._getframe(1).f_code.co_name))
            return _orig(self, *args)

        monkeypatch.setattr(torch.Tensor, name, spy)
    return reads


def test_second_call_reads_nothing_back(fixture, monkeypatch):
    """The only reads are the early exit of the descent's plain version,
    which runs because the tensors are on the CPU; the CUDA kernel that
    replaces it on a card has none."""
    fp, mp, proj = _port(fixture)
    _validate(fixture, fp, mp)
    stream = StreamingPipeline(fp, mp, MAP_EVERY)
    first = _run_staged(fixture, stream, proj)
    mp.flush()
    with monkeypatch.context() as patch:
        reads = _host_reads(patch)
        second = _run_staged(fixture, stream, proj)
        assert reads and set(reads) == {("__bool__", "find_leaves_plain")}
    for a, b in zip(first[1], second[1]):
        for la, lb in zip(a, b):
            assert torch.equal(la, lb)
    mp.flush()


def test_constructor_checks(fixture):
    fp, mp, _ = _port(fixture)
    off = tlm.LocalMapPipeline(mp.projector, [3, 4], [2, 3], "cpu")
    with pytest.raises(ValueError, match="dense-CRF"):
        StreamingPipeline(fp, off, MAP_EVERY)
    host = tlm.LocalMapPipeline(mp.projector, [3, 4], [2, 3], "cpu",
                                crf=mp.crf, use_device_lattice=False)
    with pytest.raises(ValueError, match="on the device"):
        StreamingPipeline(fp, host, MAP_EVERY)
    fp.device = torch.device("cuda", 0)  # as if built for a card
    with pytest.raises(ValueError, match="frame pipeline on cuda:0"):
        StreamingPipeline(fp, mp, MAP_EVERY)


def test_pack_poses_matches_jax_and_the_4x4_pose(fixture):
    calib = fixture[0]
    proj = MultiProjector.from_calibrations([calib, calib], H, W, 0.5, 15.0)
    jproj = JMultiProjector.from_calibrations([calib, calib], H, W, 0.5, 15.0)
    rng = np.random.default_rng(4)
    poses = []
    for _ in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = q, rng.normal(size=3)
        poses.append(pose.astype(np.float32))
    packed = pack_poses(proj, poses)
    assert packed.shape == (3, 2, 3, 4) and packed.dtype == np.float32
    np.testing.assert_array_equal(packed, jax_pack_poses(jproj, poses))
    mp = tlm.LocalMapPipeline(proj, [3], [2], "cpu")
    for pose, pack in zip(poses, packed):
        rot, trans = mp._node_transforms(pose)
        rot_p, trans_p = mp._node_transforms(pack)
        assert torch.equal(rot, rot_p) and torch.equal(trans, trans_p)
