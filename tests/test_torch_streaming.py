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


def _run_staged(fixture, stream, proj, batch=BATCH):
    """``run_staged`` on the fixture's first ``batch`` keyframes."""
    _, _, stacks, clouds, crgb = fixture
    maps = batch // stream.map_every
    poses = pack_poses(proj, [np.eye(4)] * stream.map_every)
    return stream.run_staged(*[a[:batch] for a in stacks], clouds[:maps], crgb,
                             np.stack([poses] * maps))


def _separate_paths(fixture, fp, mp, batch=BATCH, map_every=MAP_EVERY):
    """The port's frame batch, then one ``run_device`` per map: -> (frame
    labels per frame, map labels per map)."""
    _, _, stacks, clouds, crgb = fixture
    results = fp.run_batch_stacked(*[a[:batch] for a in stacks])
    maps = []
    for m in range(batch // map_every):
        nodes = [tlm.MapNodeFrames(pose=np.eye(4), posteriors=[r.posteriors])
                 for r in results[m * map_every : (m + 1) * map_every]]
        maps.append(mp.run_device(clouds[m], crgb, nodes))
    return [r.labels for r in results], maps


def _assert_labels_equal(got, want):
    for a, b in zip(got, want, strict=True):
        for la, lb in zip(a, b, strict=True):
            assert torch.equal(la, lb)


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


@pytest.mark.parametrize("map_every", [MAP_EVERY, BATCH])
def test_run_staged_equals_the_port_separate_paths(fixture, map_every):
    """The step is the two pipelines' own calls: the port's frame batch and
    ``run_device`` maps give the same labels, with two maps a batch and with
    one."""
    fp, mp, proj = _port(fixture)
    _validate(fixture, fp, mp)
    frames, maps = _run_staged(fixture, StreamingPipeline(fp, mp, map_every),
                               proj)
    assert len(maps) == BATCH // map_every
    want_frames, want_maps = _separate_paths(fixture, fp, mp,
                                             map_every=map_every)
    _assert_labels_equal(maps, want_maps)
    _assert_labels_equal(frames, want_frames)
    mp.flush()


def test_run_staged_checks_the_cloud_count(fixture):
    fp, mp, proj = _port(fixture)
    _, _, stacks, clouds, crgb = fixture
    _validate(fixture, fp, mp)
    with pytest.raises(ValueError, match="3 clouds for 2 maps"):
        StreamingPipeline(fp, mp, MAP_EVERY).run_staged(
            *stacks, np.concatenate([clouds, clouds[:1]]), crgb,
            np.zeros((3, MAP_EVERY, 1, 3, 4), np.float32))


def test_run_staged_validates_an_unchecked_size(fixture):
    """On a fresh pipeline the first map of the cloud size reads its vertex
    count once and marks the size checked, as ``run_device`` does."""
    fp, mp, proj = _port(fixture)
    assert not mp._m_checked
    frames, maps = _run_staged(fixture, StreamingPipeline(fp, mp, MAP_EVERY),
                               proj)
    assert mp._m_checked == {N_POINTS}
    want_frames, want_maps = _separate_paths(fixture, fp, mp)
    _assert_labels_equal(maps, want_maps)
    _assert_labels_equal(frames, want_frames)
    mp.flush()
    assert mp.overflow_maps == 0


def test_run_staged_recovers_after_an_overflow(fixture):
    """A 16-slot bucket on a checked size: the batch's maps are labelled all
    Unknown on the device; once their counts are read the bucket grows, and
    the following batches synchronise again and recover."""
    fp, mp, proj = _port(fixture)
    stream = StreamingPipeline(fp, mp, MAP_EVERY)
    mp._m_bucket = 16
    mp._m_checked.add(N_POINTS)
    _, poisoned = _run_staged(fixture, stream, proj)
    for labels in poisoned:
        assert (labels[0] == 2).all() and (labels[1] == 3).all()
    mp.flush()
    assert mp.overflow_maps == BATCH // MAP_EVERY
    assert mp._m_bucket > 16 and not mp._m_checked
    ref_fp, ref_mp, _ = _port(fixture)
    want_frames, want_maps = _separate_paths(fixture, ref_fp, ref_mp)
    for _ in range(2):
        frames, maps = _run_staged(fixture, stream, proj)
        _assert_labels_equal(maps, want_maps)
        _assert_labels_equal(frames, want_frames)
    mp.flush()
    ref_mp.flush()
    assert mp.overflow_maps == BATCH // MAP_EVERY
    assert mp._m_checked == {N_POINTS}


def test_overflowing_maps_are_counted(fixture):
    mp = _port(fixture)[1]
    assert mp.overflow_maps == 0
    bucket = mp._m_bucket
    mp._pending_m += [tlm._VertexCountProbe(bucket, torch.tensor(bucket + 1)),
                      tlm._VertexCountProbe(bucket, torch.tensor(bucket - 1)),
                      tlm._VertexCountProbe(bucket, torch.tensor(2 * bucket))]
    mp.flush()
    assert mp.overflow_maps == 2
    assert mp._m_bucket >= 2.5 * bucket


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
    # Plain labels need no lattice; the dense CRF needs the device build.
    off = tlm.LocalMapPipeline(mp.projector, [3, 4], [2, 3], "cpu",
                               use_device_lattice=False)
    assert StreamingPipeline(fp, off, MAP_EVERY).maps is off
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
