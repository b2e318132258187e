"""The plain reference against the port's CPU path at a tiny size: frame
posteriors and labels, fused unaries, and map labels with the dense CRF off
and on, equal. The reference itself imports nothing of the port."""

import numpy as np
import pytest
import torch

from port_bench import gen
from port_bench.common import FILL, Setting
from port_bench.reference import frame as rf
from port_bench.reference import fusion as rfu
from port_bench.reference import lattice as rl
from port_bench.tests.tiny import SEED, tiny_spec


@pytest.fixture(scope="module")
def both_sides():
    from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
    from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
    from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
        SingleFramePipeline)
    from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
    from rovinasemanticsegmentation_tpu_torch.utils.config import Config

    spec = tiny_spec("stream_crf10_b10")
    s = Setting(spec.config, spec.root)
    frames, rng = gen.make_pool(SEED, 3, s.h, s.w)
    cloud = gen.make_cloud(rng, frames, s.focal, s.h, s.w, 3, 900)
    calib = Calibration(intrinsic=s.intrinsic, rotation=np.eye(3),
                        translation=np.zeros(3))
    fp = SingleFramePipeline(FeatureConfig.from_config(Config(data=spec.config)),
                             load_forest(s.forest_path, class_counts=list(s.class_counts)),
                             s.stride, "cpu", fill_value=FILL)
    port = fp.run_batch([f[0] for f in frames], [f[1] for f in frames], [calib] * 3)
    forest = rf.Forest(rf.read_forest(s.forest_path, s.class_counts), "cpu")
    ref = [rf.run_frame(torch.from_numpy(rgb), torch.from_numpy(d.astype(np.int32)),
                        s.kinv, np.eye(3), np.zeros(3), s.frame_config, forest,
                        s.class_counts, FILL) for rgb, d in frames]
    return spec, s, calib, cloud, port, ref


def test_frame_path_equal(both_sides):
    *_, port, ref = both_sides
    for p, (posts, labels) in zip(port, ref):
        for a, b in zip(p.posteriors, posts):
            assert torch.equal(a, b)
        for a, b in zip(p.labels, labels):
            assert torch.equal(a, b)


@pytest.mark.parametrize("crf", [False, True])
def test_map_path_equal(both_sides, crf):
    from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
    from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
        CrfParams, LocalMapPipeline, MapNodeFrames)

    spec, s, calib, (pts, cols), port, ref = both_sides
    conf = spec.config
    poses = [np.eye(4, dtype=np.float32) for _ in port]
    for i, p in enumerate(poses):
        p[0, 3] = 0.08 * i
    proj = MultiProjector.from_calibrations([calib], s.h, s.w, min_distance=0.5,
                                            max_distance=15.0)
    mp = LocalMapPipeline(proj, s.class_counts, s.unknown_labels, "cpu",
                          crf=CrfParams(use_dense_crf=crf, iterations=10))
    nodes = [MapNodeFrames(pose=q, posteriors=[r.posteriors]) for q, r in zip(poses, port)]
    p_t, c_t = torch.from_numpy(pts), torch.from_numpy(cols)
    got = mp.run_device(p_t, c_t, nodes)
    mp.flush()
    u = rfu.unaries(p_t, [(q, posts) for q, (posts, _) in zip(poses, ref)],
                    s.intrinsic, np.eye(3), np.zeros(3), 0.5, 15.0, s.h, s.w)
    assert torch.equal(u, torch.cat(mp.fuse_unaries(p_t, nodes), dim=1))
    want = (rl.crf_labels(u, p_t, c_t, conf, s.class_counts, s.unknown_labels) if crf
            else rfu.plain_labels(u, s.class_counts, s.unknown_labels))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
