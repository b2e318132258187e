"""The cells ``online_crf10`` and ``online_3cam_nocrf`` driven on the CPU at
a tiny size, the chip's look skipped: a sound run comes out correct; a run
whose timed path is broken underneath comes out not correct, for each fault
the cell can have; the control (the reference in bfloat16 in the program's
place) fails one of the cell's numbers; and the rig's reference with one
camera is the one-camera reference."""

import time

import numpy as np
import pytest
import torch

from port_bench import gen, harness
from port_bench.common import FILL, Setting
from port_bench.reference import frame as rf
from port_bench.reference import fusion as rfu
from port_bench.reference import rig as rr
from port_bench.tests.test_bench_cells import _alter
from port_bench.tests.test_bench_imports import loaded, tops
from port_bench.tests.tiny import SEED, tiny_spec

CELLS = ("online_crf10", "online_3cam_nocrf")


def spec_of(name):
    """``tiny_spec``, with a traced run's untraced window cut to 5 s: the
    tiny cells' nodes are due at 20/s, more than a loaded CPU segments."""
    spec = tiny_spec(name)
    spec.traffic = dict(spec.traffic, layer_window_s=5)
    return spec


def run(name, trace=False, seconds=1.0):
    torch.manual_seed(0)
    return harness.measure(spec_of(name), SEED, seconds, trace, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, trace):
    result, checks = run(name, trace)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    reported = {m["name"] for m in harness.reported(spec_of(name), trace)}
    assert set(result["metrics"]) <= reported
    if not trace:
        assert set(result["metrics"]) == reported == {"setup_s", "device_ms_per_keyframe"}


def test_rig_window_counts_frames_and_views():
    """The rig cell's window records the frames the frame worker segmented
    and the views the map worker projected: three a node."""
    spec = tiny_spec("online_3cam_nocrf")
    cell = harness.load_module("drivers", spec.traffic["driver"]).Cell(spec, SEED, "cpu")
    try:
        info = cell.window(1.0)["info"]
    finally:
        cell.release()
    assert info["cameras"] == 3
    assert info["counters"] == {"segmenter.frames": 3 * info["nodes"],
                                "fusion.views": 3 * info["nodes"]}


def _swap_cameras(orig):
    def initialize(self, order, calibrations, size):
        return orig(self, order, [calibrations[0], calibrations[2], calibrations[1]], size)
    return initialize


def _drop_camera(orig):
    def fuse(self, points, nodes):
        from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import MapNodeFrames

        return orig(self, points, [MapNodeFrames(n.pose, n.posteriors[:2] + [None])
                                   for n in nodes])
    return fuse


def faults():
    """(cell, fault, patch) for each fault each cell can have."""
    from rovinasemanticsegmentation_tpu_torch.pipelines import local_map
    from rovinasemanticsegmentation_tpu_torch.serve import segmenter

    mf = local_map.potts_mean_field_multi_t
    crf = local_map.crf_labels_multi
    plain = local_map.plain_labels
    return [
        ("online_crf10", "state_unchanged", (local_map, "potts_mean_field_multi_t",
         lambda *a: mf(*a[:-1], 0))),
        ("online_crf10", "map_answer_altered", (local_map, "crf_labels_multi",
         lambda *a: [_alter(l) for l in crf(*a)])),
        ("online_3cam_nocrf", "extrinsic_swapped", (segmenter.Segmenter,
         "initialize_projector", _swap_cameras(segmenter.Segmenter.initialize_projector))),
        ("online_3cam_nocrf", "camera_dropped", (local_map.LocalMapPipeline, "fuse_unaries",
         _drop_camera(local_map.LocalMapPipeline.fuse_unaries))),
        ("online_3cam_nocrf", "map_answer_altered", (local_map, "plain_labels",
         lambda u, unk: _alter(plain(u, unk)))),
    ]


FAULTS = [(c, f) for c, f, _ in faults()]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    target, attr, patched = next(p for c, f, p in faults() if (c, f) == (name, fault))
    monkeypatch.setattr(target, attr, patched)
    result, checks = run(name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_number(name):
    spec = tiny_spec(name)
    driver = harness.load_module("drivers", spec.traffic["driver"])
    cell = driver.Cell(spec, SEED, "cpu")
    cell.window(1.0)
    cell.release()
    sound = cell.check()
    control = cell.check(control=True)
    assert all(v <= spec.limits[k] for k, v in sound.items()), sound
    assert any(v > spec.limits[k] for k, v in control.items()), control
    assert np.isfinite(list(control.values())).all()


def test_rig_reference_with_one_camera_is_the_fusion_reference():
    """``reference/rig.py`` over one camera at the identity extrinsic, with
    poses that translate, equals ``reference/fusion.py::unaries``; a camera
    without posteriors adds nothing."""
    spec = tiny_spec("online_nocrf")
    s = Setting(spec.config, spec.root)
    frames, rng = gen.make_pool(SEED, 3, s.h, s.w)
    cloud, _ = gen.make_cloud(rng, frames, s.focal, s.h, s.w, 3, 900)
    forest = rf.Forest(rf.read_forest(s.forest_path, s.class_counts), "cpu")
    posts = [rf.run_frame(torch.from_numpy(rgb), torch.from_numpy(d.astype(np.int32)),
                          s.kinv, np.eye(3), np.zeros(3), s.frame_config, forest,
                          s.class_counts, FILL)[0] for rgb, d in frames]
    poses = [np.eye(4, dtype=np.float32) for _ in frames]
    for i, p in enumerate(poses):
        p[:3, 3] = [0.08 * i, 0.01 * i, 0.0]
    pts = torch.from_numpy(cloud)
    want = rfu.unaries(pts, list(zip(poses, posts)), s.intrinsic, np.eye(3), np.zeros(3),
                       0.5, 1e9, s.h, s.w)
    one = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    got = rr.unaries(pts, [(q, [p]) for q, p in zip(poses, posts)], s.intrinsic, one,
                     0.5, 1e9, s.h, s.w)
    assert torch.equal(got, want)
    two = one + [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    got = rr.unaries(pts, [(q, [p, None]) for q, p in zip(poses, posts)], s.intrinsic, two,
                     0.5, 1e9, s.h, s.w)
    assert torch.equal(got, want)


def test_rig_reference_loads_nothing_of_the_port():
    found = tops(loaded("import json, sys\nimport port_bench.reference.rig\n"
                        "print(json.dumps(sorted(sys.modules)))"))
    assert "port_bench" in found
    assert not found & {"rovinasemanticsegmentation_tpu_torch", *harness.FORBIDDEN}
