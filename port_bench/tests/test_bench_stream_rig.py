"""The cell ``stream_3cam_crf10_b10`` driven on the CPU at a tiny size (80x60
frames, 2 staged batches of 2 nodes of the rig's three cameras, a map of
1500 points a batch), the chip's look skipped: a sound run comes out
correct and counts its frames, descents and views; a run whose timed path
is broken underneath comes out not correct, for each fault the cell can
have; the control (the reference in bfloat16 in the program's place) fails
one of the cell's numbers."""

import time

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.tests.test_bench_cells import _alter
from port_bench.tests.tiny import SEED, tiny_spec

CELL = "stream_3cam_crf10_b10"


def spec_of():
    spec = tiny_spec(CELL)
    spec.traffic = dict(spec.traffic, pool=12, batch=2, map_every=2, map_points=1500,
                        check_batches=1, trace_batches=1)
    return spec


def run(trace=False, seconds=1.0):
    torch.manual_seed(0)
    return harness.measure(spec_of(), SEED, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    result, checks = run(trace)
    assert result["correct"], checks
    assert set(checks) == {"frame_label_mismatch", "map_label_mismatch"} | (
        {"replay_label_mismatch"} if trace else set())
    assert result["attempted"] > 0 and result["failed"] == 0
    reported = {m["name"] for m in harness.reported(spec_of(), trace)}
    assert set(result["metrics"]) <= reported
    if not trace:
        assert set(result["metrics"]) == reported == {"setup_s", "device_ms_per_keyframe"}


def test_sections_count_frames_and_views():
    """A window and a traced section record the frames ``run_staged`` took
    and the views the maps fused, three a node; a keyframe is a node. The
    CPU's plain descent launches no kernel."""
    spec = spec_of()
    cell = harness.load_module("drivers", spec.traffic["driver"]).Cell(spec, SEED, "cpu")
    try:
        window = cell.window(1.0)
        traced = cell.traced()
    finally:
        cell.release()
    info = window["info"]
    assert info["cameras"] == 3 and window["keyframes"] == 2 * info["batches"] > 0
    assert info["frames"] == 3 * window["keyframes"]
    assert info["counters"] == {"streaming.frames": info["frames"],
                                "forest_cuda.launches": 0,
                                "fusion.views": info["frames"]}
    # the plain and the profiled pass of one batch each, not the replay
    assert traced.keyframes == 2 and traced.maps == 1
    assert traced.run["info"]["counters"] == {"streaming.frames": 12,
                                              "forest_cuda.launches": 0,
                                              "fusion.views": 12}


def _cameras_reversed(orig):
    def node(pose, posteriors):
        return orig(pose, posteriors[::-1])
    return node


def faults():
    """(fault, patch) for each fault the cell can have."""
    from rovinasemanticsegmentation_tpu_torch.pipelines import (
        local_map, single_frame, streaming)
    from port_bench.tests.test_bench_rig import _drop_camera

    mf = local_map.potts_mean_field_multi_t
    crf = local_map.crf_labels_multi
    maps_ = single_frame.posterior_maps
    return [
        ("state_unchanged", (local_map, "potts_mean_field_multi_t",
                             lambda *a: mf(*a[:-1], 0))),
        ("map_answer_altered", (local_map, "crf_labels_multi",
                                lambda *a: [_alter(l) for l in crf(*a)])),
        ("frame_answer_altered", (single_frame, "posterior_maps",
         lambda *a: (lambda p, l: (p, [_alter(x) for x in l]))(*maps_(*a)))),
        ("camera_dropped", (local_map.LocalMapPipeline, "fuse_unaries",
                            _drop_camera(local_map.LocalMapPipeline.fuse_unaries))),
        ("cameras_reversed", (streaming, "MapNodeFrames",
                              _cameras_reversed(streaming.MapNodeFrames))),
    ]


@pytest.mark.parametrize("fault", [f for f, _ in faults()])
def test_broken_path_is_not_correct(fault, monkeypatch):
    target, attr, patched = dict(faults())[fault]
    monkeypatch.setattr(target, attr, patched)
    result, checks = run()
    assert not result["correct"], checks


def test_control_fails_a_number():
    spec = spec_of()
    cell = harness.load_module("drivers", spec.traffic["driver"]).Cell(spec, SEED, "cpu")
    cell.window(1.0)
    cell.release()
    sound = cell.check()
    control = cell.check(control=True)
    assert all(v <= spec.limits[k] for k, v in sound.items()), sound
    assert any(v > spec.limits[k] for k, v in control.items()), control
    assert np.isfinite(list(control.values())).all()

