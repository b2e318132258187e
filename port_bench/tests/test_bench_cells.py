"""Each cell driven on the CPU at a tiny size, the chip's look skipped: a
sound run comes out correct; a run whose timed path is broken underneath
comes out not correct, for each fault the cell can have; and the control
(the reference in bfloat16 in the program's place) fails one of the cell's
numbers. No cell crosses chips, so the fault of a missing exchange between
chips does not apply."""

import time

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.tests.tiny import SEED, tiny_spec

CELLS = ("stream_crf10_b10", "online_nocrf")


def run(name, trace=False, seconds=1.0):
    torch.manual_seed(0)
    return harness.measure(tiny_spec(name), SEED, seconds, trace, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, trace):
    result, checks = run(name, trace)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device"} | (
        {"breakdown"} if trace else set())
    reported = {m["name"] for m in harness.reported(tiny_spec(name), trace)}
    assert set(result["metrics"]) <= reported
    if not trace:
        assert set(result["metrics"]) == reported
        assert all(m["value"] > 0 for m in result["metrics"].values())


def _alter(labels):
    """Every 50th label moved to the next class."""
    out = labels.clone()
    flat = out.view(-1)
    flat[::50] = (flat[::50] + 1) % (int(flat.max()) + 2)
    return out


def _half_batch(orig):
    def results(self, post, masks, frame_shape):
        out = orig(self, post, masks, frame_shape)
        half = (len(out) + 1) // 2
        return out[:half] + out[:len(out) - half]
    return results


def _half_nodes(orig):
    def fuse(self, points, nodes):
        return orig(self, points, list(nodes)[::2])
    return fuse


def faults():
    """(cell, fault, patch) for each fault each cell can have."""
    from rovinasemanticsegmentation_tpu_torch.pipelines import local_map, single_frame

    mf = local_map.potts_mean_field_multi_t
    crf = local_map.crf_labels_multi
    plain = local_map.plain_labels
    fuse = local_map.LocalMapPipeline.fuse_unaries
    maps_ = single_frame.posterior_maps
    return [
        ("stream_crf10_b10", "state_unchanged", (local_map, "potts_mean_field_multi_t",
         lambda *a: mf(*a[:-1], 0))),
        ("stream_crf10_b10", "half_batch_left_out", (single_frame.SingleFramePipeline,
         "results", _half_batch(single_frame.SingleFramePipeline.results))),
        ("stream_crf10_b10", "map_answer_altered", (local_map, "crf_labels_multi",
         lambda *a: [_alter(l) for l in crf(*a)])),
        ("stream_crf10_b10", "frame_answer_altered", (single_frame, "posterior_maps",
         lambda *a: (lambda p, l: (p, [_alter(x) for x in l]))(*maps_(*a)))),
        ("online_nocrf", "state_unchanged", (local_map.LocalMapPipeline, "fuse_unaries",
         lambda self, pts, nodes: [torch.zeros_like(u) for u in fuse(self, pts, nodes)])),
        ("online_nocrf", "half_batch_left_out", (local_map.LocalMapPipeline, "fuse_unaries",
         _half_nodes(fuse))),
        ("online_nocrf", "map_answer_altered", (local_map, "plain_labels",
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
