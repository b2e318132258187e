"""The cell ``train_recipe_12img`` driven on the CPU at a tiny size (two
80x60 images, 6 variants each, one image checked), the chip's look
skipped: a sound run comes out correct and counts its rows, levels and
nodes; a run whose training path is broken underneath comes out not
correct, for each fault the cell can have; the control (the reference on
rows rounded to bfloat16 in the program's place) fails one of the cell's
numbers; and the images are the fixture recipe's."""

import copy
import time

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.drivers import train as driver
from port_bench.tests.tiny import SEED, TINY_CAMERA

CELL = "train_recipe_12img"


def spec_of():
    spec = harness.load_spec(CELL)
    spec.config = copy.deepcopy(spec.config)
    spec.config["camera"] = dict(TINY_CAMERA)
    spec.config["training_images"] = 2
    spec.traffic = dict(spec.traffic, check_images=1)
    return spec


def run(trace=False, seconds=0.5):
    return harness.measure(spec_of(), SEED, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    result, checks = run(trace)
    assert result["correct"], checks
    assert set(checks) == {"tree_node_mismatch", "train_row_mismatch"}
    assert all(c["value"] == 0.0 for c in checks.values()), checks
    assert result["attempted"] > 0 and result["failed"] == 0
    reported = {m["name"] for m in harness.reported(spec_of(), trace)}
    assert set(result["metrics"]) <= reported
    if not trace:
        assert set(result["metrics"]) == reported == {"setup_s", "device_ms_per_keyframe"}
    else:
        assert "keyframes_per_s.stream" in result["metrics"]


def test_sections_count_rows_levels_and_nodes():
    """A window and a traced section record the rows extracted, the levels
    stepped and the nodes grown over their jobs; a keyframe is an image."""
    spec = spec_of()
    cell = driver.Cell(spec, SEED, "cpu")
    try:
        window = cell.window(0.5)
        traced = cell.traced()
    finally:
        cell.release()
    info, jobs = window["info"], window["attempted"]
    x, _, forest = cell.last
    assert window["keyframes"] == 2 * jobs and info["rows"] == len(x)
    c = info["counters"]
    assert c["train.rows"] == jobs * len(x)
    assert c["train.nodes"] == jobs * sum(forest.node_counts)
    assert jobs * (forest.max_depth + 1) <= c["train.levels"] <= jobs * 31
    assert traced.keyframes == 2 and traced.maps == 0
    assert traced.run["info"]["counters"]["train.rows"] == 2 * len(x)
    assert traced.replay is not None


def _nudged(orig):
    """The first split's threshold one float32 step up."""
    def grow(*args, **kwargs):
        tables = orig(*args, **kwargs)
        for t in tables:
            t.threshold[0] = torch.nextafter(t.threshold[0], torch.tensor(np.inf))
        return tables
    return grow


def _tail_moved(orig):
    def extract(*args, **kwargs):
        features, mask = orig(*args, **kwargs)
        features = features.clone()
        features[:, -1] += 1e-3
        return features, mask
    return extract


def faults():
    """(fault, patch) for each fault the cell can have."""
    from rovinasemanticsegmentation_tpu_torch.cli import train as cli_train
    from rovinasemanticsegmentation_tpu_torch.features import extractor
    from rovinasemanticsegmentation_tpu_torch.train import forest_trainer

    smooth = forest_trainer._smooth_histograms
    return [
        ("variants_dropped", (cli_train, "BRIGHTNESS", (-20, 0))),
        ("threshold_moved", (forest_trainer, "_grow", _nudged(forest_trainer._grow))),
        ("leaves_altered", (forest_trainer, "_smooth_histograms",
                            lambda *a: smooth(*a) * np.float32(1.001))),
        ("rows_altered", (extractor, "extract_features",
                          _tail_moved(extractor.extract_features))),
        ("stopped_early", (forest_trainer.TrainerConfig, "from_config",
                           lambda conf, seed=0: forest_trainer.TrainerConfig(
                               num_trees=4, max_depth=3, min_split_examples=50))),
    ]


@pytest.mark.parametrize("fault", [f for f, _ in faults()])
def test_broken_path_is_not_correct(fault, monkeypatch):
    target, attr, patched = dict(faults())[fault]
    monkeypatch.setattr(target, attr, patched)
    result, checks = run()
    assert not result["correct"], checks


def test_control_fails_a_number():
    spec = spec_of()
    cell = driver.Cell(spec, SEED, "cpu")
    cell.window(0.5)
    cell.release()
    sound = cell.check()
    control = cell.check(control=True)
    assert all(v <= spec.limits[k] for k, v in sound.items()), sound
    assert all(v > spec.limits[k] for k, v in control.items()), control
    assert np.isfinite(list(control.values())).all()


def test_images_are_the_fixture_recipe():
    """At VGA the cell's images are ``make_bench_forest``'s frames of the
    same seed."""
    from rovinasemanticsegmentation_tpu_torch.scripts import make_bench_forest

    frames = make_bench_forest.frames(SEED)
    for rgb, depth, labels in driver.make_images(SEED, 2, 480, 640):
        want = next(frames)
        assert np.array_equal(rgb, want[0]) and np.array_equal(depth, want[1])
        assert all(np.array_equal(a, b) for a, b in zip(labels, want[2]))


def test_reference_trainer_loads_nothing_of_the_port():
    from port_bench.tests.test_bench_imports import loaded, tops

    found = tops(loaded("import json, sys, port_bench.reference.train\n"
                        "print(json.dumps(sorted(sys.modules)))"))
    assert not found & {"rovinasemanticsegmentation_tpu_torch", *harness.FORBIDDEN}
