"""The port's bench and ``bench_train`` on the CPU, at a tiny size.

``rovinasemanticsegmentation_tpu_torch/bench.py`` runs ``bench.py``'s
workload through the port; here at 48x64 frames, 4 keyframes per epoch, a
map of 600 points every 2 keyframes, 2 keyframes per dispatch, 2 timed
epochs per cell, with the kernels' plain versions. Its generators are held
against ``bench.py``'s own closures (extracted with ``ast``, so ``bench.py``
stays as it is) at VGA, and ``bench_train``'s dataset against
``scripts/bench_train.py``'s.
"""

import ast
import hashlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch import bench
from rovinasemanticsegmentation_tpu_torch.models.forest import (
    find_leaves_plain,
    forest_from_numpy,
    load_forest,
)
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
    _VertexCountProbe,
)
from rovinasemanticsegmentation_tpu_torch.scripts import bench_train
from rovinasemanticsegmentation_tpu_torch.utils import roofline
from rovinasemanticsegmentation_tpu_torch.utils.profiling import device_busy_ms

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = bench.Workload(height=48, width=64, keyframes=4, map_every=2,
                      map_points=600, batch=2, curve=(2, 4))
EPOCHS, CURVE_EPOCHS = 2, 1
CELLS = [f"{mode}_b{TINY.batch}" for mode in bench.MODES]


def _function_defs(path, names, within=None):
    """The ``def`` nodes named ``names`` in ``path`` (inside the function
    ``within``, if given), as one module."""
    tree = ast.parse(open(path).read(), path)
    if within is not None:
        tree = next(n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef) and n.name == within)
    defs = [n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    return ast.Module(body=defs, type_ignores=[])


@pytest.fixture(scope="module")
def tiny_run():
    """One whole run at the tiny size: (exit code, emitted lines, the order
    of measurements and emissions)."""
    b = bench.Bench("cpu", 0, TINY)
    events, lines = [], []
    measure = b.measure

    def recorded_measure(mode, batch, epochs, full):
        events.append(("measure", mode, batch, full))
        return measure(mode, batch, epochs, full)

    def emit(line):
        json.dumps(line)  # every line is JSON
        events.append(("emit", line.get("cell") or line.get("curve")
                       or "summary"))
        lines.append(line)

    b.measure = recorded_measure
    rc = bench.run(b, EPOCHS, CURVE_EPOCHS, emit)
    return rc, lines, events


def test_bench_exits_zero_with_curve_cells_then_summary(tiny_run):
    rc, lines, _ = tiny_run
    assert rc == 0
    curve = [line["curve"] for line in lines if "curve" in line]
    assert curve == [f"{m}_b{b}" for m in bench.MODES for b in TINY.curve]
    assert [line["cell"] for line in lines if "cell" in line] == CELLS
    assert lines[-1]["summary"] is True and lines[-1]["correct"] is True
    assert sorted(lines[-1]["keyframes_per_s"]) == sorted(CELLS)
    for line in lines[:len(curve)]:
        assert line["informational"] is True
        assert line["keyframes_per_s"]["n"] == CURVE_EPOCHS


def test_bench_prints_each_cell_as_soon_as_it_is_measured(tiny_run):
    _, _, events = tiny_run
    cells = [e for e in events if e[0] == "measure" and e[3]]
    assert [e[1] for e in cells] == list(bench.MODES)
    for mode in bench.MODES:
        i = events.index(("measure", mode, TINY.batch, True))
        assert events[i + 1] == ("emit", f"{mode}_b{TINY.batch}")
    assert events[-1] == ("emit", "summary")


@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_line_has_its_keys_and_sample_counts(tiny_run, cell):
    _, lines, _ = tiny_run
    line = next(x for x in lines if x.get("cell") == cell)
    assert line["metric"] == "keyframes_per_s" and line["loop"] == "closed"
    kfs = line["keyframes_per_s"]
    assert kfs["n"] == EPOCHS == len(line["epochs"])
    assert kfs["q1"] <= kfs["median"] <= kfs["q3"]
    assert all(r > 0 for r in line["epochs"])
    stages = line["stages"]
    assert "alone" in stages["overlap"] and "overlaps" in stages["overlap"]
    assert stages["frame_path_ms_per_kf"]["n"] == bench.STAGE_REPS
    assert stages["map_path_ms_per_map"]["n"] == line["maps_per_epoch"] == 2
    # The plain versions on the CPU launch no kernel, and no device number
    # is reported from a CPU run.
    assert line["launches"] == {"pack_lab": 0, "patches": 0,
                                "forest_descent": 0}
    assert line["trace"] is None
    assert line["device"]["platform"] == "cpu"
    assert line["replay_equal"] is True
    assert line["lattice_overflow_maps"] == 0
    # the validating map, then the warm-up, timed, stage-row, traced and
    # replayed epochs' maps
    assert line["maps_attempted"] == 1 + line["maps_per_epoch"] * (
        1 + EPOCHS + 1 + 2)
    with open(bench.FIXTURE, "rb") as f:
        assert line["fixture"] == hashlib.sha256(f.read()).hexdigest()[:16]
    assert line["workload"]["map_points"] == TINY.map_points
    assert line["correct"] is True


def test_bench_checks_workers_equal_stream_and_device_equal_cpu(tiny_run):
    _, lines, _ = tiny_run
    checks = next(x for x in lines if "cell" in x)["checks"]
    assert checks["workers_equal_stream_frame_labels"] is True
    assert checks["workers_equal_stream_map_labels"] is True
    cpu = checks["device_vs_cpu"]
    assert cpu["ok"] and cpu["mean_field_max_abs_err"] == 0.0
    assert cpu["lattice_vertices"] <= cpu["vertex_bucket"]


def test_workers_labels_equal_stream_labels():
    b = bench.Bench("cpu", 1, TINY)
    assert b.check_modes_agree() == (True, True)


def test_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the bench would run for real")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
    out = subprocess.run(
        [sys.executable, "-m", "rovinasemanticsegmentation_tpu_torch.bench"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"cell"' not in out.stdout


def test_workload_rejects_a_batch_that_splits_a_map():
    with pytest.raises(ValueError):
        bench.Workload(batch=4)
    with pytest.raises(ValueError):
        bench.Workload(keyframes=30, map_every=5, batch=10, curve=(20,))


@pytest.fixture(scope="module")
def bench_py_workload():
    """``bench.py``'s ``make_depth`` and ``make_cloud`` closures run at VGA
    on seed 0, in its order: 30 keyframes, then the cloud."""
    ns = {"np": np, "h": 480, "w": 640, "MAP_EVERY": 5, "MAP_POINTS": 30000}
    code = _function_defs(os.path.join(ROOT, "bench.py"),
                          ["make_depth", "make_cloud"], within="_run_bench")
    exec(compile(code, "bench.py", "exec"), ns)
    rng = np.random.default_rng(0)
    ns["frames"] = [
        (rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
         ns["make_depth"](rng))
        for _ in range(30)
    ]
    return ns["frames"], ns["make_cloud"](rng)


@pytest.fixture(scope="module")
def port_workload():
    return bench.make_workload(0, bench.Workload())


def test_make_depth_equals_bench_py_at_vga(bench_py_workload, port_workload):
    want, got = bench_py_workload[0], port_workload[0]
    assert len(got) == len(want) == 30
    for (rgb_g, depth_g), (rgb_w, depth_w) in zip(got, want):
        assert depth_g.dtype == depth_w.dtype == np.uint16
        np.testing.assert_array_equal(rgb_g, rgb_w)
        np.testing.assert_array_equal(depth_g, depth_w)


def test_make_cloud_equals_bench_py_at_vga(bench_py_workload, port_workload):
    (pts_w, cols_w), (pts_g, cols_g) = bench_py_workload[1], port_workload[1]
    assert pts_g.shape == cols_g.shape == (30000, 3)
    assert pts_g.dtype == cols_g.dtype == np.float32
    np.testing.assert_array_equal(pts_g, pts_w)
    np.testing.assert_array_equal(cols_g, cols_w)


def test_make_depth_at_a_small_frame():
    depth = bench.make_depth(np.random.default_rng(3), 48, 64)
    assert depth.shape == (48, 64) and depth.dtype == np.uint16
    assert 0 < (depth == 0).mean() < 0.1
    assert depth.max() <= 15500


def test_overflowing_maps_are_counted():
    mp = bench.Bench("cpu", 0, TINY).map_pipeline()
    assert mp.overflow_maps == 0
    bucket = mp._m_bucket
    mp._pending_m += [_VertexCountProbe(bucket, torch.tensor(bucket + 1)),
                      _VertexCountProbe(bucket, torch.tensor(bucket - 1)),
                      _VertexCountProbe(bucket, torch.tensor(2 * bucket))]
    mp.flush()
    assert mp.overflow_maps == 2
    assert mp._m_bucket >= 2.5 * bucket


def test_bench_train_dataset_equals_the_jax_script():
    n = 500
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "bench_train.py")).read())
    main = next(x for x in tree.body
                if isinstance(x, ast.FunctionDef) and x.name == "main")
    body = [x for x in main.body if isinstance(x, ast.Assign)
            and x.targets[0].id in ("rng", "d", "feats", "labels")]
    assert [x.targets[0].id for x in body] == ["rng", "d", "feats", "labels"]
    ns = {"np": np, "n": n}
    exec(compile(ast.Module(body=body, type_ignores=[]), "bench_train.py",
                 "exec"), ns)
    feats, labels = bench_train.make_dataset(n)
    assert feats.shape == (n, 366) and labels.shape == (n, 2)
    np.testing.assert_array_equal(feats, ns["feats"])
    np.testing.assert_array_equal(labels, ns["labels"])


@pytest.mark.parametrize("bins", [0, 16])
def test_bench_train_prints_its_line_on_the_cpu(bins, capsys):
    out = bench_train.main(["1500", "2", str(bins), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["metric"] == "train_points_per_sec" and line["value"] > 0
    assert line["split_bins"] == bins and line["trees"] == 2
    assert line["nodes"] == sum(line["node_counts"]) > 2
    assert line["device"]["platform"] == "cpu"


def test_bench_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; bench_train would run for real")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_train.main(["100"])


def test_roofline_descent_reads_follow_the_plain_descent():
    forest = forest_from_numpy(load_forest(bench.FIXTURE, class_counts=[8, 9]),
                               "cpu")
    feats = torch.from_numpy(
        np.random.default_rng(4).normal(size=(300, 366)).astype(np.float32))
    reads = roofline.descent_reads(feats, forest)
    leaves = find_leaves_plain(feats, forest.records, forest.max_depth,
                               forest.feat_bits)
    assert torch.equal(reads["leaf_ids"], leaves)
    assert reads["levels"] >= 300 * forest.num_trees
    assert 0 < reads["leaves"] <= reads["records"]
    assert reads["touched"].shape == feats.shape


def test_roofline_bound_takes_the_larger_time():
    by_bytes = roofline.bound(3.35e9, {"alu": 1}, 1)
    assert by_bytes["bound_by"] == "bytes"
    assert by_bytes["bound_ms"] == pytest.approx(1.0)
    by_ops = roofline.bound(0, {"fma": 6, "alu": 1},
                            int(roofline.PIPE_OPS_PER_S))
    assert by_ops["bound_by"] == "operations"
    assert by_ops["bound_ms"] == pytest.approx(6000.0)


def test_device_busy_ms_counts_overlaps_once():
    def event(start, end):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=start, end=end))

    events = [event(50, 80), event(0, 100), event(300, 400), event(350, 500),
              event(600, 600)]
    assert device_busy_ms(events) == pytest.approx(0.3)
    assert device_busy_ms([]) == 0


@pytest.mark.cuda
def test_bench_on_the_card_traces_each_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    lines = []
    assert bench.run(bench.Bench("cuda", 0, TINY), EPOCHS, 0, lines.append) == 0
    cells = [line for line in lines if "cell" in line]
    assert [line["cell"] for line in cells] == CELLS
    for line in cells:
        assert line["correct"] and line["device"]["platform"] == "gpu"
        assert line["launches"]["patches"] == EPOCHS * TINY.keyframes
        trace = line["trace"]
        assert 0 < trace["device_busy_ms_per_keyframe"]
        assert 0 <= trace["device_idle_share"] < 1
        for name, k in trace["kernels"].items():
            assert k["launches"] > 0 and 0 < k["share_of_bound"], name
        stages = trace["stages"]
        assert stages["frame path"]["activities_per_keyframe"] > 0
        for name in bench.MAP_SPANS:
            assert stages[name]["device_ms_per_map"] > 0, name
