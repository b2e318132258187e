"""The port's synthetic workload and ``bench_train`` on the CPU.

``rovinasemanticsegmentation_tpu_torch/bench.py`` makes ``bench.py``'s
workload; its generators are held against ``bench.py``'s own closures
(extracted with ``ast``, so ``bench.py`` stays as it is) at VGA, and
``bench_train``'s dataset against ``scripts/bench_train.py``'s. The roofline
arithmetic and the profiler's busy-time union are checked here too.
"""

import ast
import json
import os
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
from rovinasemanticsegmentation_tpu_torch.scripts import bench_train
from rovinasemanticsegmentation_tpu_torch.utils import roofline
from rovinasemanticsegmentation_tpu_torch.utils.profiling import device_busy_ms

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
