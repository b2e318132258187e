"""PyTorch port: serving end to end against the JAX Segmenter (dense CRF off
and on), the HTTP services, device selection, and the port's independence
from JAX."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.models.forest import random_forest
from rovinasemanticsegmentation_tpu.serve import segmenter as jseg
from rovinasemanticsegmentation_tpu.utils.config import Config
from rovinasemanticsegmentation_tpu_torch.device import resolve_device
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import CrfParams
from rovinasemanticsegmentation_tpu_torch.serve import segmenter as tseg
from rovinasemanticsegmentation_tpu_torch.serve.services import (
    SegmentationServiceServer,
)

from test_serve import CONFIG, H, W, make_calib

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPICS = ["/camera_front/rgb/image", "/camera_front/depth/image"]


def _forest():
    """A random forest whose thresholds fall inside the features' ranges
    (Lab patch values 0..255, then depth, height and angle)."""
    rng = np.random.default_rng(0)
    forest = random_forest(
        rng, num_trees=2, depth=6, num_features=78, class_counts=[3, 4],
        max_nodes=61,
    )
    f = forest.split_feature
    hi = np.where(f < 75, 255.0, 3.0)
    forest.threshold[:] = rng.uniform(0.0, hi).astype(np.float32)
    return forest


def _pose(x):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = x
    return p


def _drive(seg, n_frames=3, n_points=60, with_rgb=False):
    """Frames 1..n with distinct poses, one map over them plus a node whose
    frame never arrived (with a cloud RGB if ``with_rgb``); returns the
    map's flattened labels."""
    seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
    seg.stop()
    rng = np.random.default_rng(1)
    for s in range(1, n_frames + 1):
        seg.push_color("camera_front", s,
                       rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        seg.push_depth("camera_front", s,
                       rng.integers(600, 9000, (H, W)).astype(np.uint16))
        assert seg.on_new_node(tseg.MapNode(s, _pose(0.1 * s), [s]))
    pts = np.stack(
        [rng.uniform(-0.5, 0.7, n_points), rng.uniform(-0.4, 0.4, n_points),
         rng.uniform(1.5, 3.0, n_points)], axis=1,
    ).astype(np.float32)
    rgb = (rng.uniform(0, 1, (n_points, 3)).astype(np.float32)
           if with_rgb else None)
    # Seq 0 was never segmented: fusion must skip it (segmenter.cpp:618-621).
    nodes = [tseg.MapNode(s, _pose(0.1 * s), [s])
             for s in range(0, n_frames + 1)]
    seg.on_new_local_map(tseg.LocalMapData(5, nodes, pts, rgb))
    seg.drain()
    assert seg.stored_semantics_ids() == [5]
    _, labels = seg.get_local_map_segmentation(5, ["material", "object"])
    return np.asarray(labels)


def test_segmenter_map_labels_equal_jax():
    forest = _forest()
    want = _drive(jseg.Segmenter(Config(data=CONFIG), TOPICS, forest=forest))
    got = _drive(tseg.Segmenter(Config(data=CONFIG), TOPICS, "cpu",
                                forest=forest))
    np.testing.assert_array_equal(got, want)
    assert (got[:60] != 2).any()  # some points are labelled, not all Unknown


def test_http_services_answer():
    seg = tseg.Segmenter(Config(data=CONFIG), TOPICS, "cpu", forest=_forest())
    labels = _drive(seg)
    server = SegmentationServiceServer(seg)
    server.start()
    try:
        base = server.address + "/semantic_segmentation"
        with urllib.request.urlopen(base + "/local_map_ids") as r:
            assert json.load(r)["local_map_ids"] == [5]
        with urllib.request.urlopen(base + "/information") as r:
            assert json.load(r)["class_counts"] == [3, 4]
        req = urllib.request.Request(
            base + "/get_local_map_segmentation",
            data=json.dumps({"local_map_id": 5,
                             "segmentation_layers": ["material", "object"]}
                            ).encode(),
            method="POST",
        )
        with urllib.request.urlopen(req) as r:
            assert json.load(r)["point_labels"] == labels.tolist()
    finally:
        server.stop()


def test_external_hook_path():
    from rovinasemanticsegmentation_tpu_torch.serve.services import (
        heuristic_single_frame_segmentation,
    )

    seg = tseg.Segmenter(
        Config(data=CONFIG), TOPICS, "cpu",
        external_segmentation=lambda rgb, d3:
            heuristic_single_frame_segmentation(rgb, d3, [3, 4]),
    )
    labels = _drive(seg)
    assert labels.shape == (2 * 60,)


def test_dense_crf_config_reaches_the_map_pipeline():
    assert CrfParams(use_dense_crf=True).use_dense_crf
    conf = dict(CONFIG, use_dense_crf=True, dcrf_iterations=3)
    seg = tseg.Segmenter(Config(data=conf), TOPICS, "cpu", forest=_forest())
    seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
    seg.stop()
    assert seg._map_pipeline.crf.use_dense_crf
    assert seg._map_pipeline.crf.iterations == 3


def test_segmenter_crf_map_labels_equal_jax():
    forest = _forest()
    conf = Config(data=dict(CONFIG, use_dense_crf=True, dcrf_iterations=3))
    want = _drive(jseg.Segmenter(conf, TOPICS, forest=forest), with_rgb=True)
    got = _drive(tseg.Segmenter(conf, TOPICS, "cpu", forest=forest),
                 with_rgb=True)
    np.testing.assert_array_equal(got, want)
    assert (got != np.repeat([2, 3], 60)).any()  # not all Unknown


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_node_cli_builds_cpu_segmenter(tmp_path):
    from rovinasemanticsegmentation_tpu.models.forest import save_forest
    from rovinasemanticsegmentation_tpu_torch.cli.node import build_segmenter

    conf = tmp_path / "config.json"
    conf.write_text(json.dumps(CONFIG))
    forest_path = str(tmp_path / "forest.dat")
    save_forest(forest_path, _forest())
    seg = build_segmenter({
        "conf": str(conf), "topics": json.dumps(TOPICS),
        "forest": forest_path, "device": "cpu",
    })
    assert seg.device == torch.device("cpu")
    assert seg.layer_class_counts == [3, 4]


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rovinasemanticsegmentation_tpu'] = None\n"
        "import rovinasemanticsegmentation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() "
        "if v is not None}\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    pkg = "rovinasemanticsegmentation_tpu_torch."
    assert {pkg + m for m in (
        "ops.forest_staged_cuda", "ops.patches_separable_cuda",
        "train.random", "train.forest_trainer", "train.boosting",
        "models.tools", "cli.train", "utils.checkpoint", "utils.cvio",
        "utils.data_io", "scripts.make_bench_forest",
        "scripts.exp_descent", "scripts.exp_patches",
        "fusion.unaries", "models.crf2d_device", "pipelines.streaming",
        "cli.evaluate", "cli.test", "cli.test_multi", "cli.dense_inference",
        "utils.config", "utils.calibration", "utils.labels", "utils.imageio",
        "utils.metrics", "features.dataset", "serve.camera", "native",
        "ops.feature_rows", "bench", "scripts.bench_train", "utils.roofline",
        "scripts.bench_dense_inference", "scripts.profile_train",
        "scripts.stage_timing", "scripts.profile_slope",
        "scripts.profile_normals", "scripts.profile_map",
        "scripts.exp_lattice", "scripts.exp_filter",
    )} <= names


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
