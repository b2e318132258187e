"""The port's own copies of the JAX package's jax-free modules.

The port imports nothing of ``rovinasemanticsegmentation_tpu``, so it keeps
copies of ``utils/{config,calibration,labels,imageio,metrics,cvio,
data_io,mcmc}.py``, ``features/dataset.py``, ``serve/camera.py`` and ``native/``. Each copy is
held here against its original on the same inputs; the native library of
the port builds from the port's own C++ sources.
"""

import ast
import io
import json
import os

import numpy as np
import pytest

from rovinasemanticsegmentation_tpu import native as j_native
from rovinasemanticsegmentation_tpu.features import dataset as j_dataset
from rovinasemanticsegmentation_tpu.serve import camera as j_camera
from rovinasemanticsegmentation_tpu.utils import calibration as j_calibration
from rovinasemanticsegmentation_tpu.utils import config as j_config
from rovinasemanticsegmentation_tpu.utils import cvio as j_cvio
from rovinasemanticsegmentation_tpu.utils import data_io as j_data_io
from rovinasemanticsegmentation_tpu.utils import imageio as j_imageio
from rovinasemanticsegmentation_tpu.utils import labels as j_labels
from rovinasemanticsegmentation_tpu.utils import mcmc as j_mcmc
from rovinasemanticsegmentation_tpu.utils import metrics as j_metrics
from rovinasemanticsegmentation_tpu_torch import native as t_native
from rovinasemanticsegmentation_tpu_torch.features import dataset as t_dataset
from rovinasemanticsegmentation_tpu_torch.serve import camera as t_camera
from rovinasemanticsegmentation_tpu_torch.utils import calibration as t_calibration
from rovinasemanticsegmentation_tpu_torch.utils import config as t_config
from rovinasemanticsegmentation_tpu_torch.utils import cvio as t_cvio
from rovinasemanticsegmentation_tpu_torch.utils import data_io as t_data_io
from rovinasemanticsegmentation_tpu_torch.utils import imageio as t_imageio
from rovinasemanticsegmentation_tpu_torch.utils import labels as t_labels
from rovinasemanticsegmentation_tpu_torch.utils import mcmc as t_mcmc
from rovinasemanticsegmentation_tpu_torch.utils import metrics as t_metrics

from test_cli import MATERIAL, OBJECT, build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "rovinasemanticsegmentation_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    """Absolute names of every module an ``import`` in ``path`` names."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    offenders = [
        (os.path.relpath(path, ROOT), name)
        for path in _port_sources()
        for name in _imported_modules(path)
        if name.split(".")[0] in ("rovinasemanticsegmentation_tpu", "jax")
    ]
    assert offenders == []


@pytest.fixture
def config_files(tmp_path):
    (tmp_path / "split.json").write_text(json.dumps(["a", "b"]))
    data = {
        "root_dir": str(tmp_path) + "/", "color_dir": "rgb/", "stride": 2,
        "depth_min": 0.5, "flag": True, "split": "split.json",
        "nested": {"x": [1, 2]}, "color_codings": [{"name": "m",
                                                     "coding": MATERIAL}],
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(data))
    return str(path)


def test_config_copy_matches(config_files):
    argv = ["--conf", config_files, "--stride", "5", "--extra", '{"k": 1}']
    (jc, jp), (tc, tp) = (m.load_config_from_argv(list(argv))
                          for m in (j_config, t_config))
    assert jp == tp
    assert jc.to_dict() == tc.to_dict()
    for key in ("stride", "depth_min", "flag", "extra", "nested"):
        assert jc.get(key) == tc.get(key)
    assert jc.get_int("stride") == tc.get_int("stride") == 5
    assert jc.get_path("color_dir") == tc.get_path("color_dir")
    assert jc.get_from_file("split") == tc.get_from_file("split") == ["a", "b"]
    assert jc.get_raw("color_codings") == tc.get_raw("color_codings")
    assert jc.get("missing", 7) == tc.get("missing", 7) == 7
    with pytest.raises(t_config.KeyNotFoundException):
        tc.get("missing")
    for bad in (["--a"], ["a", "1"]):
        with pytest.raises(ValueError):
            t_config.parse_cli_overrides(bad)
        with pytest.raises(ValueError):
            j_config.parse_cli_overrides(bad)


@pytest.mark.parametrize("rotation", [
    {"format": "q3", "data": [0.1, -0.2, 0.3]},
    {"format": "q4", "data": [0.1, -0.2, 0.3, 0.9]},
    {"format": "r3", "data": [0, 1, 0, -1, 0, 0, 0, 0, 1]},
])
def test_calibration_copy_matches(tmp_path, rotation):
    path = tmp_path / "calib.json"
    path.write_text(json.dumps({
        "intrinsic": [525.0, 0, 320, 0, 525.0, 240, 0, 0, 1],
        "translation": [0.1, -0.2, 1.5], "rotation": rotation,
    }))
    j, t = (m.Calibration(filename=str(path)) for m in (j_calibration,
                                                        t_calibration))
    for attr in ("intrinsic", "intrinsic_inverse", "rotation", "translation",
                 "extrinsic"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
    t.save_to_file(str(tmp_path / "saved.json"))
    again = j_calibration.Calibration(filename=str(tmp_path / "saved.json"))
    np.testing.assert_array_equal(again.extrinsic, j.extrinsic)


def test_label_coding_copy_matches():
    rng = np.random.default_rng(0)
    for coding in (MATERIAL, OBJECT):
        j, t = j_labels.RgbLabelConversion(coding), t_labels.RgbLabelConversion(coding)
        labels = rng.integers(-1, j.label_count, (20, 30)).astype(np.int8)
        rgb = j.label_to_rgb(labels)
        np.testing.assert_array_equal(t.label_to_rgb(labels), rgb)
        noisy = rgb.copy()
        noisy[::7, ::5] = 255  # colours outside the coding
        np.testing.assert_array_equal(t.rgb_to_label(noisy),
                                      j.rgb_to_label(noisy))
        assert t.valid_label_count == j.valid_label_count
    codings = [{"name": "material", "coding": MATERIAL},
               {"name": "object", "coding": OBJECT}]
    for jl, tl in zip(j_labels.parse_color_codings(codings),
                      t_labels.parse_color_codings(codings)):
        assert (jl.name, jl.class_names, jl.class_colors, jl.unknown_label) \
            == (tl.name, tl.class_names, tl.class_colors, tl.unknown_label)
    assert t_labels.NO_LABEL == j_labels.NO_LABEL


def test_image_io_copy_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (12, 17, 3), dtype=np.uint8)
    t_imageio.save_ppm(str(tmp_path / "t.ppm"), rgb)
    j_imageio.save_ppm(str(tmp_path / "j.ppm"), rgb)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(j_imageio.load_ppm(str(tmp_path / "t.ppm")), rgb)
    np.testing.assert_array_equal(t_imageio.load_ppm(str(tmp_path / "j.ppm")), rgb)
    depth = rng.integers(0, 15000, (12, 17)).astype(np.uint16)
    with open(tmp_path / "d.pgm", "wb") as f:
        f.write(b"P5\n17 12\n65535\n" + depth.astype(">u2").tobytes())
    np.testing.assert_array_equal(t_imageio.load_depth(str(tmp_path / "d.pgm")),
                                  j_imageio.load_depth(str(tmp_path / "d.pgm")))
    t_imageio.save_color(str(tmp_path / "c.png"), rgb)
    np.testing.assert_array_equal(j_imageio.load_color(str(tmp_path / "c.png")),
                                  rgb)


def test_confusion_copy_matches():
    rng = np.random.default_rng(2)
    j, t = j_metrics.ConfusionAccumulator(5), t_metrics.ConfusionAccumulator(5)
    for _ in range(3):
        pred = rng.integers(-1, 5, (40, 50))
        gt = rng.integers(-1, 5, (40, 50))
        j.update(pred, gt)
        t.update(pred, gt)
    np.testing.assert_array_equal(t.confusion, j.confusion)
    assert t.total == j.total
    assert t.global_accuracy() == j.global_accuracy()
    assert t.class_average_accuracy() == j.class_average_accuracy()
    assert t.mean_iou() == j.mean_iou()
    assert t.report(list("abcde")) == j.report(list("abcde"))


def test_dataset_copy_lists_and_loads_the_same(tmp_path):
    path = build_dataset(tmp_path, names=("img0", "img1", "img2"))
    jc, tc = j_config.Config(path), t_config.Config(path)
    assert j_dataset.layer_prefixes_for(jc) == t_dataset.layer_prefixes_for(tc)
    assert j_dataset.model_path_for(jc) == t_dataset.model_path_for(tc)
    prefixes, _ = t_dataset.layer_prefixes_for(tc)
    jd = j_dataset.RovinaDataset(jc, "file_names_test", prefixes)
    td = t_dataset.RovinaDataset(tc, "file_names_test", prefixes)
    assert td.names == jd.names and len(td) == 3
    for js, ts in zip(jd, td):
        assert ts.name == js.name
        np.testing.assert_array_equal(ts.rgb, js.rgb)
        np.testing.assert_array_equal(ts.depth, js.depth)
        np.testing.assert_array_equal(ts.calibration.extrinsic,
                                      js.calibration.extrinsic)
        for a, b in zip(ts.labels, js.labels):
            np.testing.assert_array_equal(a, b)


def test_camera_copy_pairs_frames_the_same():
    topics = ["/camera_front/rgb/image", "/camera_front/depth/image",
              "/cam/xtion/rgb"]
    for topic in topics:
        assert t_camera.parse_name_from_topic(topic) \
            == j_camera.parse_name_from_topic(topic)
    results = []
    for mod in (j_camera, t_camera):
        buf = mod.CameraBuffer("camera_front")
        buf.add_topic(topics[0])
        buf.add_topic(topics[1])
        for seq in (1, 2, 4):
            buf.push_color(seq, np.full((2, 2, 3), seq, np.uint8))
            buf.push_depth(seq, np.full((2, 2), seq, np.uint16))
        got = [buf.is_complete, buf.get_id_and_clear(2)[0][0],
               buf.get_id_and_clear(1)]
        with pytest.raises(RuntimeError):
            buf.get_id_and_clear(5)
        results.append(got)
    assert results[0] == results[1]


def test_native_forest_decode_matches():
    data = open(os.path.join(ROOT, "resources", "bench_forest.dat"), "rb").read()
    j, t = j_native.native_forest_decode(data), t_native.native_forest_decode(data)
    assert t is not None and j is not None
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_native_lattice_build_matches():
    feats = np.random.default_rng(3).normal(0, 2, (500, 5)).astype(np.float32)
    j, t = j_native.native_lattice_build(feats), t_native.native_lattice_build(feats)
    assert t is not None and j is not None
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_native_builds_from_the_port_sources():
    path = t_native._library_path()
    assert os.path.dirname(path) == os.path.join(PORT, "csrc", "_build")
    assert t_native.get_lib() is not None and os.path.exists(path)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.int8, np.uint8])
def test_cvio_copy_reads_and_writes_the_same(tmp_path, dtype):
    rng = np.random.default_rng(5)
    arr = (rng.random((5, 7, 3)) * 100).astype(dtype)
    t_cvio.save_mat(str(tmp_path / "t.bin"), arr)
    j_cvio.save_mat(str(tmp_path / "j.bin"), arr)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    out = t_cvio.read_mat(str(tmp_path / "j.bin"))
    np.testing.assert_array_equal(out, j_cvio.read_mat(str(tmp_path / "t.bin")))
    assert out.dtype == arr.dtype
    ids = rng.integers(0, 1 << 24, (6, 9)).astype(np.int32)
    rgb = t_cvio.segment_id_to_rgb(ids)
    np.testing.assert_array_equal(rgb, j_cvio.segment_id_to_rgb(ids))
    np.testing.assert_array_equal(t_cvio.rgb_to_segment_id(rgb), ids)
    data = np.linspace(0, 1, 12).reshape(3, 4)
    for fn in ("save_heatmap", "save_gray"):
        getattr(t_cvio, fn)(str(tmp_path / "t.png"), data)
        getattr(j_cvio, fn)(str(tmp_path / "j.png"), data)
        np.testing.assert_array_equal(
            t_imageio.load_color(str(tmp_path / "t.png")),
            j_imageio.load_color(str(tmp_path / "j.png")))


def test_mcmc_copy_anneals_the_same():
    runs = []
    for mod in (j_mcmc, t_mcmc):
        steps = []
        best = mod.simulated_annealing(
            initial_state=np.array([4.0, -2.0]),
            energy=lambda x: float(np.sum((x - 1.0) ** 2)),
            propose=lambda x, rng: x + rng.normal(0, 0.3, 2),
            num_steps=300,
            cooling=mod.GeometricCooling(start=1.5, alpha=0.98),
            seed=4,
            callback=lambda k, s, e, t: steps.append((e, t)),
        )
        runs.append((best, steps))
    (jb, js), (tb, ts) = runs
    np.testing.assert_array_equal(tb[0], jb[0])
    assert tb[1] == jb[1] and ts == js


def test_data_io_copy_reads_and_writes_the_same():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    y = rng.integers(0, 3, 10).astype(np.int32)
    for writer, reader in (("write_csv_dataset", "read_csv_dataset"),
                           ("write_libsvm_dataset", "read_libsvm_dataset")):
        bufs = [io.StringIO(), io.StringIO()]
        getattr(t_data_io, writer)(bufs[0], x, y)
        getattr(j_data_io, writer)(bufs[1], x, y)
        assert bufs[0].getvalue() == bufs[1].getvalue()
        got = getattr(t_data_io, reader)(io.StringIO(bufs[1].getvalue()))
        want = getattr(j_data_io, reader)(io.StringIO(bufs[0].getvalue()))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    text = "1.0,cat,2.0\n3.0,dog,4.0\n"
    for a, b in zip(t_data_io.read_csv_dataset(io.StringIO(text), class_column_index=1),
                    j_data_io.read_csv_dataset(io.StringIO(text), class_column_index=1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bufs = [io.BytesIO(), io.BytesIO()]
    t_data_io.write_libforest_dataset(bufs[0], x, y)
    j_data_io.write_libforest_dataset(bufs[1], x, y)
    assert bufs[0].getvalue() == bufs[1].getvalue()
    bufs[1].seek(0)
    got = t_data_io.read_libforest_dataset(bufs[1])
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], y)
