"""PyTorch port vs JAX reference: the evaluation CLIs.

``run_evaluation`` and the ``test`` / ``test_multi`` mains of the port
against the JAX package's on the synthetic dataset of ``tests/test_cli.py``
(24x32 images in the reference layout): equal confusion counts and equal
result images, the wrong-mode errors, and the ``--device`` flag.
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.cli.evaluate import (
    run_evaluation as jax_run_evaluation,
)
from rovinasemanticsegmentation_tpu.features.dataset import model_path_for
from rovinasemanticsegmentation_tpu.models.forest import random_forest, save_forest
from rovinasemanticsegmentation_tpu.utils.config import Config
from rovinasemanticsegmentation_tpu.utils.imageio import load_color
from rovinasemanticsegmentation_tpu_torch.cli import test as cli_test
from rovinasemanticsegmentation_tpu_torch.cli import test_multi as cli_test_multi
from rovinasemanticsegmentation_tpu_torch.cli.evaluate import (
    config_and_device,
    run_evaluation,
)
from rovinasemanticsegmentation_tpu_torch.utils.config import (
    KeyNotFoundException,
)

from test_cli import build_dataset

torch.set_num_threads(2)

NAMES = ("img0", "img1", "img2")


def _dataset(root, shared):
    """The test_cli dataset with a random forest saved as its model ->
    (config path, config)."""
    path = build_dataset(root, names=NAMES, shared=shared)
    conf = Config(path)
    counts = [3, 2] if shared else [3]
    forest = random_forest(np.random.default_rng(1), num_trees=2, depth=5,
                           num_features=78, class_counts=counts, max_nodes=31)
    save_forest(model_path_for(conf), forest)
    return path, conf


def _results(root, layers):
    return [load_color(str(root / f"{layer}_results" / f"{n}.png"))
            for layer in layers for n in NAMES]


@pytest.mark.parametrize("shared", [True, False])
def test_run_evaluation_matches_jax(tmp_path, capsys, shared):
    _, conf = _dataset(tmp_path, shared)
    layers = ("mat", "obj") if shared else ("mat",)
    want = jax_run_evaluation(conf, multi=shared)
    want_images = _results(tmp_path, layers)
    capsys.readouterr()
    got = run_evaluation(conf, multi=shared, device="cpu")
    out = capsys.readouterr().out
    assert "Time per image" in out and "Global accuracy" in out
    assert "Intersection over union" in out
    assert len(got) == len(want) == len(layers)
    for g, w in zip(got, want):
        assert g.total > 0
        np.testing.assert_array_equal(g.confusion, w.confusion)
    for g, w in zip(_results(tmp_path, layers), want_images):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shared", [True, False])
def test_mains_take_the_device_flag(tmp_path, capsys, shared):
    path, conf = _dataset(tmp_path, shared)
    want = run_evaluation(conf, multi=shared, device="cpu")
    capsys.readouterr()
    main = cli_test_multi.main if shared else cli_test.main
    main(["--conf", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Time per image" in out
    assert out.count("confusion:") == len(want)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--conf", path])
    other = cli_test.main if shared else cli_test_multi.main
    with pytest.raises(RuntimeError, match="label testing"):
        other(["--conf", path, "--device", "cpu"])


def test_wrong_mode_rejected(tmp_path):
    _, shared = _dataset(tmp_path / "a", True)
    with pytest.raises(RuntimeError, match="multi label"):
        run_evaluation(shared, multi=False, device="cpu")
    _, single = _dataset(tmp_path / "b", False)
    with pytest.raises(RuntimeError, match="single label"):
        run_evaluation(single, multi=True, device="cpu")


def test_config_and_device(tmp_path):
    conf_path = build_dataset(tmp_path, names=NAMES)
    conf, device = config_and_device(
        ["--conf", conf_path, "--device", "cpu", "--rf_prediction_stride", "3"]
    )
    assert device == "cpu"
    assert conf.get_int("rf_prediction_stride") == 3
    with pytest.raises(KeyNotFoundException):
        conf.get_str("device")  # not handed to the config
    _, device = config_and_device(["--conf", conf_path])
    assert device == "cuda"  # the card unless told otherwise
    with pytest.raises(ValueError, match="No config file"):
        config_and_device(["--device", "cpu"])
    with pytest.raises(ValueError):
        config_and_device(["--conf"])
