"""The port's ``scripts/bench_dense_inference.py`` on the CPU, at 60x80.

Its seeded inputs are deterministic, its JSON line holds both builds, its
golden check reports "skipped" without the example PPMs and runs with them,
and on one of its inputs the port's ``cli.dense_inference.run`` labels as
JAX's does (``rovinasemanticsegmentation_tpu/cli/dense_inference.py``, JAX
on the CPU), for both builds.
"""

import json

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.cli import dense_inference as jdi
from rovinasemanticsegmentation_tpu_torch.cli import dense_inference as tdi
from rovinasemanticsegmentation_tpu_torch.scripts import bench_dense_inference as bdi
from rovinasemanticsegmentation_tpu_torch.utils.imageio import load_ppm, save_ppm

H, W = 60, 80


def test_inputs_are_deterministic_per_seed():
    a = bdi.make_demo_pair(np.random.default_rng(2), H, W)
    b = bdi.make_demo_pair(np.random.default_rng(2), H, W)
    c = bdi.make_demo_pair(np.random.default_rng(3), H, W)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    im, anno = a
    assert im.shape == anno.shape == (H, W, 3) and im.dtype == np.uint8
    labels = tdi.annotation_labels(anno)
    assert 0.4 < (labels < 0).mean() < 0.6 and labels.max() == tdi.M - 1


def test_script_prints_both_builds_on_the_cpu(capsys):
    out = bdi.main(["--device", "cpu", "--reps", "1", "--height", str(H),
                    "--width", str(W)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["metric"] == "dense_inference_ms_per_image"
    assert line["golden"] == "skipped" and line["profile"] is None
    assert line["device"]["platform"] == "cpu"
    assert (line["height"], line["width"]) == (H, W)
    worst = {}
    for build in ("device", "host"):
        images = line["per_image"][build]
        assert sorted(images) == ["im1", "im2", "im3"]
        for r in images.values():
            assert r["first_ms"] > 0 and r["warm_ms"] > 0 and r["golden"] is None
        assert line["cold_first_ms"][build] == images["im1"]["first_ms"]
        worst[build] = max(r["warm_ms"] for r in images.values())
    # Without a golden check both builds are candidates; the faster wins.
    assert line["value"] == min(worst.values())
    assert line["device_build_wins"] == (worst["device"] < worst["host"])


def test_golden_check_runs_with_examples(tmp_path, capsys):
    """With ``--examples`` the outputs are held against
    ``tests/golden/out{i}_ref.ppm`` (the densecrf example's, 320x240):
    these inputs are not the example's, so the check reports False and
    the script withholds its value, as the JAX script does."""
    bdi.write_inputs(str(tmp_path), H, W)
    out = bdi.main(["--device", "cpu", "--reps", "1", "--examples",
                    str(tmp_path)])
    assert out["golden"] == {"device": False, "host": False}
    assert out["inputs"] == "examples"
    # No build equals the goldens, so no value is reported.
    assert "value" not in out and "device_build_wins" not in out
    capsys.readouterr()


def test_script_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the script would run for real")
    with pytest.raises(RuntimeError, match="cuda"):
        bdi.main(["--reps", "1", "--height", "8", "--width", "8"])


@pytest.mark.parametrize("device_build", [True, False], ids=["device", "host"])
def test_run_on_a_generated_input_matches_jax(tmp_path, device_build):
    paths = bdi.write_inputs(str(tmp_path), H, W)[0]
    want = jdi.run(*paths, str(tmp_path / "jax.ppm"), device_build=device_build)
    got = tdi.run(*paths, str(tmp_path / "torch.ppm"),
                  device_build=device_build, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(load_ppm(str(tmp_path / "torch.ppm")),
                                  load_ppm(str(tmp_path / "jax.ppm")))
