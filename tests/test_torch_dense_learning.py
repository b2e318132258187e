"""PyTorch port vs JAX reference: the ``cli.dense_learning`` demo on the CPU.

A synthetic 64x48 image and its 4-colour annotation (20% unknown), made
from a seed (``cli/dense_learning.py::synthetic_pair``), go through the
port's ``run(..., device="cpu")`` and the JAX package's ``run``: the same
three L-BFGS-B phases from the same numpy initialisation. L-BFGS-B follows
float32 gradients that differ in their last bits (the lattice filter sums in
another order), so its paths part slowly: the histories must agree within
2e-3 absolute (measured 5.6e-4), and each phase must not lower the
objective (``history[k+1] >= history[k] - 1e-4``).
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.cli import dense_learning as J
from rovinasemanticsegmentation_tpu_torch.cli import dense_learning as T
from rovinasemanticsegmentation_tpu_torch.utils.imageio import load_ppm, save_ppm
from rovinasemanticsegmentation_tpu_torch.utils.profiling import StepTimer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense_learning")
    im, anno = T.synthetic_pair(48, 64, seed=3)
    save_ppm(str(root / "im.ppm"), im)
    save_ppm(str(root / "anno.ppm"), anno)
    return root, anno


def test_synthetic_pair_has_four_classes_and_a_fifth_unknown(pair):
    _, anno = pair
    labels = T.labeling_from_annotation(anno, T.M)
    np.testing.assert_array_equal(labels, J.labeling_from_annotation(anno, T.M))
    assert set(np.unique(labels)) == {-1, 0, 1, 2, 3}
    assert 0.15 < (labels < 0).mean() < 0.25


def test_run_matches_jax_and_each_phase_improves(pair):
    root, _ = pair
    timer = StepTimer()
    got = T.run(str(root / "im.ppm"), str(root / "anno.ppm"), str(root / "t.ppm"),
                device="cpu", timer=timer)
    want = J.run(str(root / "im.ppm"), str(root / "anno.ppm"), str(root / "j.ppm"))
    print(f"histories: port {got}, JAX {want}")
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    for k in range(2):
        assert got[k + 1] >= got[k] - 1e-4
    assert got[0] > 0.05
    assert {"phase 1", "phase 2", "phase 3"} <= set(timer.stats)
    assert timer.stats["evaluation"].count >= 12
    out, ref = load_ppm(str(root / "t.ppm")), load_ppm(str(root / "j.ppm"))
    assert out.shape == (48, 64, 3)
    assert (out == ref).all(-1).mean() > 0.98


def test_main_parses_scale_and_device(pair, capsys):
    root, _ = pair
    T.main([str(root / "im.ppm"), str(root / "anno.ppm"), str(root / "m.ppm"),
            "--scale=4", "--device", "cpu"])
    assert load_ppm(str(root / "m.ppm")).shape == (12, 16, 3)
    assert "phase 3 (full kernel)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        T.main([str(root / "im.ppm"), "--device", "tpu"])
