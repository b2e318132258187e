"""PyTorch port vs JAX reference: the single-frame slice end to end.

Both packages run the same frames and the same trained-like forest at a
small size (40x48 frames, patch 15 -> 5, stride 2, 78 features). JAX takes
its Pallas descent in interpret mode (``use_pallas=True``); the port runs on
the CPU, so its kernel wrappers take their plain versions.
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.features.extractor import (
    FeatureConfig as JFeatureConfig,
    FeatureExtractor as JFeatureExtractor,
)
from rovinasemanticsegmentation_tpu.models.forest import random_forest
from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
    SingleFramePipeline as JSingleFramePipeline,
    _posterior_maps as j_posterior_maps,
)
from rovinasemanticsegmentation_tpu.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.features.extractor import (
    FeatureConfig,
    FeatureExtractor,
)
from rovinasemanticsegmentation_tpu_torch.models.forest import forest_from_numpy
from rovinasemanticsegmentation_tpu_torch.ops import resize_argmax_cuda
from rovinasemanticsegmentation_tpu_torch.ops.forest_cuda import forest_predict
from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
    ARGMAX_FLOOR,
    SingleFramePipeline,
    posterior_maps,
    posterior_maps_plain,
)

from test_torch_ops import smooth_depth_mm

torch.set_num_threads(2)

H, W, STRIDE = 40, 48, 2
CFG = dict(patch_size=15, patch_size_reduce=5)


def _calib(shift=0.0):
    return Calibration(
        intrinsic=np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]),
        rotation=np.eye(3),
        translation=np.array([shift, 0.0, 0.5]),
    )


def _frame(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return rgb, smooth_depth_mm(rng, H, W)


@pytest.fixture(scope="module")
def setup():
    """Frames and a forest whose thresholds span each feature's range."""
    frames = [_frame(s) for s in (1, 2)]
    calibs = [_calib(0.0), _calib(0.1)]
    batch = JFeatureExtractor(JFeatureConfig(**CFG)).extract(
        frames[0][0], frames[0][1], calibs[0], STRIDE
    )
    feats = np.asarray(batch.features)[np.asarray(batch.mask)]
    rng = np.random.default_rng(0)
    forest = random_forest(rng, 3, 9, feats.shape[1], [3, 4], max_nodes=301)
    lo, hi = feats.min(axis=0), feats.max(axis=0)
    f = forest.split_feature
    forest.threshold[:] = rng.uniform(lo[f], hi[f]).astype(np.float32)
    return frames, calibs, forest


def _assert_close_results(got, want):
    for res_got, res_want in zip(got, want):
        for p_got, p_want in zip(res_got.posteriors, res_want.posteriors):
            np.testing.assert_allclose(
                p_got.numpy(), np.asarray(p_want), rtol=1e-5, atol=1e-4
            )
        for l_got, l_want in zip(res_got.labels, res_want.labels):
            agree = (l_got.numpy() == np.asarray(l_want)).mean()
            assert agree >= 0.999, f"labels agree on {agree:.4%} of pixels"


def test_run_matches_jax(setup):
    frames, calibs, forest = setup
    jp = JSingleFramePipeline(
        JFeatureConfig(**CFG), forest, STRIDE, use_pallas=True
    )
    tp = SingleFramePipeline(FeatureConfig(**CFG), forest, STRIDE, "cpu")
    rgb, depth = frames[0]
    _assert_close_results(
        [tp.run(rgb, depth, calibs[0])], [jp.run(rgb, depth, calibs[0])]
    )


def test_run_batch_stacked_matches_jax(setup):
    frames, calibs, forest = setup
    stacks = (
        np.stack([f[0] for f in frames]),
        np.stack([f[1] for f in frames]),
        np.stack([c.intrinsic_inverse for c in calibs]),
        np.stack([c.rotation for c in calibs]),
        np.stack([c.translation for c in calibs]),
    )
    jp = JSingleFramePipeline(
        JFeatureConfig(**CFG), forest, STRIDE, use_pallas=True
    )
    tp = SingleFramePipeline(FeatureConfig(**CFG), forest, STRIDE, "cpu")
    got = tp.run_batch_stacked(*stacks)
    _assert_close_results(got, jp.run_batch_stacked(*stacks))
    # The batch equals per-frame runs.
    for i, res in enumerate(got):
        single = tp.run(frames[i][0], frames[i][1], calibs[i])
        for a, b in zip(res.posteriors, single.posteriors):
            assert torch.equal(a, b)


def test_port_forest_on_jax_features_gives_equal_labels(setup):
    frames, calibs, forest = setup
    rgb, depth = frames[1]
    jp = JSingleFramePipeline(
        JFeatureConfig(**CFG), forest, STRIDE, use_pallas=True
    )
    want = jp.run(rgb, depth, calibs[1])
    batch = JFeatureExtractor(JFeatureConfig(**CFG)).extract(
        rgb, depth, calibs[1], STRIDE
    )
    tf = forest_from_numpy(forest, "cpu")
    _, post = forest_predict(torch.from_numpy(np.asarray(batch.features)), tf)
    _, labels = posterior_maps(
        post, torch.from_numpy(np.asarray(batch.mask)), batch.grid_shape,
        tf.class_counts, jp.fill_value, H, W,
    )
    for got, ref in zip(labels, want.labels):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_feature_extractor_matches_jax(setup):
    frames, calibs, _ = setup
    rgb, depth = frames[0]
    want = JFeatureExtractor(JFeatureConfig(**CFG)).extract(
        rgb, depth, calibs[0], STRIDE
    )
    got = FeatureExtractor(FeatureConfig(**CFG), "cpu").extract(
        rgb, depth, calibs[0], STRIDE
    )
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xs, np.asarray(want.xs))
    np.testing.assert_array_equal(got.ys, np.asarray(want.ys))
    assert got.grid_shape == want.grid_shape
    gf, wf = got.features.numpy(), np.asarray(want.features)
    n_patch = 5 * 5 * 3
    np.testing.assert_array_equal(gf[:, :n_patch + 1], wf[:, :n_patch + 1])
    np.testing.assert_allclose(gf[:, n_patch + 1], wf[:, n_patch + 1],
                               rtol=1e-6, atol=1e-6)  # height, as backproject
    np.testing.assert_allclose(gf[:, -1], wf[:, -1], atol=1e-4, rtol=0)


# ----------------------------------------------------------------------
# posterior_maps: the contract csrc/resize_argmax.cu is held to on the card
# (tests/test_torch_resize_argmax_cuda.py), and its dispatch
# ----------------------------------------------------------------------


def _stride_posteriors(h, w, stride, seed, masked=0.3, counts=(8, 9)):
    """Random log-posteriors [P, len(counts), max(counts)] and a mask with
    ``masked`` of the grid points false, for an h x w frame at ``stride``."""
    rng = np.random.default_rng(seed)
    gh, gw = -(-h // stride), -(-w // stride)
    post = rng.normal(scale=3.0, size=(gh * gw, len(counts), max(counts)))
    return post.astype(np.float32), rng.random(gh * gw) >= masked, (gh, gw)


@pytest.mark.parametrize("fill", [0.0, -1000.0])
@pytest.mark.parametrize("h,w,stride", [(61, 83, 2), (61, 83, 3),
                                        (479, 637, 2), (479, 637, 3)])
def test_posterior_maps_labels_match_jax(h, w, stride, fill):
    """Sizes the stride does not divide, the online (0) and offline (-1000)
    fills. XLA:CPU contracts the taps' ``(x + 0.5) * scale - 0.5`` and the
    blends ``a * w0 + b * f`` into fused multiply-adds, so a tap's fraction
    can differ from the port's in the last bit of its source coordinate, and
    a value by that bit times the layer's span in each of the two passes:
    the posteriors are held to that. The labels are equal, except where those
    roundings decide them: a pixel whose maximum is within that tolerance of
    the -1000 floor (a blend of masked points' fills, -1000 exactly in the
    port and a bit above it in JAX, at 479x637 stride 2) or of a second class
    (blends of the same fills, at 479x637 stride 3). There, both labels must
    be among the near-tied answers, and such pixels are at most 1e-4 of the
    frame."""
    post, mask, grid = _stride_posteriors(h, w, stride, seed=stride)
    want_post, want = j_posterior_maps(post, mask, np.zeros((h, w)), stride,
                                       (8, 9), fill, h, w)
    got_post, got = posterior_maps(torch.from_numpy(post),
                                   torch.from_numpy(mask), grid, (8, 9), fill,
                                   h, w)
    coord_ulp = float(np.spacing(np.float32(max(grid))))
    n_decided = 0
    for li, c in enumerate((8, 9)):
        assert got[li].dtype == torch.int8 and got[li].shape == (h, w)
        assert got_post[li].dtype == torch.float32
        assert got_post[li].shape == (h, w, c)
        layer = np.where(mask[:, None], post[:, li, :c], np.float32(fill))
        tol = 2 * coord_ulp * float(layer.max() - layer.min())
        vals = got_post[li].numpy()
        np.testing.assert_allclose(vals, np.asarray(want_post[li]), rtol=0,
                                   atol=tol)
        g, ref = got[li].numpy(), np.asarray(want[li])
        for y, x in np.argwhere(g != ref):
            v = vals[y, x]
            near = set(np.flatnonzero(v >= v.max() - tol).tolist())
            if abs(v.max() - ARGMAX_FLOOR) <= tol:
                near.add(-1)
            assert {int(g[y, x]), int(ref[y, x])} <= near, (li, y, x, v)
            n_decided += 1
    assert n_decided <= 1e-4 * h * w
    if fill == -1000.0:
        assert (got[1].numpy() == -1).any()


@pytest.mark.parametrize("h,w,stride", [(480, 640, 2), (47, 95, 2),
                                        (61, 83, 3)])
def test_all_masked_layer_gives_no_vote(h, w, stride):
    """Every grid point masked: the offline fill blends to -1000, which the
    floor does not beat, so every label is -1; the online fill 0 gives class
    0 everywhere (the first of equal maxima)."""
    post, _, grid = _stride_posteriors(h, w, stride, seed=7)
    mask = torch.zeros(grid[0] * grid[1], dtype=torch.bool)
    for fill, label in ((-1000.0, -1), (0.0, 0)):
        maps, labels = posterior_maps(torch.from_numpy(post), mask, grid,
                                      (8, 9), fill, h, w)
        for m, lbl in zip(maps, labels):
            assert (lbl == label).all()
            assert (m == fill).all()


class _DeviceLike:
    """What ``engages`` reads of a tensor: its device."""

    def __init__(self, device):
        self.device = torch.device(device)


@pytest.mark.parametrize("post,takes", [
    (_DeviceLike("cuda"), True),
    (_DeviceLike("cuda:1"), True),
    (torch.zeros((4, 2, 9)), False),
    (torch.zeros((4, 2, 9), dtype=torch.float64), False),
    (_DeviceLike("cpu"), False),
    (torch.zeros((4, 2, 9), device="meta"), False),
])
def test_resize_argmax_kernel_engages(post, takes):
    """The kernel takes every CUDA tensor, and no other."""
    assert resize_argmax_cuda.engages(post) is takes


def _refuse(*args, **kwargs):
    raise AssertionError("the resize_argmax kernel's wrapper was called")


@pytest.mark.parametrize("counts", [(8, 9), (33, 9), (1, 2, 3)])
def test_cpu_tensor_keeps_the_plain_posterior_maps(monkeypatch, counts):
    """A CPU tensor keeps the plain version, whatever its class counts
    (over the kernel's maximum, more layers than it takes)."""
    monkeypatch.setattr(resize_argmax_cuda, "posterior_maps", _refuse)
    monkeypatch.setattr(resize_argmax_cuda, "launcher", _refuse)
    post, mask, grid = _stride_posteriors(11, 13, 2, seed=3, masked=0.2,
                                          counts=counts)
    post, mask = torch.from_numpy(post), torch.from_numpy(mask)
    got = posterior_maps(post, mask, grid, counts, -1000.0, 11, 13)
    want = posterior_maps_plain(post, mask, grid, counts, -1000.0, 11, 13)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


def test_engaged_call_goes_to_the_kernel_wrapper(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args[2:])
        return posterior_maps_plain(*args)

    monkeypatch.setattr(resize_argmax_cuda, "engages", lambda post: True)
    monkeypatch.setattr(resize_argmax_cuda, "posterior_maps", spy)
    post, mask, grid = _stride_posteriors(9, 11, 2, seed=4)
    post, mask = torch.from_numpy(post), torch.from_numpy(mask)
    got = posterior_maps(post, mask, grid, (8, 9), 0.0, 9, 11)
    assert calls == [(grid, (8, 9), 0.0, 9, 11)]
    want = posterior_maps_plain(post, mask, grid, (8, 9), 0.0, 9, 11)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


def test_engaged_call_the_kernel_does_not_take_raises(monkeypatch):
    """On the card, what the kernel does not take raises in its wrapper: it
    does not run the plain version there."""
    monkeypatch.setattr(resize_argmax_cuda, "engages", lambda post: True)
    post, mask, grid = _stride_posteriors(9, 11, 2, seed=4, counts=(33, 9))
    with pytest.raises(ValueError, match="classes"):
        posterior_maps(torch.from_numpy(post), torch.from_numpy(mask), grid,
                       (33, 9), -1000.0, 9, 11)


def _refused(p=4, layers=2, cmax=9, dtype=torch.float32, mask_dtype=torch.bool,
             mask_len=None):
    return (torch.zeros((p, layers, cmax), dtype=dtype),
            torch.ones(p if mask_len is None else mask_len, dtype=mask_dtype))


@pytest.mark.parametrize("tensors,counts,grid,frame,match", [
    (_refused(), (8, 9), (2, 2), (4, 4), "CUDA device"),  # shapes taken
    (_refused(layers=2, cmax=33), (33, 9), (2, 2), (4, 4), "classes"),
    (_refused(layers=2, cmax=40), (8, 40), (2, 2), (4, 4), "classes"),
    (_refused(layers=3), (1, 2, 3), (2, 2), (4, 4), "classes"),
    (_refused(), (8, 10), (2, 2), (4, 4), "classes"),  # post holds 9
    (_refused(layers=1), (8, 9), (2, 2), (4, 4), "classes"),  # and 1 layer
    (_refused(), (8, 0), (2, 2), (4, 4), "classes"),
    (_refused(), (), (2, 2), (4, 4), "classes"),
    (_refused(dtype=torch.float64), (8, 9), (2, 2), (4, 4), "float32"),
    (_refused(p=5), (8, 9), (2, 2), (4, 4), "float32"),
    (_refused(mask_dtype=torch.uint8), (8, 9), (2, 2), (4, 4), "bool"),
    (_refused(mask_len=3), (8, 9), (2, 2), (4, 4), "bool"),
    (_refused(), (8, 9), (2, 2), (1, 4), "no larger than the frame"),
    (_refused(), (8, 9), (2, 2), (4, 1), "no larger than the frame"),
    (_refused(p=0), (8, 9), (0, 3), (4, 4), "no larger than the frame"),
    (_refused(p=65536), (8, 9), (65536, 1), (65536, 1),
     "no larger than the frame"),
])
def test_resize_argmax_launcher_refuses_what_the_kernel_does_not_take(
        tensors, counts, grid, frame, match):
    """Shapes first, then the device: each refusal names its reason."""
    post, mask = tensors
    with pytest.raises(ValueError, match=match):
        resize_argmax_cuda.launcher(post, mask, grid, counts, -1000.0, *frame)
