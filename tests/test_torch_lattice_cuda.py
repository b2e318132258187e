"""The lattice-build kernels (``csrc/lattice_build.cu``) against the plain
PyTorch build, and the dispatch that picks between them.

The card tests (marker ``cuda``; each skips when
``torch.cuda.is_available()`` is false) hold all twelve results of
``models/lattice.py::_build_device`` on the card to the plain build on the
CPU, bit for bit and in dtype and shape: small point sets at d = 1 to 8,
duplicate-heavy ones, the map path's 30000-point room cloud in its 16384
slots, VGA-sized image lattices at d = 2 and 5 as the 2D demo builds them,
and overflowing builds. They also hold the launch counter (one a build, one
a CRF map of ``StreamingPipeline.run_staged``) and the build's freedom from
host synchronisation. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_lattice_cuda.py -q

The CPU tests hold the dispatch: a CPU tensor keeps the plain build and
leaves the counter alone, a CUDA tensor goes to the kernels, and the
wrapper refuses what the kernels cannot take. This file imports nothing of
JAX.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from rovinasemanticsegmentation_tpu_torch.bench import FIXTURE
from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu_torch.models import lattice as L
from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
from rovinasemanticsegmentation_tpu_torch.ops import lattice_cuda
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
    CrfParams,
    LocalMapPipeline,
)
from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import (
    SingleFramePipeline,
)
from rovinasemanticsegmentation_tpu_torch.pipelines.streaming import (
    StreamingPipeline,
    pack_poses,
)
from rovinasemanticsegmentation_tpu_torch.scripts.profile_frames import (
    FRAME_SEED,
    make_frames,
)
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration

RESULTS = ("sorted_points", "sorted_weights", "seg_starts", "seg_ends",
           "offsets_t", "barycentric_t", "blur_n1", "blur_n2", "m",
           "pos_sorted", "rem0", "rank")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _room_features(n, seed):
    """``[xyz * 0.5 ; rgb * 4]`` features of a room-scale coloured cloud."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3.0, -1.5, 0.5], [3.0, 1.5, 6.0], (n, 3))
    rgb = rng.uniform(0.0, 1.0, (n, 3))
    return torch.from_numpy(
        np.concatenate([pts * 0.5, rgb * 4.0], axis=1).astype(np.float32)
    )


def _normal(n, d, seed, scale):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(n, d)) * scale).astype(np.float32))


def _image(h, w, d, seed):
    """The 2D demo's features of a blocky noisy image: ``[x, y] / 3`` (d =
    2) or ``[x, y] / 80, rgb / 13`` (d = 5), as ``models/crf2d_device.py``
    builds them for its two kernels."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (h // 40 + 1, w // 40 + 1, 3))
    im = np.repeat(np.repeat(blocks, 40, axis=0), 40, axis=1)[:h, :w]
    im = np.clip(im + rng.normal(0, 6, im.shape), 0, 255).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    if d == 2:
        cols = [xs / 3.0, ys / 3.0]
    else:
        cols = [xs / 80.0, ys / 80.0] + [im[..., c] / 13.0 for c in range(3)]
    return torch.from_numpy(np.stack([c.reshape(-1) for c in cols], axis=1))


# name -> (features, vertex slots: None fits the count, overflows)
CASES = {
    "n60_d2": (lambda: _normal(60, 2, 2, 2.0), None, False),
    "n60_d5": (lambda: _normal(60, 5, 5, 2.0), None, False),
    "room_n500_d6": (lambda: _room_features(500, 3), None, False),
    "dups_d2": (lambda: _normal(60, 2, 7, 0.05), None, False),
    "dups_d5": (lambda: _normal(60, 5, 7, 0.05), None, False),
    "dups_n5000_d6": (lambda: _normal(5000, 6, 9, 0.2), None, False),
    "n400_d1": (lambda: _normal(400, 1, 1, 3.0), None, False),
    "n400_d3": (lambda: _normal(400, 3, 1, 3.0), None, False),
    "n400_d4": (lambda: _normal(400, 4, 1, 3.0), None, False),
    "n400_d7": (lambda: _normal(400, 7, 1, 3.0), None, False),
    "n400_d8": (lambda: _normal(400, 8, 1, 3.0), None, False),
    "room_n30000_d6": (lambda: _room_features(30000, 30000), 1 << 14, False),
    "room_n2000_overflow": (lambda: _room_features(2000, 2000), 1 << 9, True),
    "n400_d8_overflow": (lambda: _normal(400, 8, 1, 3.0), 100, True),
    "image_vga_d2": (lambda: _image(480, 640, 2, 4), None, False),
    "image_vga_d5": (lambda: _image(480, 640, 5, 4), None, False),
}


def _fit(features):
    """The vertex count's power of two above it (a one-slot build counts)."""
    m = int(L._build_device_plain(features, 1)[8])
    return 1 << int(np.ceil(np.log2(m + 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_lattice_build_equals_cpu(dev, case):
    """Every result equal, overflowing builds included."""
    make, bucket, overflows = CASES[case]
    feats = make()
    bucket = bucket or _fit(feats)
    want = L._build_device(feats, bucket)
    got = L._build_device(feats.to(dev), bucket)
    assert (int(want[8]) > bucket) == overflows
    for name, g, w in zip(RESULTS, got, want, strict=True):
        assert g.device.type == "cuda", name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.cpu(), w), name
    assert torch.equal(L.build_lattice_device(feats.to(dev), bucket)[8].cpu(),
                       want[8])


@pytest.mark.cuda
def test_lattice_kernels_count_one_a_build(dev):
    feats = _room_features(3000, 5).to(dev)
    before = lattice_cuda.launches.value
    L.build_lattice_device(feats, 1 << 12)
    L.build_lattice_device(feats, 1 << 12)
    assert lattice_cuda.launches.value == before + 2
    geom = L.lattice_geometry_device(feats, 1 << 12)
    assert lattice_cuda.launches.value == before + 3
    assert geom.num_vertices == 1 << 12


@pytest.mark.cuda
def test_lattice_build_does_not_synchronise(dev):
    feats = _room_features(30000, 7).to(dev)
    L.build_lattice_device(feats, 1 << 14)  # loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        L.build_lattice_device(feats, 1 << 14)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_run_staged_counts_one_build_a_crf_map(dev):
    """``chip_smoke.py`` phase 8's streaming step: 10 VGA keyframes and two
    30000-point maps, dense CRF on."""
    h, w, every = chip_smoke.H, chip_smoke.W, chip_smoke.MAP_EVERY
    frames = make_frames(np.random.default_rng(FRAME_SEED),
                         chip_smoke.N_KEYFRAMES)
    map_rng = np.random.default_rng(2)
    maps = [chip_smoke.make_cloud(map_rng, frames, k * every)
            for k in range(chip_smoke.N_KEYFRAMES // every)]
    calib = Calibration(
        intrinsic=np.array([[525.0, 0, w / 2], [0, 525.0, h / 2], [0, 0, 1]]),
        rotation=np.eye(3), translation=np.zeros(3))
    b = len(frames)
    stacks = (
        torch.from_numpy(np.stack([f[0] for f in frames])).to(dev),
        torch.from_numpy(np.stack([f[1] for f in frames]).astype(np.int32)).to(dev),
        np.tile(calib.intrinsic_inverse[None], (b, 1, 1)).astype(np.float32),
        np.tile(calib.rotation[None], (b, 1, 1)).astype(np.float32),
        np.tile(calib.translation[None], (b, 1)).astype(np.float32),
    )
    projector = MultiProjector.from_calibrations([calib], h, w, min_distance=0.5)
    poses = np.stack([
        pack_poses(projector, [chip_smoke.pose_of(f)
                               for f in range(k * every, (k + 1) * every)])
        for k in range(len(maps))])
    clouds = torch.from_numpy(np.stack([m[0] for m in maps])).to(dev)
    colours = torch.from_numpy(np.stack([m[1] for m in maps])).to(dev)
    forest = load_forest(FIXTURE, class_counts=[8, 9])
    fp = SingleFramePipeline(FeatureConfig(), forest, chip_smoke.STRIDE, "cuda",
                             fill_value=0.0)
    mp = LocalMapPipeline(projector, [8, 9], [7, 8], "cuda",
                          crf=CrfParams(use_dense_crf=True))
    stream = StreamingPipeline(fp, mp, every)
    for _ in range(2):  # the first batch checks the cloud's size
        before = lattice_cuda.launches.value
        stream.run_staged(*stacks, clouds, colours, poses)
        torch.cuda.synchronize()
        mp.flush()
        assert lattice_cuda.launches.value == before + len(maps)


# ----------------------------------------------------------------------
# The dispatch (CPU)
# ----------------------------------------------------------------------


def _refuse(*args, **kwargs):
    raise AssertionError("the kernels' wrapper was called")


@pytest.mark.parametrize("case", ["n60_d2", "dups_d5", "room_n2000_overflow"])
def test_cpu_build_keeps_the_plain_build(monkeypatch, case):
    make, bucket, _ = CASES[case]
    feats = make()
    bucket = bucket or _fit(feats)
    monkeypatch.setattr(lattice_cuda, "build", _refuse)
    before = lattice_cuda.launches.value
    got = L._build_device(feats, bucket)
    assert lattice_cuda.launches.value == before
    for g, w in zip(got, L._build_device_plain(feats, bucket), strict=True):
        assert torch.equal(g, w)
    assert len(L.build_lattice_device(feats, bucket)) == 9
    assert lattice_cuda.launches.value == before


def test_cuda_tensors_go_to_the_kernels(monkeypatch):
    """``_build_device`` hands a CUDA tensor (here a stand-in) to the
    wrapper with the plain build's float32 elevation scales."""
    calls = []
    feats = types.SimpleNamespace(device=torch.device("cuda"), shape=(5, 6))
    feats.float = lambda: feats
    monkeypatch.setattr(lattice_cuda, "build",
                        lambda f, m, scale: calls.append((f, m, scale)) or "built")
    assert L._build_device(feats, 64) == "built"
    (f, m, scale), = calls
    assert f is feats and m == 64
    assert scale.dtype == np.float32
    np.testing.assert_array_equal(scale, L._embedding_scale(6).astype(np.float32))


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        lattice_cuda.build(_normal(10, 2, 0, 1.0), 64,
                           L._embedding_scale(2).astype(np.float32))


@pytest.mark.parametrize("features,bucket,match", [
    (torch.zeros((10, 9)), 64, "dimensions"),
    (torch.zeros((10, 0)), 64, "dimensions"),
    (torch.zeros((0, 3)), 64, "rows"),
    (torch.zeros((10, 3), dtype=torch.float64), 64, "float32"),
    (torch.zeros((10,)), 64, "float32"),
    (torch.zeros((10, 3)), 0, "m_bucket"),
    (torch.zeros((1, 3)).expand(lattice_cuda.MAX_ROWS // 4 + 1, 3), 64, "rows"),
])
def test_wrapper_refuses_what_the_kernels_cannot_take(features, bucket, match):
    d = features.shape[-1] if features.dim() == 2 else 1
    with pytest.raises(ValueError, match=match):
        lattice_cuda._launch(None, features, bucket,
                             np.ones(max(d, 1), np.float32), None)
