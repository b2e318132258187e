"""The normals kernels (``csrc/normals.cu``) against the plain PyTorch
normals on the card, and the dispatch that picks between them.

The card tests (marker ``cuda``; each skips when
``torch.cuda.is_available()`` is false) hold the kernels' angles to the plain
version's on the same CUDA tensor bit for bit, masks and all, and the
kernels' two intermediate results (the float64 integral image and the
distance at the grid) to the plain stages' bit for bit. On a machine with an
NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_normals_cuda.py -q

The CPU tests hold the dispatch: only a CUDA tensor with an integral size up
to ``MAX_SIZE`` takes the kernels, and everything else returns what the plain
version returns. This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch.ops import normals, normals_cuda
from rovinasemanticsegmentation_tpu_torch.ops.geometry import backproject
from rovinasemanticsegmentation_tpu_torch.scripts import make_bench_forest as recipe

FACTOR = 0.02  # maxDepthChangeFactor


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _points(depth_mm: np.ndarray, dev) -> torch.Tensor:
    """Backprojection of a depth frame in mm through an Xtion-like camera
    centred on the frame (0.5-15 m kept, NaN elsewhere)."""
    h, w = depth_mm.shape
    kinv = np.linalg.inv(np.array([[525.0, 0, w / 2], [0, 525.0, h / 2],
                                   [0, 0, 1]]))
    return backproject(torch.from_numpy(depth_mm.astype(np.int32)).to(dev),
                       kinv, np.eye(3), np.zeros(3), 0.5, 15.0)


def _surface(rng, h: int, w: int, holes: float = 0.02) -> np.ndarray:
    """Smooth slanted surfaces with a few depth steps and random holes, mm."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    z = (2.0 + 2.5 * x / w + 1.0 * y / h + 0.3 * np.sin(x / 37.0)
         + 0.2 * np.cos(y / 23.0))
    z += 0.5 * (x > 0.6 * w) - 0.4 * (y > 0.3 * h)
    z += rng.normal(scale=0.002, size=(h, w))
    depth = np.round(1000 * z)
    depth[rng.random((h, w)) < holes] = 0
    return depth


def _recipe_depth(index: int) -> np.ndarray:
    gen = recipe.frames()
    for _ in range(index + 1):
        _, depth, _ = next(gen)
    return depth


def _check(points: torch.Tensor, stride: int, size: float) -> torch.Tensor:
    """The kernels against the plain version on ``points`` (a CUDA tensor):
    one frame counted, angles, integral image and grid distance bit-equal.
    -> the angles."""
    launch, got, integ, dist = normals_cuda.launcher(points, stride, FACTOR,
                                                     size)
    before = normals_cuda.launches.value
    launch()
    torch.cuda.synchronize()
    assert normals_cuda.launches.value == before + 1
    want_integ = normals._gradient_integral(points)[:, 1:, 1:]
    assert torch.equal(integ, want_integ), "integral image differs"
    change = normals._depth_change_map(points[..., 2], FACTOR)
    want_dist = normals.chamfer_distance_map(change, saturation=size)
    assert torch.equal(dist, want_dist[::stride, ::stride]), \
        "grid distance differs"
    want = normals._normal_angles(points, stride, FACTOR, size)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got == -2.0, want == -2.0), "masks differ"
    assert torch.equal(got, want), "angles differ"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("frame,stride", [(0, 2), (0, 5), (1, 2), (1, 5)])
def test_recipe_frames_bit_equal(dev, frame, stride):
    got = _check(_points(_recipe_depth(frame), dev), stride, 10.0)
    assert (got != -2.0).sum() > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("size", [7.0, 4.0])
def test_smaller_integral_sizes_bit_equal(dev, size):
    got = _check(_points(_recipe_depth(0), dev), 2, size)
    assert (got != -2.0).sum() > 1000


@pytest.mark.cuda
def test_no_valid_depth(dev):
    got = _check(_points(np.zeros((480, 640)), dev), 2, 10.0)
    assert (got == -2.0).all()


@pytest.mark.cuda
def test_all_depth_valid(dev):
    depth = _surface(np.random.default_rng(3), 480, 640, holes=0.0)
    assert (depth > 500).all()
    got = _check(_points(depth, dev), 2, 10.0)
    assert (got != -2.0).sum() > 10000


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_steps_and_holes_at_tile_boundaries(dev, stride):
    """Depth steps on the rows and columns where the 32-pixel distance tiles
    meet, and holes at the tiles' corners and edges."""
    h, w = 200, 232
    y, x = np.mgrid[0:h, 0:w]
    depth = 2000.0 + 2.0 * x + 1.0 * y
    depth += 400.0 * ((x // 32) % 2) + 300.0 * ((y // 32) % 2)
    depth[(x % 32 == 31) & (y % 32 < 3)] = 0
    depth[(y % 32 == 0) & (x % 64 == 33)] = 0
    depth[(y % 96 == 95) & (x % 32 == 0)] = 0
    got = _check(_points(depth, dev), stride, 10.0)
    assert (got != -2.0).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("shape,stride,size", [
    ((61, 83), 2, 10.0), ((61, 83), 3, 7.0), ((480, 641), 2, 10.0),
    ((481, 640), 5, 10.0),
    # Rows of 3000 values: PyTorch's row scan sums them in chunks of 128.
    ((24, 3000), 2, 4.0),
])
def test_sides_not_a_multiple_of_the_tile(dev, shape, stride, size):
    depth = _surface(np.random.default_rng(sum(shape)), *shape)
    got = _check(_points(depth, dev), stride, size)
    assert (got != -2.0).sum() > 10


@pytest.mark.cuda
def test_production_call_takes_the_kernels_once_a_frame(dev):
    points = _points(_recipe_depth(0), dev)
    before = normals_cuda.launches.value
    for k in range(3):
        got = normals.normal_angles_grid(points, 2)
        assert normals_cuda.launches.value == before + k + 1
    torch.cuda.synchronize()
    assert torch.equal(got, normals._normal_angles(points, 2, FACTOR, 10.0))
    # The full-resolution and non-integral paths keep the plain version.
    normals.normal_angles(points)
    normals.normal_angles_grid(points, 2, normal_smoothing_size=6.5)
    assert normals_cuda.launches.value == before + 3


# ----------------------------------------------------------------------
# The dispatch, on the CPU
# ----------------------------------------------------------------------


@pytest.mark.parametrize("device,size,takes", [
    ("cuda", 10.0, True), ("cuda", 7.0, True), ("cuda", 4.0, True),
    ("cuda", 16, True), ("cuda", 1.0, True),
    ("cpu", 10.0, False), ("cuda", 6.5, False), ("cuda", 17.0, False),
    ("cuda", 0.0, False), ("cuda", -4.0, False), ("meta", 10.0, False),
])
def test_engages(device, size, takes):
    assert normals_cuda.engages(torch.device(device), size) is takes


@pytest.mark.parametrize("rows,row_size,log", [
    (8 * 480, 640, 4),  # VGA: chunks of 32, as PyTorch sums them
    (8 * 61, 83, 4), (8 * 24, 3000, 6), (8, 640, 8), (1, 1, 4),
    (8 * 2**17, 2, 9),  # 9 + 1 - 20 wraps in uint32: 2^31 - 5, then 9
])
def test_inner_scan_log_threads(rows, row_size, log):
    assert normals_cuda.inner_scan_log_threads(rows, row_size) == log


@pytest.fixture(scope="module")
def cpu_points():
    return _points(_surface(np.random.default_rng(5), 72, 96), "cpu")


def _refuse(*args, **kwargs):
    raise AssertionError("the kernels' wrapper was called")


@pytest.mark.parametrize("size", [10.0, 6.5, 17.0, 4.0])
def test_cpu_tensor_keeps_the_plain_version(monkeypatch, cpu_points, size):
    monkeypatch.setattr(normals_cuda, "normal_angles_grid", _refuse)
    got = normals.normal_angles_grid(cpu_points, 2, normal_smoothing_size=size)
    want = normals._normal_angles(cpu_points, 2, FACTOR, size)
    assert torch.equal(got, want)
    assert (got != -2.0).any()


def test_dispatch_sends_an_engaged_call_to_the_wrapper(monkeypatch,
                                                       cpu_points):
    calls = []

    def spy(points, stride, factor, size):
        calls.append((stride, factor, size))
        return normals._normal_angles(points, stride, factor, size)

    monkeypatch.setattr(normals_cuda, "engages", lambda device, size: True)
    monkeypatch.setattr(normals_cuda, "normal_angles_grid", spy)
    got = normals.normal_angles_grid(cpu_points, 3, 0.03, 7.0)
    assert calls == [(3, 0.03, 7.0)]
    assert torch.equal(got, normals._normal_angles(cpu_points, 3, 0.03, 7.0))


def test_full_resolution_never_takes_the_kernels(monkeypatch, cpu_points):
    monkeypatch.setattr(normals_cuda, "engages", lambda device, size: True)
    monkeypatch.setattr(normals_cuda, "normal_angles_grid", _refuse)
    got = normals.normal_angles(cpu_points)
    assert torch.equal(got, normals._normal_angles(cpu_points, None, FACTOR,
                                                   10.0))


@pytest.mark.parametrize("size", [6.5, 17.0])
def test_sizes_the_kernels_refuse_keep_the_plain_version(monkeypatch,
                                                         cpu_points, size):
    """A non-integral size and one over the cap: ``engages`` is false on a
    CUDA device, so the production call runs the plain version."""
    assert not normals_cuda.engages(torch.device("cuda"), size)
    monkeypatch.setattr(normals_cuda, "normal_angles_grid", _refuse)
    got = normals.normal_angles_grid(cpu_points, 2, normal_smoothing_size=size)
    assert torch.equal(got, normals._normal_angles(cpu_points, 2, FACTOR,
                                                   size))


def test_launcher_refuses_what_the_kernels_do_not_take(cpu_points):
    with pytest.raises(ValueError, match="CUDA tensor"):
        normals_cuda.launcher(cpu_points, 2, FACTOR, 10.0)
    with pytest.raises(ValueError, match="float32"):
        normals_cuda.launcher(cpu_points.double(), 2, FACTOR, 10.0)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        normals_cuda.launcher(cpu_points[..., :2], 2, FACTOR, 10.0)
