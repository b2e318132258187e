"""The mean-field kernels (``csrc/mean_field.cu``) against the plain PyTorch
mean field on the card, and the dispatch that picks between them.

The card tests (marker ``cuda``; each skips when
``torch.cuda.is_available()`` is false) hold the kernels to the plain
``potts_mean_field_multi_plain_t`` and ``lattice_filter_t`` on the same CUDA
tensors: marginals within 1e-5, labels equal, two runs bit for bit, one count
a call. The splat sums in float64 in another order than the plain version's
float64 prefix, and the slice and softmax sum in another order than
PyTorch's reductions, so the marginals differ in their last bits. On a
machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_mean_field_cuda.py -q

The CPU tests hold the dispatch: CPU tensors and tensors that require grad
keep the plain version, unchanged; a CUDA call over the kernels' limits
raises. This file imports nothing of JAX.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from rovinasemanticsegmentation_tpu_torch.models import crf
from rovinasemanticsegmentation_tpu_torch.models.lattice import (
    attach_sorted_stream,
    build_lattice,
    build_lattice_device,
    lattice_filter_t,
    lattice_tensors,
    pad_lattice,
)
from rovinasemanticsegmentation_tpu_torch.ops import mean_field_cuda
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
    crf_feats,
    crf_labels_multi,
)
from rovinasemanticsegmentation_tpu_torch.scripts.profile_frames import (
    FRAME_SEED,
    make_frames,
)

BLOCKS = (8, 9)  # material and object classes
UNKNOWN = (7, 8)
WEIGHT = 10.0  # dcrf_kernel_weight
ITERATIONS = 10
BUCKET = 1 << 14  # LocalMapPipeline's first vertex bucket
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _unaries(rng, n: int, blocks=BLOCKS) -> np.ndarray:
    """Fused unaries as the map path sums them: the log-posteriors of 5
    keyframes, each layer's posterior a Dirichlet draw. -> [N, sum(blocks)]"""
    parts = []
    for c in blocks:
        post = rng.dirichlet(np.full(c, 0.7), size=(5, n)).astype(np.float32)
        parts.append(np.log(np.maximum(post, 1e-6)).sum(axis=0))
    return np.concatenate(parts, axis=1)


def _phase4_map(k: int):
    """``chip_smoke.py`` phase 4's map ``k``: (points, colours)."""
    frames = make_frames(np.random.default_rng(FRAME_SEED),
                         chip_smoke.N_KEYFRAMES)
    map_rng = np.random.default_rng(2)
    for j in range(k + 1):
        cloud = chip_smoke.make_cloud(map_rng, frames, j * chip_smoke.MAP_EVERY)
    return cloud


def _random_cloud(seed: int, n: int, scale: float = 0.3):
    """Gaussian points of ``2 * scale`` m spread with random colours: 1.4-2k
    lattice vertices from 1.5-20k points at the default scale."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 2.0 * scale).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    return pts, cols


def _device_lattice(points, colours, dev, bucket=BUCKET):
    feats = crf_feats(torch.from_numpy(points).to(dev),
                      torch.from_numpy(colours).to(dev), 0.5, 4.0)
    *lattice, m = build_lattice_device(feats, bucket)
    return lattice, int(m)


def _plain_norm(lattice, num_vertices):
    n = lattice[5].shape[1]
    ones = lattice[5].new_ones((1, n))
    raw = lattice_filter_t(ones, *lattice, num_vertices)[0]
    return 1.0 / torch.sqrt(raw + 1e-20)


def _labels(q, blocks, unknown=None):
    unknown = unknown or [c - 1 for c in blocks]
    out = []
    for ql, c, unk in zip(torch.split(q, list(blocks)), blocks, unknown):
        floor = torch.tensor(2.0 / c, dtype=torch.float32)
        out.append(torch.where(ql.amax(dim=0) > floor, ql.argmax(dim=0), unk))
    return out


def _check_mean_field(lattice, num_vertices, unary, blocks=BLOCKS,
                      iterations=ITERATIONS):
    """The kernels against the plain mean field on the card: the norm, the
    marginals within TOL, the labels equal, a second run bit-equal, one
    count a call. -> the kernels' marginals."""
    norm = mean_field_cuda.symmetric_norm(*lattice, num_vertices)
    want_norm = _plain_norm(lattice, num_vertices)
    assert torch.allclose(norm, want_norm, rtol=1e-6, atol=0), \
        float(((norm - want_norm).abs() / want_norm).max())
    unary_t = -unary.T
    args = (unary_t, *lattice, want_norm, WEIGHT, blocks, num_vertices,
            iterations)
    before = mean_field_cuda.launches.value
    got = mean_field_cuda.potts_mean_field_multi_t(*args)
    again = mean_field_cuda.potts_mean_field_multi_t(*args)
    torch.cuda.synchronize()
    assert mean_field_cuda.launches.value == before + 2
    want = crf.potts_mean_field_multi_plain_t(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= TOL, f"marginals differ by {err}"
    for a, b in zip(_labels(got, blocks), _labels(want, blocks)):
        assert torch.equal(a, b), f"{int((a != b).sum())} labels differ"
    assert torch.equal(got, again), "two runs differ"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1])
def test_phase4_maps(dev, k):
    points, colours = _phase4_map(k)
    lattice, m = _device_lattice(points, colours, dev)
    assert 1000 < m <= BUCKET  # padded slots in the bucket
    unary = torch.from_numpy(_unaries(np.random.default_rng(k), len(points)))
    q = _check_mean_field(lattice, BUCKET, unary.to(dev))
    assert (q.sum(dim=0) - 2).abs().max() < 1e-5  # two blocks, each sums to 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,blocks", [
    (11, 3000, BLOCKS), (12, 20000, BLOCKS), (13, 5000, (17,)),
    (14, 4000, (3,)), (15, 2500, (20, 20)),  # two channels a splat lane
    (16, 2500, (5, 30, 29)),  # the most channels the kernels take
])
def test_random_clouds(dev, seed, n, blocks):
    points, colours = _random_cloud(seed, n)
    lattice, m = _device_lattice(points, colours, dev)
    assert m <= BUCKET
    rng = np.random.default_rng(seed)
    unary = torch.from_numpy(_unaries(rng, n, blocks)).to(dev)
    _check_mean_field(lattice, BUCKET, unary, blocks, iterations=5)


@pytest.mark.cuda
def test_zero_iterations_is_the_block_softmax(dev):
    points, colours = _random_cloud(21, 1000)
    lattice, _ = _device_lattice(points, colours, dev)
    unary = torch.from_numpy(_unaries(np.random.default_rng(21), 1000)).to(dev)
    norm = _plain_norm(lattice, BUCKET)
    got = mean_field_cuda.potts_mean_field_multi_t(
        -unary.T, *lattice, norm, WEIGHT, BLOCKS, BUCKET, 0)
    want = crf.normalize_blocks(unary.T, BLOCKS)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("channels,reverse", [(1, False), (1, True),
                                               (17, False), (17, True),
                                               (64, True)])
def test_filter(dev, channels, reverse):
    """The filter alone (splat, blur, slice) against ``lattice_filter_t``:
    the filter of ones (the normalisation's, C = 1), marginals-like values,
    the transposed filter's reversed blur."""
    points, colours = _phase4_map(0)
    lattice, _ = _device_lattice(points, colours, dev)
    n = len(points)
    rng = np.random.default_rng(channels)
    values = (torch.ones((1, n)) if channels == 1 else
              torch.from_numpy(rng.random((channels, n)).astype(np.float32)))
    values = values.to(dev)
    got = mean_field_cuda.lattice_filter_t(values, *lattice, BUCKET, reverse)
    want = lattice_filter_t(values, *lattice, BUCKET, reverse=reverse)
    torch.cuda.synchronize()
    rel = ((got - want).abs() / want.abs().clamp_min(1e-3)).max()
    assert float(rel) <= 1e-6, float(rel)
    assert torch.equal(
        got, mean_field_cuda.lattice_filter_t(values, *lattice, BUCKET, reverse))


@pytest.mark.cuda
def test_host_lattice_with_padded_slots(dev):
    """A host build (native builder, padded to the bucket, sorted stream) as
    ``lattice_tensors`` uploads it: insertion-order ids, padded slots."""
    points, colours = _random_cloud(31, 4000)
    feats = crf_feats(torch.from_numpy(points), torch.from_numpy(colours),
                      0.5, 4.0)
    host = attach_sorted_stream(pad_lattice(build_lattice(feats.numpy()),
                                            bucket=4096))
    assert host.num_vertices == 4096
    lattice = lattice_tensors(host, dev)
    unary = torch.from_numpy(_unaries(np.random.default_rng(31), 4000)).to(dev)
    _check_mean_field(lattice, host.num_vertices, unary)


@pytest.mark.cuda
def test_overflowed_bucket(dev):
    """More vertices than slots: the build clamps the ids into the bucket.
    The kernels read the same clamped lattice as the plain version, and the
    map path labels such a map all Unknown."""
    points, colours = _random_cloud(41, 6000, scale=1.0)
    bucket = 4096
    lattice, m = _device_lattice(points, colours, dev, bucket)
    assert m > bucket
    unary = torch.from_numpy(_unaries(np.random.default_rng(41), 6000)).to(dev)
    _check_mean_field(lattice, bucket, unary, iterations=3)
    overflow = torch.tensor(True, device=dev)
    labels = crf_labels_multi(unary, lattice, WEIGHT, BLOCKS, bucket, 3,
                              UNKNOWN, overflow)
    for lbl, unk in zip(labels, UNKNOWN):
        assert bool((lbl == unk).all())


@pytest.mark.cuda
def test_production_call_takes_the_kernels_once_a_map(dev):
    """``crf_labels_multi`` (the map path's) runs the norm and the mean field
    through the kernels, one count a call, with the plain path's labels."""
    points, colours = _phase4_map(1)
    lattice, _ = _device_lattice(points, colours, dev)
    unary = torch.from_numpy(_unaries(np.random.default_rng(5), len(points)))
    unary = unary.to(dev)
    before = mean_field_cuda.launches.value
    for k in range(3):
        got = crf_labels_multi(unary, lattice, WEIGHT, BLOCKS, BUCKET,
                               ITERATIONS, UNKNOWN)
        assert mean_field_cuda.launches.value == before + k + 1
    norm = _plain_norm(lattice, BUCKET)
    q = crf.potts_mean_field_multi_plain_t(-unary.T, *lattice, norm, WEIGHT,
                                           BLOCKS, BUCKET, ITERATIONS)
    for a, b in zip(got, _labels(q, BLOCKS, UNKNOWN)):
        assert torch.equal(a.long(), b)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernels_do_not_take(dev):
    points, colours = _random_cloud(51, 500)
    lattice, _ = _device_lattice(points, colours, dev)
    unary = torch.zeros((17, 500), device=dev)
    norm = torch.ones(500, device=dev)

    def call(unary=unary, lattice=lattice, norm=norm, blocks=BLOCKS):
        mean_field_cuda.launcher(unary, *lattice, norm, WEIGHT, blocks, BUCKET,
                                 2)

    bad = list(lattice)
    bad[4] = lattice[4].T.contiguous().T  # offsets_t, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        call(lattice=bad)
    bad = list(lattice)
    bad[5] = lattice[5].double()
    with pytest.raises(ValueError, match="float32"):
        call(lattice=bad)
    bad = list(lattice)
    bad[2] = lattice[2].int()
    with pytest.raises(ValueError, match="int64"):
        call(lattice=bad)
    with pytest.raises(ValueError, match="float32"):
        call(unary=unary.double())
    with pytest.raises(ValueError, match="blocks"):
        call(unary=torch.zeros((65, 500), device=dev), blocks=(33, 32))
    with pytest.raises(ValueError, match="blocks"):
        call(blocks=(8, 8))
    with pytest.raises(ValueError, match="norm"):
        call(norm=norm[:-1])
    with pytest.raises(ValueError, match="channels"):
        mean_field_cuda.engages(torch.zeros((65, 500), device=dev), lattice[5])
    with pytest.raises(ValueError, match="corners"):
        mean_field_cuda.engages(unary, torch.zeros((17, 500), device=dev))


# ----------------------------------------------------------------------
# The dispatch, on the CPU
# ----------------------------------------------------------------------


def _fake(device: str, shape, requires_grad=False):
    """What ``engages`` reads of a tensor, on any device."""
    return types.SimpleNamespace(device=torch.device(device), shape=shape,
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("values,bary,takes", [
    (_fake("cuda", (17, 30000)), _fake("cuda", (7, 30000)), True),
    (None, _fake("cuda", (7, 30000)), True),  # the filter of ones
    (_fake("cuda", (64, 10)), _fake("cuda", (16, 10)), True),
    (_fake("cuda", (1, 10)), _fake("cuda", (1, 10)), True),
    (_fake("cpu", (17, 30000)), _fake("cpu", (7, 30000)), False),
    (None, _fake("cpu", (7, 30000)), False),
    (_fake("cuda", (17, 10), True), _fake("cuda", (7, 10)), False),
    (_fake("cuda", (17, 10)), _fake("cuda", (7, 10), True), False),
    (_fake("meta", (17, 10)), _fake("meta", (7, 10)), False),
])
def test_engages(values, bary, takes):
    assert mean_field_cuda.engages(values, bary) is takes


@pytest.mark.parametrize("values,bary", [
    (_fake("cuda", (65, 10)), _fake("cuda", (7, 10))),
    (_fake("cuda", (17, 10)), _fake("cuda", (17, 10))),
    (None, _fake("cuda", (17, 10))),
])
def test_engages_raises_over_the_limits(values, bary):
    with pytest.raises(ValueError, match="corners"):
        mean_field_cuda.engages(values, bary)


@pytest.fixture(scope="module")
def cpu_map():
    points, colours = _random_cloud(7, 1500)
    feats = crf_feats(torch.from_numpy(points), torch.from_numpy(colours),
                      0.5, 4.0)
    *lattice, m = build_lattice_device(feats, 1 << 12)
    assert int(m) <= 1 << 12
    unary = torch.from_numpy(_unaries(np.random.default_rng(7), 1500))
    return lattice, 1 << 12, unary


def _refuse(*args, **kwargs):
    raise AssertionError("the kernels' wrapper was called")


def _plain_before(unary_t, lattice, norm, weight, blocks, num_vertices,
                  n_iterations):
    """``potts_mean_field_multi_t`` as it was before the kernels."""
    q = crf.normalize_blocks(-unary_t, blocks)
    for _ in range(n_iterations):
        filtered = lattice_filter_t(q * norm, *lattice, num_vertices) * norm
        q = crf.normalize_blocks(-unary_t + weight * filtered, blocks)
    return q


@pytest.mark.parametrize("blocks,iterations", [(BLOCKS, 3), ((17,), 2),
                                               (BLOCKS, 0)])
def test_cpu_tensors_keep_the_plain_version(monkeypatch, cpu_map, blocks,
                                            iterations):
    lattice, bucket, unary = cpu_map
    monkeypatch.setattr(mean_field_cuda, "potts_mean_field_multi_t", _refuse)
    monkeypatch.setattr(mean_field_cuda, "symmetric_norm", _refuse)
    norm = crf.symmetric_norm(lattice, bucket)
    assert torch.equal(norm, _plain_norm(lattice, bucket))
    got = crf.potts_mean_field_multi_t(-unary.T, *lattice, norm, WEIGHT,
                                       blocks, bucket, iterations)
    want = _plain_before(-unary.T, lattice, norm, WEIGHT, blocks, bucket,
                         iterations)
    assert torch.equal(got, want)


def test_cpu_map_labels_keep_the_plain_version(monkeypatch, cpu_map):
    lattice, bucket, unary = cpu_map
    monkeypatch.setattr(mean_field_cuda, "potts_mean_field_multi_t", _refuse)
    monkeypatch.setattr(mean_field_cuda, "symmetric_norm", _refuse)
    got = crf_labels_multi(unary, lattice, WEIGHT, BLOCKS, bucket, 3, UNKNOWN)
    q = _plain_before(-unary.T, lattice, _plain_norm(lattice, bucket), WEIGHT,
                      BLOCKS, bucket, 3)
    for a, b in zip(got, _labels(q, BLOCKS, UNKNOWN)):
        assert torch.equal(a.long(), b)
    assert any(bool((a != unk).any()) for a, unk in zip(got, UNKNOWN))


def test_tensors_that_require_grad_keep_the_plain_version(monkeypatch,
                                                          cpu_map):
    """The plain version keeps the autograd graph (``engages`` is false for
    such tensors on any device: ``test_engages``)."""
    lattice, bucket, unary = cpu_map
    monkeypatch.setattr(mean_field_cuda, "potts_mean_field_multi_t", _refuse)
    unary_t = (-unary.T).clone().requires_grad_()
    norm = _plain_norm(lattice, bucket)
    got = crf.potts_mean_field_multi_t(unary_t, *lattice, norm, WEIGHT,
                                       BLOCKS, bucket, 2)
    got.sum().backward()
    assert unary_t.grad is not None
    assert torch.equal(got.detach(), _plain_before(
        unary_t.detach(), lattice, norm, WEIGHT, BLOCKS, bucket, 2))


def test_dispatch_sends_an_engaged_call_to_the_wrapper(monkeypatch, cpu_map):
    lattice, bucket, unary = cpu_map
    calls = []

    def spy(*args):
        calls.append(args)
        return crf.potts_mean_field_multi_plain_t(*args)

    def norm_spy(*args):
        calls.append(args)
        return _plain_norm(list(args[:8]), args[8])

    monkeypatch.setattr(mean_field_cuda, "engages", lambda values, bary: True)
    monkeypatch.setattr(mean_field_cuda, "potts_mean_field_multi_t", spy)
    monkeypatch.setattr(mean_field_cuda, "symmetric_norm", norm_spy)
    got = crf_labels_multi(unary, lattice, WEIGHT, BLOCKS, bucket, 2, UNKNOWN)
    assert len(calls) == 2
    assert len(calls[0]) == 9 and calls[0][8] == bucket
    assert calls[1][10:] == (WEIGHT, BLOCKS, bucket, 2)
    assert torch.equal(calls[1][0], -unary.T)
    q = _plain_before(-unary.T, lattice, _plain_norm(lattice, bucket), WEIGHT,
                      BLOCKS, bucket, 2)
    for a, b in zip(got, _labels(q, BLOCKS, UNKNOWN)):
        assert torch.equal(a.long(), b)


def test_launcher_refuses_cpu_tensors(cpu_map):
    lattice, bucket, unary = cpu_map
    norm = _plain_norm(lattice, bucket)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mean_field_cuda.launcher(-unary.T, *lattice, norm, WEIGHT, BLOCKS,
                                 bucket, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mean_field_cuda.symmetric_norm(*lattice, bucket)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mean_field_cuda.lattice_filter_t(unary.T.contiguous(), *lattice,
                                         bucket)


@pytest.mark.parametrize("channels,vec", [(1, 1), (4, 1), (5, 5), (17, 5),
                                          (20, 5), (21, 16), (64, 16)])
def test_row_width(channels, vec):
    assert mean_field_cuda.row_width(channels) == vec


def test_row_widths_are_the_kernels_instantiations():
    """``ROW_WIDTHS`` names the template widths ``csrc/mean_field.cu``
    instantiates (its ``FOR_WIDTHS``), and the widest holds MAX_CHANNELS."""
    import re
    from pathlib import Path

    from rovinasemanticsegmentation_tpu_torch import csrc

    source = (Path(csrc.__file__).parent / "mean_field.cu").read_text()
    line = re.search(r"#define FOR_WIDTHS\(X\) (.*)", source).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", line)) == \
        mean_field_cuda.ROW_WIDTHS
    assert 4 * mean_field_cuda.ROW_WIDTHS[-1] == mean_field_cuda.MAX_CHANNELS
