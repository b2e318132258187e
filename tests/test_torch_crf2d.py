"""PyTorch port vs JAX reference: the offline CRF modules.

The z-buffer projection and the unary accumulation of the fusion layer, the
points-major lattice filter, ``DenseCRF``/``DenseCRF2D`` with every
normalisation and compatibility, the points-major mean fields and
``_crf_labels``, the 2D device build and the ``dense_inference`` demo, each
held against the JAX package on the same seeded numpy inputs (JAX on the
CPU).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.cli import dense_inference as jdi
from rovinasemanticsegmentation_tpu.fusion.projector import (
    MultiProjector as JMultiProjector,
)
from rovinasemanticsegmentation_tpu.fusion.unaries import (
    accumulate_unaries as jax_accumulate_unaries,
)
from rovinasemanticsegmentation_tpu.models import crf as JC
from rovinasemanticsegmentation_tpu.models import lattice as JL
from rovinasemanticsegmentation_tpu.models.crf2d_device import (
    dense2d_map_from_labels_device as jax_dense2d,
)
from rovinasemanticsegmentation_tpu.pipelines import local_map as jlm
from rovinasemanticsegmentation_tpu.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu.utils.imageio import load_ppm, save_ppm
from rovinasemanticsegmentation_tpu_torch.cli import dense_inference as tdi
from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu_torch.fusion.unaries import (
    accumulate_unaries,
)
from rovinasemanticsegmentation_tpu_torch.models import crf as TC
from rovinasemanticsegmentation_tpu_torch.models import lattice as TL
from rovinasemanticsegmentation_tpu_torch.models.crf2d_device import (
    dense2d_map_from_labels_device,
)
from rovinasemanticsegmentation_tpu_torch.pipelines import local_map as tlm
from rovinasemanticsegmentation_tpu_torch.scripts.bench_dense_inference import (
    make_demo_pair,
)

import test_crf_learning

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5  # f32 summation order of the splat (ROADMAP queue 3)
CPU = torch.device("cpu")


# ----------------------------------------------------------------------
# Fusion: z-buffer projection and unary accumulation
# ----------------------------------------------------------------------


def _calibrations(h, w, ncam):
    """Camera 0 looks down +z; camera 1 is turned 180 degrees about y."""
    k = np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]])
    rots = [np.eye(3), np.array([[-1.0, 0, 0], [0, 1, 0], [0, 0, -1]])]
    return [Calibration(intrinsic=k, rotation=rots[c], translation=np.zeros(3))
            for c in range(ncam)]


def _projectors(h, w, ncam):
    calibs = _calibrations(h, w, ncam)
    return (JMultiProjector.from_calibrations(calibs, h, w, 0.5, 15.0),
            MultiProjector.from_calibrations(calibs, h, w, 0.5, 15.0))


def _cloud(n, seed):
    """Points in front of and behind the keyframe, some out of range, and
    repeated points so that equal depths meet in one pixel."""
    rng = np.random.default_rng(seed)
    z = rng.choice([-1.0, 1.0], n) * rng.uniform(0.2, 16.0, n)
    pts = np.stack([rng.uniform(-0.6, 0.6, n) * np.abs(z),
                    rng.uniform(-0.5, 0.5, n) * np.abs(z), z], axis=1)
    pts[n // 2 : n // 2 + n // 10] = pts[: n // 10]
    return pts.astype(np.float32)


@pytest.mark.parametrize("case", ["same_ray", "cloud", "two_cameras"])
def test_project_zbuffer_matches_jax(case):
    pose = np.eye(4, dtype=np.float32)
    if case == "same_ray":  # tests/test_fusion.py: the nearest point wins
        jp, tp = _projectors(20, 24, 1)
        pts = np.array([[0.0, 0.0, 4.0], [0.0, 0.0, 2.0]], dtype=np.float32)
    else:
        jp, tp = _projectors(20, 24, 1 if case == "cloud" else 2)
        pts = _cloud(2000, 7)
        angle = 0.2
        pose[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                        [-np.sin(angle), 0, np.cos(angle)]]
        pose[:3, 3] = [0.1, -0.05, 0.3]
    want_z, want_idx = (np.asarray(a) for a in jp.project(pts, pose))
    got_z, got_idx = tp.project(pts, pose)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    hit = want_idx >= 0
    assert np.isinf(got_z.numpy()[~hit]).all()
    if case == "two_cameras":
        # XLA's CPU dot fuses the multiply-adds of some rows of the stacked
        # [C3 * 3, 3] rotation and not of others (ROADMAP queue 3).
        np.testing.assert_array_max_ulp(got_z.numpy()[hit], want_z[hit],
                                        maxulp=2)
    else:  # one camera: the port's multiply-add chain is XLA's
        np.testing.assert_array_equal(got_z.numpy()[hit], want_z[hit])
    if case == "same_ray":
        assert got_idx[10, 12] == 1 and (got_idx >= 0).sum() == 1
    else:
        assert 0.2 < hit.mean() < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulate_unaries_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h, w, c, n = 30, 40, 5, 100  # 1200 pixels on 100 points
    post = rng.uniform(0.0, 1.0, (h, w, c)).astype(np.float32)
    idx = rng.integers(-1, n, (h, w)).astype(np.int32)
    start = rng.normal(size=(n, c)).astype(np.float32)
    want = np.asarray(jax_accumulate_unaries(
        jnp.asarray(start), jnp.asarray(post), jnp.asarray(idx), n))
    got = accumulate_unaries(torch.from_numpy(start), torch.from_numpy(post),
                             torch.from_numpy(idx), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_accumulate_unaries_two_pixels_on_one_point():
    """tests/test_fusion.py::TestUnaries::test_scatter_add on the port."""
    post = np.zeros((4, 4, 3), dtype=np.float32)
    post[1, 1] = [0.1, 0.2, 0.7]
    post[2, 2] = [0.5, 0.3, 0.2]
    idx = np.full((4, 4), -1, dtype=np.int32)
    idx[1, 1] = idx[2, 2] = 0
    out = accumulate_unaries(torch.zeros((2, 3)), torch.from_numpy(post),
                             torch.from_numpy(idx), 2).numpy()
    np.testing.assert_allclose(out[0], [0.6, 0.5, 0.9], rtol=1e-6)
    np.testing.assert_allclose(out[1], 0.0)


# ----------------------------------------------------------------------
# The points-major lattice filter
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lattices():
    """One feature set through both packages' host builds (native builder)."""
    f = np.random.default_rng(0).normal(size=(300, 5)).astype(np.float32)
    return JL.build_lattice(f), TL.attach_sorted_stream(TL.build_lattice(f))


def _jax_tensors(lat):
    return tuple(jnp.asarray(a) for a in (lat.offsets, lat.barycentric,
                                          lat.blur_n1, lat.blur_n2))


@pytest.mark.parametrize("reverse", [False, True])
def test_lattice_filter_matches_jax(host_lattices, reverse):
    jlat, tlat = host_lattices
    assert tlat.num_vertices == jlat.num_vertices
    v = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    want = np.asarray(JL.lattice_filter(jnp.asarray(v), *_jax_tensors(jlat),
                                        jlat.num_vertices, reverse=reverse))
    got = TL.lattice_filter(torch.from_numpy(v), *TL.lattice_tensors(tlat, CPU),
                            tlat.num_vertices, reverse=reverse)
    assert got.shape == (300, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_filter_ones_norm_matches_jax(host_lattices):
    jlat, tlat = host_lattices
    np.testing.assert_allclose(TL.filter_ones_norm(tlat),
                               JL.filter_ones_norm(jlat), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# DenseCRF
# ----------------------------------------------------------------------

N, C = 120, 5


def _problem(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, C)).astype(np.float32),
            rng.normal(size=(N, 2)).astype(np.float32),
            rng.normal(size=(N, 5)).astype(np.float32),
            (rng.normal(size=(C, C)) * 0.5).astype(np.float32))


def _compat(mod, kind, weight, matrix):
    if kind == "potts":
        return mod.PottsCompatibility(weight)
    if kind == "diagonal":
        return mod.DiagonalCompatibility([-1.0, -2.0, -0.5, -1.5, -0.7])
    return mod.MatrixCompatibility(matrix)


def _two_kernel_crf(mod, kind="potts", ntype=3, seed=11):
    """The grid + bilateral shape of the demo: a d=2 and a d=5 kernel."""
    unary, f2, f5, matrix = _problem(seed)
    crf = mod.DenseCRF(N, C) if mod is JC else mod.DenseCRF(N, C, "cpu")
    crf.set_unary_energy(unary)
    nt = mod.NormalizationType(ntype)
    crf.add_pairwise_energy(f2, _compat(mod, kind, 3.0, matrix), nt)
    crf.add_pairwise_energy(f5, _compat(mod, kind, 10.0, matrix), nt)
    return crf


def _near_ties(q):
    top = np.sort(q, axis=1)[:, -2:]
    return top[:, 1] - top[:, 0] < 1e-5


@pytest.mark.parametrize("kind", ["potts", "diagonal", "matrix"])
@pytest.mark.parametrize("ntype", ["NO_NORMALIZATION", "NORMALIZE_BEFORE",
                                   "NORMALIZE_AFTER", "NORMALIZE_SYMMETRIC"])
def test_dense_crf_inference_matches_jax(kind, ntype):
    value = JC.NormalizationType[ntype].value
    jcrf = _two_kernel_crf(JC, kind, value)
    tcrf = _two_kernel_crf(TC, kind, value)
    want = np.asarray(jcrf.inference(4))
    got = tcrf.inference(4)
    assert got.shape == (N, C) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    tie = _near_ties(want)
    np.testing.assert_array_equal(tcrf.map(4)[~tie], jcrf.map(4)[~tie])


def test_fused_equals_step_loop():
    crf = _two_kernel_crf(TC)
    want = crf.inference(5, fused=False).numpy()
    got = crf.inference(5, fused=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert (got.argmax(1) == want.argmax(1)).all()
    np.testing.assert_array_equal(crf.inference(5).numpy(), got)  # auto: fused
    for nt in (0, 1, 2):
        crf = _two_kernel_crf(TC, ntype=nt)
        np.testing.assert_allclose(crf.inference(3, fused=True).numpy(),
                                   crf.inference(3, fused=False).numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_non_potts_takes_the_step_loop():
    crf = _two_kernel_crf(TC, "diagonal")
    assert not crf._can_fuse()
    np.testing.assert_array_equal(crf.inference(3).numpy(),
                                  crf.inference(3, fused=False).numpy())
    with pytest.raises(ValueError, match="all-Potts"):
        crf.map_from_labels(np.zeros(N, np.int32), (1.0, 1.0, 1.0), 2)


def test_map_from_labels_matches_host_unary():
    rng = np.random.default_rng(13)
    labels = rng.integers(-1, C, size=N).astype(np.int32)
    energies = (1.25, 0.75, 0.5)
    unary = np.full((N, C), energies[0], np.float32)
    known = labels >= 0
    unary[known] = energies[1]
    unary[known, labels[known]] = energies[2]
    crf = _two_kernel_crf(TC)
    crf.set_unary_energy(unary)
    got = crf.map_from_labels(labels, energies, 4)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, crf.map(4))
    np.testing.assert_array_equal(
        got, _two_kernel_crf(JC).map_from_labels(labels, energies, 4))


def test_kl_divergence_matches_jax():
    jcrf, tcrf = _two_kernel_crf(JC), _two_kernel_crf(TC)
    q = tcrf.inference(2)
    want = jcrf.kl_divergence(jnp.asarray(q.numpy()))
    got = tcrf.kl_divergence(q)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("w,h,m,sxy", [(12, 10, 4, 8), (80, 64, 6, 20)])
def test_dense_crf_2d_matches_jax(w, h, m, sxy):
    """tests/test_crf.py::test_crf2d_demo_shape through both packages, and
    a 64x80 noise image: its bilateral lattice has ~27000 vertices for 5120
    points, mostly single-point segments of a long splat stream, which a
    float32 splat prefix summed far outside the contract (ROADMAP queue 3)."""
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    unary = rng.normal(size=(w * h, m)).astype(np.float32)
    crfs = (JC.DenseCRF2D(w, h, m), TC.DenseCRF2D(w, h, m, "cpu"))
    for crf, mod in zip(crfs, (JC, TC)):
        crf.set_unary_energy(unary)
        crf.add_pairwise_gaussian(3, 3, mod.PottsCompatibility(3))
        crf.add_pairwise_bilateral(sxy, sxy, 13, 13, 13, rgb,
                                   mod.PottsCompatibility(10))
    want = np.asarray(crfs[0].inference(5))
    np.testing.assert_allclose(crfs[1].inference(5).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    tie = _near_ties(want)
    np.testing.assert_array_equal(crfs[1].map(5)[~tie], crfs[0].map(5)[~tie])


def test_dense_crf_rejects_bad_inputs():
    with pytest.raises(ValueError):
        TC.DenseCRF(4, 2, "mps")
    crf = TC.DenseCRF(4, 2, "cpu")
    with pytest.raises(ValueError, match="unary energy"):
        crf.set_unary_energy(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="feature rows"):
        crf.add_pairwise_energy(np.zeros((5, 2), np.float32),
                                TC.PottsCompatibility(1.0))


# ----------------------------------------------------------------------
# Points-major mean fields and the single-layer map labels
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def map_lattice():
    """A host build over room-scale [xyz * 0.5 ; rgb * 4] features, both
    packages' tensors and the symmetric norm."""
    rng = np.random.default_rng(3)
    n = 400
    pts = rng.uniform([-3.0, -1.5, 0.5], [3.0, 1.5, 6.0], (n, 3))
    feats = np.concatenate([pts * 0.5, rng.uniform(0, 1, (n, 3)) * 4.0],
                           axis=1).astype(np.float32)
    jlat = JL.build_lattice(feats)
    tlat = TL.attach_sorted_stream(TL.build_lattice(feats))
    norm = (1.0 / np.sqrt(JL.filter_ones_norm(jlat) + 1e-20)).astype(np.float32)
    return (_jax_tensors(jlat), TL.lattice_tensors(tlat, CPU),
            jlat.num_vertices, norm)


def _energies(n, blocks, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, sum(blocks))) * 3.0).astype(np.float32)


@pytest.mark.parametrize("iterations", [3, 10])
def test_potts_mean_field_matches_jax(map_lattice, iterations):
    jt, tt, m, norm = map_lattice
    u = _energies(400, (6,), iterations)
    want = np.asarray(JC.potts_mean_field(
        jnp.asarray(u), *jt, jnp.asarray(norm), jnp.float32(10.0), m,
        iterations))
    got = TC.potts_mean_field(torch.from_numpy(u), *tt, torch.from_numpy(norm),
                              10.0, m, iterations)
    assert got.shape == (400, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blocks", [(3, 4), (8, 9)])
def test_potts_mean_field_multi_matches_jax(map_lattice, blocks):
    jt, tt, m, norm = map_lattice
    u = _energies(400, blocks, sum(blocks))
    want = np.asarray(JC.potts_mean_field_multi(
        jnp.asarray(u), *jt, jnp.asarray(norm), jnp.float32(10.0), blocks, m,
        10))
    got = TC.potts_mean_field_multi(torch.from_numpy(u), *tt,
                                    torch.from_numpy(norm), 10.0, blocks, m, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for q in np.split(got.numpy(), np.cumsum(blocks)[:-1], axis=1):
        np.testing.assert_allclose(q.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("classes", [4, 9])
def test_crf_labels_match_jax(map_lattice, classes):
    jt, tt, m, norm = map_lattice
    u = _energies(400, (classes,), 20 + classes)
    unknown = classes - 1
    want = np.asarray(jlm._crf_labels(
        jnp.asarray(u), *jt, jnp.asarray(norm), jnp.float32(10.0), m, 10,
        classes, unknown))
    got = tlm._crf_labels(torch.from_numpy(u), tt, torch.from_numpy(norm),
                          10.0, m, 10, classes, unknown)
    assert got.dtype == torch.int32
    q = np.asarray(JC.potts_mean_field(jnp.asarray(-u), *jt, jnp.asarray(norm),
                                       jnp.float32(10.0), m, 10))
    top = np.sort(q, axis=1)[:, -2:]
    tie = (top[:, 1] - top[:, 0] < 1e-5) | (np.abs(top[:, 1] - 2.0 / classes) < 1e-5)
    assert tie.sum() <= 4
    np.testing.assert_array_equal(got.numpy()[~tie], want[~tie])
    assert (want == unknown).any() and (want != unknown).any()


# ----------------------------------------------------------------------
# The 2D device build and the dense_inference demo
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo():
    """A 36x48 image of noisy colour regions and its annotation, half of the
    pixels unknown (black), 21 labels."""
    im, anno = make_demo_pair(np.random.default_rng(5), 36, 48)
    return im, anno, jdi.annotation_labels(anno)


def test_demo_labels_match_jax(demo):
    im, anno, labels = demo
    np.testing.assert_array_equal(tdi.annotation_labels(anno), labels)
    assert (labels == -1).mean() > 0.3 and labels.max() == 20
    unary, lab = tdi.unary_from_annotation(anno)
    want_unary, _ = jdi.unary_from_annotation(anno)
    np.testing.assert_array_equal(unary, want_unary)
    np.testing.assert_array_equal(tdi.colorize(lab, anno),
                                  jdi.colorize(lab, anno))
    assert tdi.annotation_energies() == jdi.annotation_energies()


def test_dense2d_device_matches_jax(demo):
    im, anno, labels = demo
    args = (im, labels, jdi.annotation_energies(), 21, 5)
    want = jax_dense2d(*args)
    got = dense2d_map_from_labels_device(*args, device="cpu")
    assert got.dtype == np.int32 and got.shape == labels.shape
    np.testing.assert_array_equal(got, want)
    # The bucket retry: 64 slots overflow both builds, which escalate x4
    # until they fit, and end with the same labels.
    retried = dense2d_map_from_labels_device(*args, m_bucket=64, device="cpu")
    np.testing.assert_array_equal(retried, want)


@pytest.mark.parametrize("device_build", [True, False])
def test_dense_inference_run_matches_jax(demo, tmp_path, device_build):
    im, anno, _ = demo
    paths = [str(tmp_path / f) for f in ("im.ppm", "anno.ppm", "jax.ppm",
                                         "torch.ppm")]
    save_ppm(paths[0], im)
    save_ppm(paths[1], anno)
    want = jdi.run(paths[0], paths[1], paths[2], device_build=device_build)
    got = tdi.run(paths[0], paths[1], paths[3], device_build=device_build,
                  device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(load_ppm(paths[3]), load_ppm(paths[2]))


def test_dense_inference_main(demo, tmp_path):
    im, anno, _ = demo
    save_ppm(str(tmp_path / "im.ppm"), im)
    save_ppm(str(tmp_path / "anno.ppm"), anno)
    out = str(tmp_path / "out.ppm")
    tdi.main([str(tmp_path / "im.ppm"), str(tmp_path / "anno.ppm"), out,
              "--device", "cpu"])
    assert load_ppm(out).shape == im.shape
    with pytest.raises(SystemExit):
        tdi.main([out, out])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            tdi.main([str(tmp_path / "im.ppm"), str(tmp_path / "anno.ppm"), out])


REF = test_crf_learning.TestDenseInferenceDemo.REF  # the densecrf examples


@pytest.mark.skipif(
    not os.path.exists(REF + "/im1.ppm"), reason="reference PPMs absent"
)
@pytest.mark.parametrize("device_build", [True, False])
def test_golden_parity_with_reference_binary(tmp_path, device_build):
    """tests/golden/out1_ref.ppm from the compiled C++ example, pixel for
    pixel, as tests/test_crf_learning.py holds the JAX package to it."""
    golden = os.path.join(os.path.dirname(__file__), "golden", "out1_ref.ppm")
    out = str(tmp_path / "out.ppm")
    tdi.run(REF + "/im1.ppm", REF + "/anno1.ppm", out,
            device_build=device_build, device="cpu")
    np.testing.assert_array_equal(load_ppm(out), load_ppm(golden))
