"""PyTorch port vs JAX reference: surface-normal angles and the chamfer map.

The port computes the gradients, integral images, box sums and ``acos`` in
float64 and rounds only the angle to float32. Its yardstick at VGA is the
JAX package's own function run under ``jax.enable_x64(True)`` on float64
points: the JAX float32 function is up to ~0.03 rad from that run there
(float32 running totals over 307200 pixels), while the port stays within
2.4e-7 rad (2 float32 ulps near pi/2). Masks (the -2 pixels) must equal the
JAX float32 function's, whose depth-change map the port computes the same
way. The chamfer map (float32 sums of 1.0 and 1.4) must be bit-equal to
JAX's, and within 1e-6 of the sequential PCL oracle, which sums in float64.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.ops import geometry as jgeom
from rovinasemanticsegmentation_tpu.ops import normals as jnormals
from rovinasemanticsegmentation_tpu_torch.ops import normals
from rovinasemanticsegmentation_tpu_torch.scripts import make_bench_forest as recipe

sys.path.insert(0, os.path.dirname(__file__))
from pcl_normals_oracle import chamfer_distance_map as oracle_chamfer  # noqa: E402
from pcl_normals_oracle import normal_angles_oracle  # noqa: E402

torch.set_num_threads(2)

ANGLE_TOL = 2.4e-7  # rad: 2 float32 ulps near pi/2


@pytest.fixture(scope="module")
def recipe_points():
    """The recipe's first two VGA frames, backprojected (fx = fy = 525)."""
    gen = recipe.frames()
    kinv = np.linalg.inv(
        np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]])
    ).astype(np.float32)
    out = []
    for _ in range(2):
        _, depth, _ = next(gen)
        out.append(np.asarray(jgeom.backproject(
            jnp.asarray(depth), jnp.asarray(kinv), jnp.eye(3), jnp.zeros(3),
            jnp.float32(0.5), jnp.float32(15.0),
        )).copy())
    return out


def _jax_angles(pts, stride, x64, **kw):
    fn = (jnormals.normal_angles if stride is None
          else lambda p, **k: jnormals.normal_angles_grid(p, stride, **k))
    if not x64:
        return np.asarray(fn(jnp.asarray(pts), chamfer_variant="iter", **kw))
    with jax.enable_x64(True):
        return np.asarray(fn(jnp.asarray(pts.astype(np.float64)),
                             chamfer_variant="iter", **kw))


def _port_angles(pts, stride, **kw):
    p = torch.from_numpy(pts)
    if stride is None:
        return normals.normal_angles(p, **kw).numpy()
    return normals.normal_angles_grid(p, stride, **kw).numpy()


def _check_against_jax(pts, stride, **kw):
    got = _port_angles(pts, stride, **kw)
    want32 = _jax_angles(pts, stride, False, **kw)
    want64 = _jax_angles(pts, stride, True, **kw)
    assert got.dtype == np.float32 and got.shape == want32.shape
    np.testing.assert_array_equal(got == -2.0, want32 == -2.0)
    valid = got != -2.0
    assert valid.sum() > 100
    err = np.abs(got[valid].astype(np.float64) - want64[valid])
    print(f"stride {stride}: {int(valid.sum())} valid, port vs float64 JAX "
          f"{err.max():.3g} rad; float32 JAX vs float64 "
          f"{np.abs(want32[valid] - want64[valid]).max():.3g} rad")
    assert err.max() <= ANGLE_TOL


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("stride", [2, 5, None])
def test_recipe_frames_against_float64_jax(recipe_points, frame, stride):
    _check_against_jax(recipe_points[frame], stride)


def _scene(seed, h, w, hole_frac):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    z = 2.0 + 0.3 * np.sin(xs / 7.0) + 0.2 * (ys / h) + rng.normal(0, 0.004, (h, w))
    z = np.where(xs > w // 2, z + 0.6, z)
    pts = np.stack([(xs - w / 2) * z / 60, (ys - h / 2) * z / 60, z], -1)
    pts[rng.random((h, w)) < hole_frac] = np.nan
    return pts.astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2, 3, None])
def test_non_integral_smoothing_size_takes_the_exact_chamfer(stride):
    """normal_smoothing_size 6.5: the exact two-pass chamfer, as in JAX."""
    _check_against_jax(_scene(7, 64, 80, 0.03), stride, normal_smoothing_size=6.5)


def test_vga_grid_non_integral_size(recipe_points):
    _check_against_jax(recipe_points[0], 2, normal_smoothing_size=6.5)


class TestPclOracle:
    """The four scenes of ``tests/test_feature_ops.py::TestNormalsVsPclOracle``
    through the port's ``normal_angles``, against the literal scalar PCL
    port: -2 masks equal, at most 0.5% of the pixels beyond 2e-3 rad (the
    JAX test's contract; the oracle is float64 too)."""

    def _compare(self, pts, **kw):
        want = normal_angles_oracle(pts, **kw)
        got = normals.normal_angles(
            torch.from_numpy(pts.astype(np.float32)), **kw).numpy()
        np.testing.assert_array_equal(got == -2.0, want == -2.0)
        loose = np.abs(got - want) > 2e-3
        assert loose.mean() <= 0.005, f"{loose.sum()} pixels beyond tolerance"

    def test_smooth_scene_with_holes(self):
        r = np.random.default_rng(0)
        h, w = 36, 44
        ys, xs = np.mgrid[0:h, 0:w]
        z = 2.0 + 0.3 * np.sin(xs / 7.0) + 0.2 * (ys / h)
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        pts[r.random((h, w)) < 0.04] = np.nan
        self._compare(pts)

    def test_step_edges(self):
        h, w = 40, 48
        ys, xs = np.mgrid[0:h, 0:w]
        z = np.where(xs < 24, 2.0, 3.0) + 0.01 * ys / h
        z[28:, :10] = 1.5
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        self._compare(pts)

    def test_noisy_depth(self):
        r = np.random.default_rng(3)
        h, w = 32, 40
        ys, xs = np.mgrid[0:h, 0:w]
        z = 2.5 + r.normal(0, 0.01, (h, w))
        z[r.random((h, w)) < 0.02] = np.nan
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        self._compare(pts)

    def test_smaller_smoothing_size(self):
        h, w = 30, 30
        ys, xs = np.mgrid[0:h, 0:w]
        z = 2.0 + 0.2 * np.sin(ys / 5.0)
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        self._compare(pts, normal_smoothing_size=6.0)


class TestChamfer:
    @pytest.mark.parametrize("shape,p", [((15, 17), 0.08), ((33, 41), 0.02),
                                         ((8, 64), 0.1)])
    def test_exact_equals_jax_and_pcl_oracle(self, shape, p):
        rng = np.random.default_rng(2)
        mask = rng.random(shape) < p
        mask[0, 0] = True
        got = normals.chamfer_distance_map(torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jnormals.chamfer_distance_map(jnp.asarray(mask))))
        # The oracle adds 1.4 in float64: float32 sums are a few ulps off.
        np.testing.assert_allclose(got, oracle_chamfer(mask), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("shape,p,sat", [((60, 70), 0.01, 10.0),
                                             ((45, 33), 0.03, 6.0)])
    def test_iter_equals_jax(self, shape, p, sat):
        rng = np.random.default_rng(4)
        mask = rng.random(shape) < p
        mask[3, 5] = True
        got = normals.chamfer_distance_map(
            torch.from_numpy(mask), saturation=sat, variant="iter").numpy()
        want = np.asarray(jnormals.chamfer_distance_map(
            jnp.asarray(mask), saturation=sat, variant="iter"))
        np.testing.assert_array_equal(got, want)
        # Where consumed (clamped at sat, away from the top/bottom edge), the
        # saturated map equals the exact one and the PCL oracle.
        b = int(np.ceil(sat))
        exact = np.minimum(oracle_chamfer(mask), sat)[b:-b]
        np.testing.assert_allclose(np.minimum(got, sat)[b:-b], exact,
                                   rtol=1e-6, atol=1e-6)

    def test_edge_seeds_equal_jax(self):
        mask = np.zeros((30, 40), bool)
        mask[15, 0] = mask[0, 20] = mask[29, 39] = True
        for sat in (None, 6.0):
            got = normals.chamfer_distance_map(torch.from_numpy(mask), sat).numpy()
            want = np.asarray(jnormals.chamfer_distance_map(jnp.asarray(mask), sat))
            np.testing.assert_array_equal(got, want)

    def test_banded_variant_is_not_ported(self):
        with pytest.raises(ValueError):
            normals.chamfer_distance_map(torch.zeros((8, 8), dtype=torch.bool),
                                         saturation=4.0, variant="banded")
