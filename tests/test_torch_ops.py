"""PyTorch port vs JAX reference: the per-frame ops of the keyframe path.

The same numpy inputs, made from a seed, go through the JAX function (on the
CPU; Pallas kernels in interpret mode) and its counterpart in
``rovinasemanticsegmentation_tpu_torch`` (on the CPU, so kernel wrappers run
their plain versions).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.ops import color as jcolor
from rovinasemanticsegmentation_tpu.ops import geometry as jgeom
from rovinasemanticsegmentation_tpu.ops import normals as jnormals
from rovinasemanticsegmentation_tpu.ops import patches as jpatches
from rovinasemanticsegmentation_tpu.ops import resize as jresize
from rovinasemanticsegmentation_tpu.ops.patches_pallas import (
    extract_patches_pallas,
)
from rovinasemanticsegmentation_tpu.ops.patches_scan import (
    _tap_tables,
    extract_patches_scan,
)
from rovinasemanticsegmentation_tpu_torch.ops import color, geometry, normals
from rovinasemanticsegmentation_tpu_torch.ops import patches, patches_cuda
from rovinasemanticsegmentation_tpu_torch.ops import resize

torch.set_num_threads(2)


def smooth_depth_mm(rng, h, w, hole_frac=0.02):
    """Piecewise-smooth indoor-style depth in mm with sensor holes."""
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (
        3000.0
        + 1500.0 * np.sin(xs / w * np.pi * rng.uniform(0.5, 2.0))
        + 1000.0 * (ys / h) * rng.uniform(0.5, 3.0)
    )
    for _ in range(3):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        bh, bw = rng.integers(h // 6, h // 2), rng.integers(w // 6, w // 2)
        depth[y0 : y0 + bh, x0 : x0 + bw] = rng.uniform(700, 2500)
    depth += rng.normal(0, 15, (h, w))
    depth[rng.random((h, w)) < hole_frac] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


class TestLab:
    @pytest.mark.parametrize("swap", [True, False])
    def test_bit_exact(self, swap):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (64, 97, 3), dtype=np.uint8)
        want = np.asarray(jcolor.rgb_to_lab8(jnp.asarray(img), swap=swap))
        got = color.rgb_to_lab8(torch.from_numpy(img), swap=swap).numpy()
        np.testing.assert_array_equal(got, want)

    def test_tables_equal(self):
        np.testing.assert_array_equal(color._GAMMA_TAB, jcolor._GAMMA_TAB)
        np.testing.assert_array_equal(color._CBRT_TAB, jcolor._CBRT_TAB)
        np.testing.assert_array_equal(color._COEFFS, jcolor._COEFFS)


class TestImageBasics:
    @pytest.mark.parametrize("h,w,border", [(40, 48, 15), (6, 9, 15)])
    def test_reflect_pad(self, h, w, border):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(jpatches.reflect_pad_image(jnp.asarray(img), border))
        got = patches.reflect_pad_image(torch.from_numpy(img), border).numpy()
        np.testing.assert_array_equal(got, want)

    def test_depth_valid_mask(self):
        rng = np.random.default_rng(2)
        d = rng.integers(0, 16000, (40, 48)).astype(np.uint16)
        d[0, :4] = [499, 500, 15000, 15001]
        want = np.asarray(jgeom.depth_valid_mask(jnp.asarray(d), 0.5, 15.0))
        got = geometry.depth_valid_mask(
            torch.from_numpy(d.astype(np.int32)), 0.5, 15.0
        ).numpy()
        np.testing.assert_array_equal(got, want)

    def test_backproject(self):
        rng = np.random.default_rng(3)
        d = smooth_depth_mm(rng, 40, 48)
        kinv = np.linalg.inv(
            np.array([[30.0, 0, 24.3], [0, 31.0, 19.7], [0, 0, 1]])
        ).astype(np.float32)
        a = 0.3
        rot = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
            np.float32,
        )
        trans = np.array([0.1, -0.2, 1.3], np.float32)
        want = np.asarray(jgeom.backproject(
            jnp.asarray(d), jnp.asarray(kinv), jnp.asarray(rot),
            jnp.asarray(trans), jnp.float32(0.5), jnp.float32(15.0),
        ))
        got = geometry.backproject(
            torch.from_numpy(d.astype(np.int32)), kinv, rot, trans, 0.5, 15.0
        ).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        # XLA contracts the 3-term dot differently: 1 ulp of the ~5 m
        # summands (4.8e-7 m) shows as a large relative error on coordinates
        # near zero, hence the 1e-6 m floor.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)

    @pytest.mark.parametrize("shape,out", [((20, 24, 3), (40, 48)),
                                           ((7, 11), (24, 31))])
    def test_resize_bilinear(self, shape, out):
        rng = np.random.default_rng(4)
        img = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jresize.resize_bilinear(jnp.asarray(img), *out))
        got = resize.resize_bilinear(torch.from_numpy(img), *out).numpy()
        # XLA fuses a*(1-t) + b*t into an FMA; the port rounds both products.
        # Values are O(1) and two passes compound, so a few ulps of 3
        # (2e-6) bound the error where the two terms cancel.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)


def _patch_inputs(seed, b, h, w, s):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 256, (h + 2 * b, w + 2 * b, 3), dtype=np.uint8)
    gh, gw = -(-h // s), -(-w // s)
    depth = rng.uniform(0.05, 8.0, (gh, gw)).astype(np.float32)
    depth[rng.random((gh, gw)) < 0.15] = 0.0
    return lab, depth


class TestPatches:
    def test_tap_tables_equal(self):
        for want, got in zip(_tap_tables(77, 11), patches.tap_tables(77, 11)):
            np.testing.assert_array_equal(got, want)

    def test_half_sizes_divide_like_the_reference(self):
        """floor(B / (2 d)) on depths straddling every integer boundary."""
        import jax

        b = 77
        k = np.arange(1, 200, dtype=np.float32)
        edge = (np.float32(b) / (np.float32(2) * k)).astype(np.float32)
        d = np.concatenate([
            np.nextafter(edge, np.float32(0)), edge,
            np.nextafter(edge, np.float32(1)),
            np.random.default_rng(5).uniform(0.3, 15, 20000),
        ]).astype(np.float32)

        @jax.jit
        def reference(depth):  # ops/patches_pallas.py:162-164
            safe = jnp.maximum(depth, 1e-6)
            half = jnp.floor(b / (2.0 * safe)).astype(jnp.int32)
            return jnp.where(depth > 0, jnp.minimum(half, b), -1)

        got = patches.patch_half_sizes(torch.from_numpy(d), b).numpy()
        np.testing.assert_array_equal(got, np.asarray(reference(d)))

    @pytest.mark.parametrize("s", [1, 2, 4])
    def test_plain_vs_pallas(self, s):
        b, r = 15, 5
        lab, depth = _patch_inputs(10 + s, b, 24, 32, s)
        want = np.asarray(extract_patches_pallas(
            jnp.asarray(lab), jnp.asarray(depth),
            patch_size=b, reduce_size=r, stride=s, interpret=True,
        ))
        got = patches_cuda.extract_patches(
            torch.from_numpy(lab), torch.from_numpy(depth), b, r, s
        ).numpy()
        np.testing.assert_array_equal(got, want)

    def test_plain_vs_scan_stride5(self):
        b, r, s = 15, 5, 5
        lab, depth = _patch_inputs(20, b, 40, 48, s)
        want = np.asarray(extract_patches_scan(
            jnp.asarray(lab), jnp.asarray(depth),
            patch_size=b, reduce_size=r, stride=s,
        ))
        got = patches.extract_patches_plain(
            torch.from_numpy(lab), torch.from_numpy(depth), b, r, s
        ).numpy()
        valid = depth > 0
        np.testing.assert_array_equal(got[valid], want[valid])
        assert not got[~valid].any()  # masked points are zeros

    def test_wrapper_on_cpu_runs_plain_without_launch(self):
        lab, depth = _patch_inputs(21, 9, 16, 20, 2)
        before = patches_cuda.launches.value
        got = patches_cuda.extract_patches(
            torch.from_numpy(lab), torch.from_numpy(depth), 9, 3, 2
        )
        want = patches.extract_patches_plain(
            torch.from_numpy(lab), torch.from_numpy(depth), 9, 3, 2
        )
        assert torch.equal(got, want)
        assert patches_cuda.launches.value == before

    def test_too_small_image_rejected(self):
        lab, depth = _patch_inputs(22, 9, 16, 20, 2)
        with pytest.raises(ValueError):
            patches.extract_patches_plain(
                torch.from_numpy(lab[:-2]), torch.from_numpy(depth), 9, 3, 2
            )


class TestNormals:
    @pytest.mark.parametrize("s", [1, 2, 5])
    def test_grid_angles(self, s):
        rng = np.random.default_rng(30 + s)
        h, w = 64, 80
        d = smooth_depth_mm(rng, h, w)
        kinv = np.linalg.inv(
            np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
        ).astype(np.float32)
        pts = np.asarray(jgeom.backproject(
            jnp.asarray(d), jnp.asarray(kinv), jnp.eye(3), jnp.zeros(3),
            jnp.float32(0.5), jnp.float32(15.0),
        ))
        want = np.asarray(jnormals.normal_angles_grid(
            jnp.asarray(pts), s, chamfer_variant="iter"
        ))
        got = normals.normal_angles_grid(torch.from_numpy(pts.copy()), s).numpy()
        assert got.shape == want.shape
        agree = (got == -2.0) == (want == -2.0)
        assert agree.mean() >= 0.999, f"{(~agree).sum()} masks differ"
        both = (got != -2.0) & (want != -2.0)
        assert both.sum() > 20
        np.testing.assert_allclose(got[both], want[both], atol=1e-4, rtol=0)
