"""PyTorch port vs JAX reference: the permutohedral lattice of the map CRF.

The same features, made with numpy from a seed, go through the JAX
package's ``build_lattice_device`` (JAX on the CPU) and the port's; both
number vertices lexicographically, so their tables must be equal index for
index. The port's host build (native builder or NumPy fallback) is held
against its device build, and the transposed filter against the JAX filter
on the same lattice.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models import lattice as J
from rovinasemanticsegmentation_tpu_torch.models import lattice as T

torch.set_num_threads(2)

BUILD = ("sorted_points", "sorted_weights", "seg_starts", "seg_ends",
         "offsets_t", "barycentric_t", "blur_n1", "blur_n2", "m")


def _room(n, seed):
    """``[xyz * 0.5 ; rgb * 4]`` features of a room-scale coloured cloud."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3.0, -1.5, 0.5], [3.0, 1.5, 6.0], (n, 3))
    rgb = rng.uniform(0.0, 1.0, (n, 3))
    return np.concatenate([pts * 0.5, rgb * 4.0], axis=1).astype(np.float32)


def _normal(n, d, seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


CASES = {
    "n60_d2": lambda: _normal(60, 2, 2, 2.0),  # tests/test_crf.py `features`
    "n60_d5": lambda: _normal(60, 5, 5, 2.0),
    "room_n500_d6": lambda: _room(500, 3),
    "dups_d2": lambda: _normal(60, 2, 7, 0.05),  # duplicate-heavy vertices
    "dups_d5": lambda: _normal(60, 5, 7, 0.05),
}


def _bucket(m):
    return 1 << int(np.ceil(np.log2(m + 1)))


def _port_build(feats, bucket, device="cpu"):
    out = T.build_lattice_device(torch.from_numpy(feats).to(device), bucket)
    return dict(zip(BUILD, (t.cpu().numpy() for t in out)))


def _jax_build(feats, bucket):
    out = J.build_lattice_device(jnp.asarray(feats), m_bucket=bucket)
    return dict(zip(BUILD, (np.asarray(t) for t in out)))


def _assert_segments_hold_same_points(got, want, m):
    for v in range(m):
        a = got["sorted_points"][got["seg_starts"][v]:got["seg_ends"][v]]
        b = want["sorted_points"][want["seg_starts"][v]:want["seg_ends"][v]]
        assert sorted(a.tolist()) == sorted(b.tolist()), f"vertex {v}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_build_matches_jax(case):
    feats = CASES[case]()
    bucket = _bucket(J.build_lattice(feats, use_native=False).num_vertices)
    want = _jax_build(feats, bucket)
    got = _port_build(feats, bucket)
    m = int(want["m"])
    assert int(got["m"]) == m
    for key in ("offsets_t", "blur_n1", "blur_n2", "seg_starts", "seg_ends"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["barycentric_t"], want["barycentric_t"],
                               rtol=1e-5, atol=1e-6)
    assert got["sorted_points"].shape == want["sorted_points"].shape
    _assert_segments_hold_same_points(got, want, m)


def test_embed_simplex_bit_equal_to_jax():
    """Keys and barycentric weights equal to the last bit: the elevation
    must round like XLA's fused multiply-adds (20000 points put ~10^4
    elevation values where rounding each product would differ)."""
    import jax

    feats = _room(20000, 8)
    keys, bary = jax.jit(J._embed_simplex)(jnp.asarray(feats))
    got_keys, got_bary = T._embed_simplex(torch.from_numpy(feats))
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(keys))
    np.testing.assert_array_equal(got_bary.numpy(), np.asarray(bary))


def test_overflowing_build_keeps_shapes_and_reports_m():
    feats = CASES["n60_d5"]()
    bucket = 16  # far fewer slots than vertices
    want = _jax_build(feats, bucket)
    got = _port_build(feats, bucket)
    assert int(got["m"]) == int(want["m"]) > bucket
    for key in BUILD[:-1]:
        assert got[key].shape == want[key].shape, key
    assert (got["offsets_t"] < bucket).all()
    assert ((got["blur_n1"] >= 0) & (got["blur_n1"] <= bucket)).all()


def _host_lattice(feats, bucket, use_native):
    return T.attach_sorted_stream(
        T.pad_lattice(T.build_lattice(feats, use_native=use_native), bucket)
    )


@pytest.mark.parametrize("case", ["n60_d5", "room_n500_d6", "dups_d2"])
def test_host_build_matches_device_build(case):
    """NumPy build (lexicographic ids) equals the device build index for
    index; the native builder (insertion-order ids) equals it up to one
    consistent renumbering of the vertices."""
    feats = CASES[case]()
    host = _host_lattice(feats, 64, use_native=False)
    bucket = host.num_vertices
    dev = _port_build(feats, bucket)
    m = int(dev["m"])
    np.testing.assert_array_equal(host.offsets.T, dev["offsets_t"])
    np.testing.assert_array_equal(host.blur_n1, dev["blur_n1"])
    np.testing.assert_array_equal(host.blur_n2, dev["blur_n2"])
    # Real vertices' segments agree; padded ones are empty in both builds
    # (the host's sit at the stream's end, the device's at 0).
    np.testing.assert_array_equal(host.seg_starts[:m], dev["seg_starts"][:m])
    np.testing.assert_array_equal(host.seg_ends[:m], dev["seg_ends"][:m])
    assert (host.seg_starts[m:] == host.seg_ends[m:]).all()
    assert (dev["seg_starts"][m:] == dev["seg_ends"][m:]).all()
    np.testing.assert_array_equal(host.sorted_points, dev["sorted_points"])
    np.testing.assert_allclose(host.barycentric.T, dev["barycentric_t"],
                               rtol=1e-5, atol=1e-6)

    native = _host_lattice(feats, bucket, use_native=True)
    assert native.num_vertices == bucket
    ren = np.full(bucket + 1, bucket)  # native id -> lexicographic id
    ren[native.offsets.reshape(-1)] = dev["offsets_t"].T.reshape(-1)
    np.testing.assert_array_equal(ren[native.offsets], dev["offsets_t"].T)
    assert len(set(ren[:m].tolist())) == m
    for table in ("blur_n1", "blur_n2"):
        want = np.full_like(dev[table], bucket)
        want[:, ren[:m]] = ren[getattr(native, table)[:, :m]]
        np.testing.assert_array_equal(want, dev[table], err_msg=table)
    np.testing.assert_allclose(native.barycentric.T, dev["barycentric_t"],
                               rtol=1e-5, atol=1e-6)


def test_pack_keys_keep_lexicographic_order():
    rng = np.random.default_rng(0)
    coords = rng.integers(-40, 40, (3000, 5))
    coords[::7] = coords[1::7]  # equal keys: the sort must be stable
    packs = T._pack_keys16([torch.from_numpy(coords[:, i]) for i in range(5)], 5)
    assert len(packs) == 3
    want = np.lexsort(coords.T[::-1])  # stable, first column most significant
    np.testing.assert_array_equal(T._lexsort(packs).numpy(), want)
    jpacks = J._pack_keys16(jnp.asarray(coords.astype(np.int32)), 5)
    for a, b in zip(packs, jpacks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Unpacking (arithmetic shift, low half) recovers the coordinates.
    np.testing.assert_array_equal((packs[0] >> 16).numpy(), coords[:, 0])
    np.testing.assert_array_equal(((packs[0] & 0xFFFF) - (1 << 15)).numpy(),
                                  coords[:, 1])


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(4)
    # A splat stream: values times barycentric weights. The error of a
    # float32 prefix difference is a few ulps of the running prefix, here
    # below 2^6 (ulp 3.8e-6).
    s, m = 300, 60
    contrib = (rng.uniform(0, 1, (17, s)) * rng.uniform(0, 2 / 3, s)).astype(
        np.float32
    )
    cuts = np.sort(rng.integers(0, s + 1, m + 1))
    starts, ends = cuts[:-1], cuts[1:]
    want = np.asarray(J.segment_sum_sorted_t(
        jnp.asarray(contrib), jnp.asarray(starts), jnp.asarray(ends)
    ))
    got = T.segment_sum_sorted_t(
        torch.from_numpy(contrib), torch.from_numpy(starts),
        torch.from_numpy(ends),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    prefix = np.pad(np.cumsum(contrib.astype(np.float64), axis=1), ((0, 0), (1, 0)))
    exact = prefix[:, ends] - prefix[:, starts]
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_filter_matches_jax(reverse):
    feats = CASES["room_n500_d6"]()
    bucket = 1 << 12
    built = J.build_lattice_device(jnp.asarray(feats), m_bucket=bucket)
    rng = np.random.default_rng(5)
    vals = rng.uniform(0, 1, (17, feats.shape[0])).astype(np.float32)
    want = np.asarray(J.lattice_filter_t(jnp.asarray(vals), *built[:8], bucket,
                                         reverse=reverse))
    tensors = [torch.from_numpy(np.array(t)) for t in built[:8]]
    got = T.lattice_filter_t(torch.from_numpy(vals), *tensors, bucket,
                             reverse=reverse).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
