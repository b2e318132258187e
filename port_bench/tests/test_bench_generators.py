"""The generators repeat by seed, and the frozen copies still equal the
port bench's generators they were taken from."""

import numpy as np
import torch

from port_bench import gen
from port_bench.tests.tiny import SEED


def test_pool_and_cloud_repeat_by_seed():
    a, ra = gen.make_pool(SEED, 3, 48, 64)
    b, rb = gen.make_pool(SEED, 3, 48, 64)
    c, _ = gen.make_pool(SEED + 1, 3, 48, 64)
    for (x, y), (u, v) in zip(a, b):
        assert np.array_equal(x, u) and np.array_equal(y, v)
    assert not np.array_equal(a[0][1], c[0][1])
    pa = gen.make_cloud(ra, a, 60.0, 48, 64, 3, 300)
    pb = gen.make_cloud(rb, b, 60.0, 48, 64, 3, 300)
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert pa[0].shape == (300, 3) and pa[0].dtype == np.float32


def test_perturb_on_device_equals_host():
    frames, _ = gen.make_pool(SEED, 1, 16, 24)
    rgb, depth = frames[0]
    for e in (1, 255, 300):
        t_rgb, t_depth = gen.perturb(torch.from_numpy(rgb),
                                     torch.from_numpy(depth.astype(np.int32)), e)
        h_rgb, h_depth = gen.perturb_np(rgb, depth, e)
        assert np.array_equal(t_rgb.numpy(), h_rgb)
        assert np.array_equal(t_depth.numpy(), h_depth)
    assert ((gen.perturb_np(rgb, depth, 7)[1] == 0) == (depth == 0)).all()


def test_frozen_copies_equal_the_port_bench():
    from rovinasemanticsegmentation_tpu_torch import bench

    wl = bench.Workload(height=48, width=64, keyframes=5, map_every=5,
                        map_points=500, batch=5, curve=(5,))
    frames, (pts, cols) = bench.make_workload(SEED, wl)
    ours, rng = gen.make_pool(SEED, 5, 48, 64)
    for (x, y), (u, v) in zip(frames, ours):
        assert np.array_equal(x, u) and np.array_equal(y, v)
    # The port bench's cloud uses its VGA focal length whatever the size.
    got = gen.make_cloud(rng, ours, bench.FOCAL, 48, 64, 5, 500)
    assert np.array_equal(got[0], pts) and np.array_equal(got[1], cols)
