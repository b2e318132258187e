"""Tree-by-tree comparison of forests trained by the JAX package and the port
on the same data, with the near-tie rule of the parity contract.

The two trainers draw the same random numbers, so they grow the same trees
except where two candidate splits of a node have objectives so close that
float32 rounding orders them differently (XLA:CPU's ``log2`` is not
correctly rounded, the port's is). The rule is the port's
``train/compare.py``: at each tree's first differing node the two splits'
float64 objectives must be within 8 float32 ulp of the node's mass term.

Run as a script, it trains the fixture recipe at full size (12 VGA frames,
~1.4e5 samples x 366 features, 4 trees of depth <= 30) with both trainers on
the CPU and prints the differing nodes per tree:

    JAX_PLATFORMS=cpu python tests/forest_parity.py [--mode exact|binned|host]
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script
    sys.path.insert(0, ROOT)

from rovinasemanticsegmentation_tpu_torch.train.compare import (
    differing_nodes,
    first_difference,
    near_tie,
    near_ties,
)


def assert_same_or_near_tie(fj, ft, x, y, cfg):
    """Every tree equal, or equal up to a near-tie at its first differing
    node (``train/compare.py``); -> the near-ties found, for the test to
    report."""
    return near_ties(fj, ft, np.asarray(x), np.asarray(y), cfg)


# A leaf log-histogram near 0 is the log of a ratio near 1, whose float32
# rounding is absolute: 2 float32 ulp of 1.
LOG_ATOL = 2 * float(np.spacing(np.float32(1)))


def assert_leaf_hist_close(fj, ft, rtol=1e-5):
    """Leaf histograms of the trees that are equal, within ``rtol`` (and
    :data:`LOG_ATOL` near 0): JAX adds each example's float32 class weight,
    the port multiplies the integer count by it once."""
    for t in range(fj.num_trees):
        if first_difference(fj, ft, t) is None:
            np.testing.assert_allclose(ft.leaf_hist[t], fj.leaf_hist[t],
                                       rtol=rtol, atol=LOG_ATOL)


def main(argv=None) -> None:
    import argparse
    import time

    from rovinasemanticsegmentation_tpu.train import forest_trainer as J
    from rovinasemanticsegmentation_tpu_torch.scripts import make_bench_forest as mb
    from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("exact", "binned", "host"),
                    default="exact")
    args = ap.parse_args(argv)
    gen = mb.frames()
    x_dev, y = mb.extract([next(gen) for _ in range(mb.FRAMES)], "cpu")
    x = x_dev.numpy()
    kw = dict(device_growth=args.mode != "host",
              split_bins=256 if args.mode == "binned" else 0)
    print(f"{len(x)} samples x {x.shape[1]} features, mode {args.mode}")
    t0 = time.perf_counter()
    fj = J.ForestTrainer(J.TrainerConfig(**vars(mb.trainer_config(**kw)))).learn(
        x, y, class_counts=list(mb.CLASS_COUNTS), progress=False)
    t1 = time.perf_counter()
    cfg = mb.trainer_config(**kw)
    ft = T.ForestTrainer(cfg, "cpu").learn(
        x, y, class_counts=list(mb.CLASS_COUNTS), progress=False)
    t2 = time.perf_counter()
    print(f"JAX {t1 - t0:.1f}s, port {t2 - t1:.1f}s on the CPU")
    print(f"nodes per tree: JAX {fj.node_counts}, port {ft.node_counts}; "
          f"depth JAX {fj.max_depth}, port {ft.max_depth}")
    for t in range(fj.num_trees):
        v = first_difference(fj, ft, t)
        if v is None:
            print(f"tree {t}: equal")
            continue
        ok, what = near_tie(fj, ft, t, v, x, y, cfg)
        print(f"tree {t}: first differing node {v}, "
              f"{int(differing_nodes(fj, ft, t).sum())} nodes differ; "
              f"near-tie: {ok}; {what}")


if __name__ == "__main__":
    main()
