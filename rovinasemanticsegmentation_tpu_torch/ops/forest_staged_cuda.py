"""Forest descent over a shared-memory feature tile: CUDA kernel wrapper (C').

Replaces ``scripts/exp_descent.py`` (``_descent_kernel_v`` with
``chunk_skip`` via ``find_leaves_v``). The features are usage-permuted
(``models/forest.py::usage_permutation``) and the forest rewritten to match
(``permute_forest_features``), so the first ``hot`` columns are the ones
split on most. On a CUDA tensor :func:`find_leaves_staged` launches
``csrc/forest_descent_staged.cu``, which stages those columns of a tile of
``tile_points`` points in shared memory; on a CPU tensor it runs the plain
version, ``models/forest.py::find_leaves_plain``. Both return leaf ids in
the natural numbering and agree exactly.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..csrc.build import (
    MAX_SHARED_BYTES,
    LaunchCounter,
    check_launch,
    load_kernels,
)
from ..models.forest import TorchForest, find_leaves_plain
from .forest_cuda import check_features

launches = LaunchCounter()

TILE_POINTS = 32  # points per block
_MAX_THREADS = 1024


def _check(
    features: torch.Tensor, forest: TorchForest, hot: int, tile_points: int
) -> None:
    """Inputs both versions take; the tile must fit one block."""
    check_features(features, forest)
    d = features.shape[1]
    if not 0 <= hot <= d:
        raise ValueError(f"hot must lie in [0, {d}], got {hot}")
    if tile_points < 1 or tile_points * forest.num_trees > _MAX_THREADS:
        raise ValueError(
            f"tile_points {tile_points} x {forest.num_trees} trees must be "
            f"1..{_MAX_THREADS} threads"
        )
    smem = 4 * hot * tile_points  # the block's staged float32 tile
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"hot {hot} x tile_points {tile_points} stages {smem} B, more "
            f"than the {MAX_SHARED_BYTES} B of shared memory a block can use"
        )


def find_leaves_staged(
    features: torch.Tensor,  # [P, D] float32, usage-permuted columns
    forest: TorchForest,  # split features remapped to match
    hot: int,
    tile_points: int = TILE_POINTS,
) -> torch.Tensor:  # [P, T] int32 leaf ids, natural numbering
    _check(features, forest, hot, tile_points)
    if features.device.type == "cpu":
        return find_leaves_plain(
            features, forest.records, forest.max_depth, forest.feat_bits
        )
    launch, leaves = launcher(features, forest, hot, tile_points)
    launch()
    return leaves


def launcher(
    features: torch.Tensor, forest: TorchForest, hot: int,
    tile_points: int = TILE_POINTS,
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Kernel C' on CUDA features, split in two: allocate the leaf ids now
    and return (the function that launches the kernel and counts the
    launch, leaf ids), so that the launch alone can be timed."""
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    num_trees, n_nodes, _ = forest.records.shape
    features = features.contiguous()
    records = forest.records.contiguous()
    p, d = features.shape
    leaves = torch.empty((p, num_trees), dtype=torch.int32, device=features.device)
    lib = load_kernels()

    def launch() -> None:
        if p == 0:
            return
        with torch.cuda.device(features.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_forest_descent_staged(
                features.data_ptr(), p, d, hot, records.data_ptr(), num_trees,
                n_nodes, forest.max_depth, forest.feat_bits, tile_points,
                leaves.data_ptr(), stream,
            )
        check_launch("rovina_forest_descent_staged", err)
        launches.add()

    return launch, leaves
