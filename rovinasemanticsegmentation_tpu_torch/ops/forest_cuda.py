"""Forest descent + leaf-histogram sum: CUDA kernel wrapper (kernel B).

Replaces ``rovinasemanticsegmentation_tpu/ops/forest_pallas.py``
(``_descent_kernel`` via ``find_leaves_pallas`` and
``PallasForestPredictor``). :func:`forest_predict_rows` takes feature rows
in a :class:`RowLayout` (the frame path's packed 8-bit rows, or float32
rows); :func:`forest_predict` takes a float32 ``[P, D]`` matrix. On a CUDA
tensor both launch ``csrc/forest_descent.cu``; on a CPU tensor they unpack
the rows to float32 and run the plain version
(``models/forest.py::find_leaves_plain`` and ``sum_leaf_histograms_plain``).
Both return natural-numbered leaf ids and the posterior summed in tree order,
so they agree exactly.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..csrc.build import (
    MAX_SHARED_BYTES,
    check_launch,
    load_kernels,
)
from ..models.forest import (
    TorchForest,
    find_leaves_plain,
    sum_leaf_histograms_plain,
)
from ..utils.profiling import counter
from .feature_rows import RowLayout, check_rows, unpack_rows

launches = counter("forest_cuda.launches")

TILE_POINTS = 64  # points per tile: 24.6 KB of 384-byte rows per stage
_MAX_THREADS = 1024  # one thread per (point, tree) in a block


def forest_predict_plain(
    features: torch.Tensor, forest: TorchForest
) -> Tuple[torch.Tensor, torch.Tensor]:
    leaves = find_leaves_plain(
        features, forest.records, forest.max_depth, forest.feat_bits
    )
    return leaves, sum_leaf_histograms_plain(forest.leaf_hist, leaves)


def check_features(features: torch.Tensor, forest: TorchForest) -> None:
    """[P, D] float32 on the forest's device, wide enough for its splits."""
    if features.dim() != 2 or features.dtype != torch.float32:
        raise ValueError(
            f"features must be [P, D] float32, got {tuple(features.shape)} "
            f"{features.dtype}"
        )
    if features.device != forest.device:
        raise ValueError(
            f"features on {features.device}, forest on {forest.device}"
        )
    if features.shape[1] < forest.num_features:
        raise ValueError(
            f"forest splits on feature {forest.num_features - 1}, but features "
            f"have only {features.shape[1]} columns"
        )


def tile_points_for(num_trees: int, row_bytes: int) -> int:
    """Points per tile: up to 64, one thread per (point, tree), and two
    stages of rows that fit the block's shared memory."""
    tp = min(TILE_POINTS, _MAX_THREADS // num_trees)
    while tp > 0 and 2 * tp * row_bytes + 4 * tp * num_trees + 272 \
            > MAX_SHARED_BYTES:
        tp //= 2
    if tp == 0:
        raise ValueError(
            f"a row of {row_bytes} B with {num_trees} trees does not fit the "
            "kernel's shared memory"
        )
    return tp


def forest_predict_rows(
    rows: torch.Tensor,  # [P, row_bytes] uint8
    layout: RowLayout,
    forest: TorchForest,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descent over feature rows in ``layout`` (``ops/feature_rows.py``).

    -> (leaf ids [P, T] int32, log-posterior [P, L, C_max] float32).
    """
    check_rows(rows, layout)
    if rows.device != forest.device:
        raise ValueError(f"rows on {rows.device}, forest on {forest.device}")
    if layout.num_features < forest.num_features:
        raise ValueError(
            f"forest splits on feature {forest.num_features - 1}, but rows "
            f"have only {layout.num_features} features"
        )
    if rows.device.type == "cpu":
        return forest_predict_plain(unpack_rows(rows, layout), forest)
    launch, leaves, post = launcher(rows, layout, forest)
    launch()
    return leaves, post


def launcher(
    rows: torch.Tensor, layout: RowLayout, forest: TorchForest
) -> Tuple[Callable[[], None], torch.Tensor, torch.Tensor]:
    """Kernel B on CUDA rows, split in two: allocate the outputs now and
    return (the function that launches the kernel and counts the launch,
    leaves, posterior), so that the launch alone can be timed."""
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if rows.data_ptr() % 4 != 0:
        raise ValueError("rows must start 4-byte aligned")
    num_trees, n_nodes, _ = forest.records.shape
    if num_trees > _MAX_THREADS:
        raise ValueError(f"at most {_MAX_THREADS} trees, got {num_trees}")
    tp = tile_points_for(num_trees, layout.row_bytes)
    _, _, num_layers, c_max = forest.leaf_hist.shape
    records = forest.records.contiguous()
    hist = forest.leaf_hist.contiguous()
    p = rows.shape[0]
    leaves = torch.empty((p, num_trees), dtype=torch.int32, device=rows.device)
    post = torch.empty(
        (p, num_layers, c_max), dtype=torch.float32, device=rows.device
    )
    lib = load_kernels()

    def launch() -> None:
        if p == 0:
            return
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_forest_descent(
                rows.data_ptr(), p, layout.row_bytes, layout.patch_bytes,
                layout.tail_off, records.data_ptr(), num_trees, n_nodes,
                hist.data_ptr(), num_layers * c_max, forest.max_depth,
                forest.feat_bits, tp, leaves.data_ptr(), post.data_ptr(),
                stream,
            )
        check_launch("rovina_forest_descent", err)
        launches.add()

    return launch, leaves, post


def forest_predict(
    features: torch.Tensor,  # [P, D] float32
    forest: TorchForest,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The descent over a float32 ``[P, D]`` matrix (rows of ``4 D`` bytes)."""
    check_features(features, forest)
    features = features.contiguous()
    return forest_predict_rows(
        features.view(torch.uint8), RowLayout.float32(features.shape[1]),
        forest,
    )
