"""Forest descent over the hot prefix of each feature row: CUDA kernel
wrapper (C'').

Replaces ``scripts/exp_descent.py`` (``_descent_kernel_v`` with
``chunk_skip`` via ``find_leaves_v``). The rows are usage-permuted and the
forest rewritten to match (``models/forest.py``: ``usage_permutation_rows``
with ``feature_rows.permute_rows`` on packed rows, ``usage_permutation`` on
float32 features; ``permute_forest_features``), so the first ``hot``
features are the ones split on most. On CUDA rows
:func:`find_leaves_staged_rows` launches ``csrc/forest_descent_staged.cu``,
which stages in shared memory, per row, the bytes of features ``[0, hot)``
and (on packed rows) the 16-byte units that hold the float tail, and reads
the other features in place; on CPU rows it unpacks them and runs the plain
version, ``models/forest.py::find_leaves_plain``. Both return leaf ids in
the natural numbering and agree exactly. :func:`find_leaves_staged` takes a
float32 ``[P, D]`` matrix (rows of ``4 D`` bytes) through the same kernel.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..csrc.build import (
    MAX_SHARED_BYTES,
    check_launch,
    load_kernels,
)
from ..models.forest import TorchForest, find_leaves_plain
from ..utils.profiling import counter
from .feature_rows import RowLayout, check_rows, unpack_rows
from .forest_cuda import check_features

launches = counter("forest_staged_cuda.launches")

TILE_POINTS = 64  # points per tile
_MAX_THREADS = 1024


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def feature_offset(layout: RowLayout, f: int) -> int:
    """Byte offset of feature ``f`` in a row."""
    pc = layout.patch_bytes
    return f if f < pc else layout.tail_off + 4 * (f - pc)


def staged_spans(layout: RowLayout, hot: int) -> Tuple[int, int]:
    """The bytes a tile stages per row at ``hot``: ``(hot_bytes, tail_lo)``,
    the prefix ``[0, hot_bytes)`` (the bytes of features ``[0, hot)`` in
    whole 16-byte units) and, on rows with a byte part and a float tail, the
    16-byte units ``[tail_lo, row_bytes)`` that hold the tail. A prefix that
    reaches the tail stages the whole row: ``(row_bytes, row_bytes)``."""
    d, rb = layout.num_features, layout.row_bytes
    if not 0 <= hot <= d:
        raise ValueError(f"hot must lie in [0, {d}], got {hot}")
    end = feature_offset(layout, hot) if hot < d else rb
    hot_bytes = min(_round_up(end, 16), rb)
    has_tail = 0 < layout.patch_bytes < d
    tail_lo = layout.tail_off // 16 * 16 if has_tail else rb
    if hot_bytes >= tail_lo:
        return rb, rb
    return hot_bytes, tail_lo


def staged_features(layout: RowLayout, hot: int) -> np.ndarray:
    """[D] bool: the features a tile stages at ``hot``."""
    hot_bytes, tail_lo = staged_spans(layout, hot)
    off = np.array([feature_offset(layout, f)
                    for f in range(layout.num_features)])
    return (off < hot_bytes) | (off >= tail_lo)


def stage_row_bytes(layout: RowLayout, hot: int) -> int:
    hot_bytes, tail_lo = staged_spans(layout, hot)
    if hot_bytes == layout.row_bytes:
        return layout.row_bytes
    return hot_bytes + layout.row_bytes - tail_lo


def _check(layout: RowLayout, forest: TorchForest, hot: int,
           tile_points: int) -> None:
    """Inputs both versions take; the tile must fit one block."""
    if layout.num_features < forest.num_features:
        raise ValueError(
            f"forest splits on feature {forest.num_features - 1}, but rows "
            f"have only {layout.num_features} features"
        )
    srow = stage_row_bytes(layout, hot)  # checks hot
    if tile_points < 1 or tile_points * forest.num_trees > _MAX_THREADS:
        raise ValueError(
            f"tile_points {tile_points} x {forest.num_trees} trees must be "
            f"1..{_MAX_THREADS} threads"
        )
    smem = 2 * _round_up(tile_points * srow, 128) + 16  # two stages
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"hot {hot} x tile_points {tile_points} stages {smem} B, more "
            f"than the {MAX_SHARED_BYTES} B of shared memory a block can use"
        )


def find_leaves_staged_rows(
    rows: torch.Tensor,  # [P, row_bytes] uint8, usage-permuted
    layout: RowLayout,
    forest: TorchForest,  # split features remapped to match
    hot: int,
    tile_points: int = TILE_POINTS,
) -> torch.Tensor:  # [P, T] int32 leaf ids, natural numbering
    check_rows(rows, layout)
    if rows.device != forest.device:
        raise ValueError(f"rows on {rows.device}, forest on {forest.device}")
    _check(layout, forest, hot, tile_points)
    if rows.device.type == "cpu":
        return find_leaves_plain(unpack_rows(rows, layout), forest.records,
                                 forest.max_depth, forest.feat_bits)
    launch, leaves = launcher(rows, layout, forest, hot, tile_points)
    launch()
    return leaves


def find_leaves_staged(
    features: torch.Tensor,  # [P, D] float32, usage-permuted columns
    forest: TorchForest,  # split features remapped to match
    hot: int,
    tile_points: int = TILE_POINTS,
) -> torch.Tensor:  # [P, T] int32 leaf ids, natural numbering
    """C'' on a float32 matrix: rows of ``4 D`` bytes, the first ``hot``
    columns staged."""
    check_features(features, forest)
    features = features.contiguous()
    return find_leaves_staged_rows(
        features.view(torch.uint8), RowLayout.float32(features.shape[1]),
        forest, hot, tile_points,
    )


def launcher(
    rows: torch.Tensor, layout: RowLayout, forest: TorchForest, hot: int,
    tile_points: int = TILE_POINTS,
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Kernel C'' on CUDA rows, split in two: allocate the leaf ids now and
    return (the function that launches the kernel and counts the launch,
    leaf ids), so that the launch alone can be timed."""
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    check_rows(rows, layout)
    _check(layout, forest, hot, tile_points)
    if rows.data_ptr() % 4 != 0:
        raise ValueError("rows must start 4-byte aligned")
    hot_bytes, tail_lo = staged_spans(layout, hot)
    num_trees, n_nodes, _ = forest.records.shape
    records = forest.records.contiguous()
    p = rows.shape[0]
    leaves = torch.empty((p, num_trees), dtype=torch.int32, device=rows.device)
    lib = load_kernels()

    def launch() -> None:
        if p == 0:
            return
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_forest_descent_staged(
                rows.data_ptr(), p, layout.row_bytes, layout.patch_bytes,
                layout.tail_off, hot_bytes, tail_lo, records.data_ptr(),
                num_trees, n_nodes, forest.max_depth, forest.feat_bits,
                tile_points, leaves.data_ptr(), stream,
            )
        check_launch("rovina_forest_descent_staged", err)
        launches.add()

    return launch, leaves
