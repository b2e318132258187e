"""Forest descent + leaf-histogram sum: CUDA kernel wrapper (kernel B).

Replaces ``rovinasemanticsegmentation_tpu/ops/forest_pallas.py``
(``_descent_kernel`` via ``find_leaves_pallas`` and
``PallasForestPredictor``). On a CUDA tensor :func:`forest_predict` launches
``csrc/forest_descent.cu``; on a CPU tensor it runs the plain version
(``models/forest.py::find_leaves_plain`` and ``sum_leaf_histograms_plain``).
Both return natural-numbered leaf ids and the posterior summed in tree order,
so they agree exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..csrc.build import LaunchCounter, check_launch, load_kernels
from ..models.forest import (
    TorchForest,
    find_leaves_plain,
    sum_leaf_histograms_plain,
)

launches = LaunchCounter()

_MAX_TREES = 1024  # one CUDA block holds at least one point's trees


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


def forest_predict(
    features: torch.Tensor,  # [P, D] float32
    forest: TorchForest,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (leaf ids [P, T] int32, log-posterior [P, L, C_max] float32)."""
    check_features(features, forest)
    if features.device.type == "cpu":
        return forest_predict_plain(features, forest)
    if features.device.type != "cuda":
        raise ValueError(f"unsupported device {features.device}")
    num_trees, n_nodes, _ = forest.records.shape
    if num_trees > _MAX_TREES:
        raise ValueError(f"at most {_MAX_TREES} trees, got {num_trees}")
    _, _, num_layers, c_max = forest.leaf_hist.shape
    features = features.contiguous()
    records = forest.records.contiguous()
    hist = forest.leaf_hist.contiguous()
    p, d = features.shape
    leaves = torch.empty((p, num_trees), dtype=torch.int32, device=features.device)
    post = torch.empty(
        (p, num_layers, c_max), dtype=torch.float32, device=features.device
    )
    if p == 0:
        return leaves, post
    lib = load_kernels()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rovina_forest_descent(
            features.data_ptr(), p, d, records.data_ptr(), num_trees, n_nodes,
            hist.data_ptr(), num_layers * c_max, forest.max_depth,
            forest.feat_bits, leaves.data_ptr(), post.data_ptr(), stream,
        )
    check_launch("rovina_forest_descent", err)
    launches.add()
    return leaves, post
