"""Mean-field inference of the map path's dense CRF.

Counterpart of ``potts_mean_field_multi_t`` in
``rovinasemanticsegmentation_tpu/models/crf.py``: several independent Potts
CRFs (one per label layer, ``segmenter.cpp:638-644``) share one lattice and
run through one filter per iteration, each layer's softmax taken over its
own block of channels. The update is the reference's
``Q = expAndNormalize(-U + w * norm * K(norm * Q))`` (``densecrf.cpp:115-131``)
with the max-subtracted softmax (``:98-106``) and symmetric normalisation.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .lattice import lattice_filter_t


def normalize_blocks(x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
    """Max-subtracted softmax over each block of rows of ``x`` [C, N]."""
    parts = []
    for b in torch.split(x, list(blocks), dim=0):
        e = torch.exp(b - b.amax(dim=0, keepdim=True))
        parts.append(e / e.sum(dim=0, keepdim=True))
    return torch.cat(parts, dim=0)


def potts_mean_field_multi_t(
    unary_t: torch.Tensor,  # [sum(blocks), N] energies, layers stacked
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    norm: torch.Tensor,  # [N] symmetric-normalisation vector
    weight: float,  # Potts weight
    blocks: Sequence[int],
    num_vertices: int,
    n_iterations: int,
) -> torch.Tensor:  # [sum(blocks), N] marginals
    """``n_iterations`` mean-field steps of the per-layer Potts CRFs."""
    q = normalize_blocks(-unary_t, blocks)
    for _ in range(n_iterations):
        filtered = lattice_filter_t(
            q * norm, sorted_points, sorted_weights, seg_starts, seg_ends,
            offsets_t, barycentric_t, blur_n1, blur_n2, num_vertices,
        ) * norm
        q = normalize_blocks(-unary_t + weight * filtered, blocks)
    return q
