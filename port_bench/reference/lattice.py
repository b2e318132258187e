"""The dense CRF of the map path, plainly: a permutohedral lattice over
``[xyz * dcrf_xyz_kernel ; rgb * dcrf_rgb_kernel]``, Potts mean field per
layer, labels with the ``2/C`` floor (``segmenter.cpp:628-658``).

The lattice follows densecrf's ``Permutohedral::init`` (elevation with
``scale_i = sqrt(2/3) (d+1) / sqrt((i+1)(i+2))``, nearest remainder-0 point,
rank, barycentric weights with the wrap-around term, one vertex per distinct
simplex corner, blur neighbours ``key -/+ 1`` except ``+/- d`` on the axis),
built here on the host with NumPy; vertex ids are the keys' lexicographic
order. The filter is splat (a scatter-add), ``d+1`` blur passes ``v + (n1 +
n2) / 2`` (a missing neighbour reads 0), and slice times ``1 / (1 +
2^-d)``. The mean field is densecrf's with the symmetric normalisation
``1 / sqrt(filter(1))``: ``Q <- softmax(U + w n K(n Q))`` per layer, from
``Q = softmax(U)``, where ``U`` are the fused unaries (the energy is
``-U``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


@dataclass
class Lattice:
    offsets: torch.Tensor  # [N, d+1] vertex of each simplex corner
    bary: torch.Tensor  # [N, d+1] float32 barycentric weights
    blur1: torch.Tensor  # [d+1, M] neighbour "key - 1" per axis, M = none
    blur2: torch.Tensor  # [d+1, M] neighbour "key + 1" per axis
    vertices: int  # M


def build(features: np.ndarray, device) -> Lattice:
    """The lattice of ``features`` [N, d] float32."""
    f = np.asarray(features, np.float32)
    n, d = f.shape
    scale = (np.sqrt(2.0 / 3.0) * (d + 1)
             / np.sqrt((np.arange(d) + 2.0) * (np.arange(d) + 1.0)))
    c = f * scale[None, :]
    suffix = np.concatenate([np.cumsum(c[:, ::-1], axis=1)[:, ::-1],
                             np.zeros((n, 1))], axis=1)
    elevated = np.empty((n, d + 1), np.float32)
    elevated[:, 0] = suffix[:, 0]
    elevated[:, 1:] = suffix[:, 1:] - np.arange(1, d + 1)[None, :] * c

    down = 1.0 / (d + 1)
    v = down * elevated
    up_pt, down_pt = np.ceil(v) * (d + 1), np.floor(v) * (d + 1)
    rem0 = np.where(up_pt - elevated < elevated - down_pt, up_pt, down_pt
                    ).astype(np.float32)
    rem_sum = (rem0.sum(axis=1) * down).astype(np.int32)

    order = np.argsort(-(elevated - rem0), axis=1, kind="stable")
    rank = np.empty((n, d + 1), np.int32)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(d + 1), (n, d + 1)),
                      axis=1)
    rank = rank + rem_sum[:, None]
    low = rank < 0
    rank = np.where(low, rank + (d + 1), rank)
    rem0 = np.where(low, rem0 + (d + 1), rem0)
    high = rank > d
    rank = np.where(high, rank - (d + 1), rank)
    rem0 = np.where(high, rem0 - (d + 1), rem0)

    bary = np.zeros((n, d + 2), np.float32)
    vbar = (elevated - rem0) * down
    rows = np.repeat(np.arange(n), d + 1)
    cols = (d - rank).reshape(-1)
    np.add.at(bary, (rows, cols), vbar.reshape(-1))
    np.add.at(bary, (rows, cols + 1), -vbar.reshape(-1))
    bary[:, 0] += 1.0 + bary[:, d + 1]

    canonical = np.empty((d + 1, d + 1), np.int32)
    for r in range(d + 1):
        canonical[r, : d + 1 - r] = r
        canonical[r, d + 1 - r:] = r - (d + 1)
    keys = (rem0[:, None, :d].astype(np.int32)
            + canonical[np.arange(d + 1)[None, :, None], rank[:, None, :d]])
    unique, inverse = np.unique(keys.reshape(n * (d + 1), d), axis=0,
                                return_inverse=True)
    m = len(unique)
    table = {tuple(k): i for i, k in enumerate(unique.tolist())}

    def lookup(q):
        return np.array([table.get(tuple(k), m) for k in q.tolist()], np.int64)

    blur1 = np.empty((d + 1, m), np.int64)
    blur2 = np.empty((d + 1, m), np.int64)
    for j in range(d + 1):
        n1, n2 = unique - 1, unique + 1
        if j < d:
            n1[:, j] = unique[:, j] + d
            n2[:, j] = unique[:, j] - d
        blur1[j], blur2[j] = lookup(n1), lookup(n2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Lattice(t(inverse.reshape(n, d + 1).astype(np.int64)),
                   t(bary[:, : d + 1]), t(blur1), t(blur2), m)


def lattice_filter(values: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """[C, N] values -> [C, N] filtered, in the values' dtype."""
    c, n = values.shape
    d1 = lat.offsets.shape[1]
    w = lat.bary.to(values.dtype)
    verts = values.new_zeros((c, lat.vertices + 1))  # the last slot stays 0
    for k in range(d1):
        verts.index_add_(1, lat.offsets[:, k], values * w[:, k])
    for j in range(d1):
        blurred = verts[:, :-1] + 0.5 * (verts[:, lat.blur1[j]] + verts[:, lat.blur2[j]])
        verts = torch.cat([blurred, verts[:, -1:]], dim=1)
    out = sum(verts[:, lat.offsets[:, k]] * w[:, k] for k in range(d1))
    return out * (1.0 / (1.0 + 2.0 ** (-(d1 - 1))))


def _softmax_blocks(x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
    parts = []
    for b in torch.split(x, list(blocks), dim=0):
        e = torch.exp(b - b.amax(dim=0, keepdim=True))
        parts.append(e / e.sum(dim=0, keepdim=True))
    return torch.cat(parts, dim=0)


def crf_labels(unary: torch.Tensor, points: torch.Tensor, rgb: torch.Tensor,
               crf: dict, class_counts: Sequence[int],
               unknown_labels: Sequence[int]) -> List[torch.Tensor]:
    """Per-layer int32 labels of the map: the mean field over the lattice of
    ``[points * xyz_kernel ; rgb * rgb_kernel]`` on ``unary`` [N, sum(C)],
    computed in ``unary``'s dtype, then argmax where the marginal passes
    ``2/C``, else the layer's Unknown."""
    feats = torch.cat([points * crf["dcrf_xyz_kernel"],
                       rgb * crf["dcrf_rgb_kernel"]], dim=1)
    lat = build(feats.cpu().numpy(), unary.device)
    u = unary.T
    ones = u.new_ones((1, u.shape[1]))
    norm = 1.0 / torch.sqrt(lattice_filter(ones, lat)[0] + 1e-20)
    q = _softmax_blocks(u, class_counts)
    for _ in range(int(crf["dcrf_iterations"])):
        filtered = lattice_filter(q * norm, lat) * norm
        q = _softmax_blocks(u + crf["dcrf_kernel_weight"] * filtered, class_counts)
    labels = []
    for ql, c, unknown in zip(torch.split(q, list(class_counts)), class_counts,
                              unknown_labels):
        floor = torch.tensor(2.0 / c, dtype=torch.float32, device=ql.device)
        lbl = torch.where(ql.amax(dim=0).float() > floor, ql.argmax(dim=0),
                          torch.full_like(ql.argmax(dim=0), unknown))
        labels.append(lbl.to(torch.int32))
    return labels
