"""Point-sharded dense-CRF mean field.

Counterpart of ``rovinasemanticsegmentation_tpu/parallel/sharded_crf.py``.
The marginals Q, the per-point simplex data and the unaries shard along the
N points over one mesh axis; the lattice vertex table is the shared state:
each rank splats its points into a local ``[C, M+1]`` table, an
``all_reduce`` over the axis sums the partial tables (JAX's ``psum``), the
d+1 blur passes run replicated, and slicing back to points is local. One
``all_reduce`` of ``[C, M+1]`` per filter is the only traffic; the
vertex-sharded variant (``parallel/sharded_lattice.py``) trades it for halo
exchanges.

Rank ``s`` along the axis takes points ``[s * n_loc, (s + 1) * n_loc)``
with ``n_loc = ceil(N / D)``; ranks that differ only on the other axis
compute the same shard, as ``shard_map`` replicates them. Each rank's splat
is a sorted segment sum over its own shard's stream (host-sorted, float64
prefix, no float atomics), as on one device. The result is the whole
``[N, C]`` array on every rank (an ``all_gather`` over the axis), on the
mesh's device.

- :func:`sharded_potts_mean_field_t` -- the scale-out path of the map
  pipeline: the ``[C, N]`` layout, all label layers in one mean field, the
  normalisation from a filtered ones-vector;
- :func:`sharded_potts_mean_field` -- points-major Q and a given
  normalisation, the readable oracle.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..models.crf import exp_and_normalize, normalize_blocks
from ..models.lattice import (
    PermutohedralLattice,
    _blur_t,
    _slice_t,
    _splat_t,
    attach_sorted_stream,
    lattice_tensors,
)
from .mesh import DeviceMesh, axis_all_gather, axis_all_reduce


class _ShardLattice:
    """One shard's lattice on the rank's device: the sorted splat stream of
    its points, their corners and weights (padding points point at the zero
    slot with weight 0), and the whole blur tables."""

    def __init__(self, lattice: PermutohedralLattice, lo: int, n_loc: int,
                 device: torch.device):
        m = lattice.num_vertices
        hi = min(lo + n_loc, lattice.offsets.shape[0])
        cnt = max(hi - lo, 0)
        d1 = lattice.offsets.shape[1]
        offsets = np.full((n_loc, d1), m, np.int32)
        bary = np.zeros((n_loc, d1), np.float32)
        offsets[:cnt] = lattice.offsets[lo : lo + cnt]
        bary[:cnt] = lattice.barycentric[lo : lo + cnt]
        shard = attach_sorted_stream(PermutohedralLattice(
            offsets, bary, lattice.blur_n1, lattice.blur_n2, m, lattice.dim))
        (self.sorted_points, self.sorted_weights, self.seg_starts,
         self.seg_ends, self.offsets_t, self.barycentric_t, self.blur_n1,
         self.blur_n2) = lattice_tensors(shard, device)
        self.m = m

    def filter(self, mesh: DeviceMesh, axis: str,
               values_t: torch.Tensor) -> torch.Tensor:
        """Splat -> all_reduce -> blur -> slice of ``[C, n_loc]`` values."""
        verts = _splat_t(values_t, self.sorted_points, self.sorted_weights,
                         self.seg_starts, self.seg_ends)  # [C, M+1] partial
        axis_all_reduce(mesh, verts, axis)
        verts = _blur_t(verts, self.blur_n1, self.blur_n2, self.m, False)
        return _slice_t(verts, self.offsets_t, self.barycentric_t)


def _shard_rows(n: int, mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """(first point, points per shard) of this rank's shard along ``axis``."""
    n_loc = -(-n // mesh.shape[axis])
    return mesh.coords[axis] * n_loc, n_loc


def _local(a, lo: int, n_loc: int, device: torch.device) -> torch.Tensor:
    """Rows ``[lo, lo + n_loc)`` of ``a`` as float32 on ``device``, zero
    rows past its end."""
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    out = a.new_zeros((n_loc,) + tuple(a.shape[1:]))
    rows = a[lo : lo + n_loc]
    out[: rows.shape[0]] = rows
    return out


def _gather_points(mesh: DeviceMesh, axis: str, q: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``[n_loc, C]`` shards -> the whole ``[N, C]`` on every rank."""
    whole = axis_all_gather(mesh, q, axis)  # [D, n_loc, C]
    return whole.reshape(-1, q.shape[1])[:n]


def sharded_potts_mean_field(
    mesh: DeviceMesh,
    axis: str,
    unary,  # [N, C] energies (already -accumulated unaries)
    lattice: PermutohedralLattice,
    norm,  # [N] symmetric normalisation
    weight: float,
    n_iterations: int,
) -> torch.Tensor:  # [N, C]
    """Mean-field marginals with Q sharded along points over ``axis``,
    points-major (``Q = softmax(-U + w * norm * K(norm * Q))``)."""
    n = lattice.offsets.shape[0]
    lo, n_loc = _shard_rows(n, mesh, axis)
    dev = mesh.device
    lat = _ShardLattice(lattice, lo, n_loc, dev)
    u = _local(unary, lo, n_loc, dev)
    nrm = _local(norm, lo, n_loc, dev)[:, None]

    def one_filter(q):
        return lat.filter(mesh, axis, (q * nrm).T).T * nrm

    q = exp_and_normalize(-u)
    for _ in range(n_iterations):
        q = exp_and_normalize(-u + weight * one_filter(q))
    return _gather_points(mesh, axis, q, n)


def sharded_potts_mean_field_t(
    mesh: DeviceMesh,
    axis: str,
    unary,  # [N, Ctot] energies, all layers concatenated
    lattice: PermutohedralLattice,
    weight: float,
    blocks: Sequence[int],
    n_iterations: int,
) -> torch.Tensor:  # [N, Ctot]
    """Transposed point-sharded mean field: ``potts_mean_field_multi_t``
    with N sharded over ``axis``; the symmetric normalisation comes from a
    filtered ones-vector (pairwise.cpp:54-56)."""
    n = lattice.offsets.shape[0]
    lo, n_loc = _shard_rows(n, mesh, axis)
    dev = mesh.device
    lat = _ShardLattice(lattice, lo, n_loc, dev)
    u_t = _local(unary, lo, n_loc, dev).T
    raw = lat.filter(mesh, axis, u_t.new_ones((1, n_loc)))[0]
    norm = 1.0 / torch.sqrt(raw + 1e-20)
    q = normalize_blocks(-u_t, blocks)
    for _ in range(n_iterations):
        f = lat.filter(mesh, axis, q * norm) * norm
        q = normalize_blocks(-u_t + weight * f, blocks)
    return _gather_points(mesh, axis, q.T.contiguous(), n)
