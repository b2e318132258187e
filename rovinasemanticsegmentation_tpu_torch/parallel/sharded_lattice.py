"""Vertex-sharded permutohedral CRF: points and vertices both sharded.

Counterpart of ``rovinasemanticsegmentation_tpu/parallel/sharded_lattice.py``.
``parallel/sharded_crf.py`` shards the points but replicates the vertex
table (one ``all_reduce`` of ``[C, M+1]`` per filter). Here, as ring
attention shards its key/value blocks:

- points are ordered by their corner-0 lattice vertex (spatially clustered)
  and sharded in contiguous blocks;
- each vertex is owned by the shard that contributes most of its splat mass,
  renumbered owner-contiguous: a rank's vertex state is ``[C, m_loc]``,
  with ``m_loc`` about M/D, plus a halo;
- the splat reduces locally first (sorted segment sums), then exchanges only
  per-destination partials of boundary vertices (one ``all_gather`` per
  filter);
- each of the d+1 blur passes (``permutohedral.cpp:476-527``) and the slice
  exchange only the halo vertices that other shards reference (one
  ``all_gather`` of each rank's publish list per pass).

Comms per filter: 1 boundary all_gather + (d+2) halo all_gathers, against
the replicated design's ``(M+1) * C`` all_reduce; the plan reports both,
and :func:`auto_sharded_potts_mean_field` runs the cheaper one.

:func:`plan_sharded_lattice` is host NumPy, a copy of the JAX package's (the
same plans, array for array). Every plan array carries a leading shard axis;
rank ``s`` along the mesh axis takes slice ``s``, and the ranks that differ
only on the other axis compute the same shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..models.crf import normalize_blocks
from ..models.lattice import PermutohedralLattice, segment_sum_sorted_t
from .mesh import DeviceMesh, axis_all_gather

LANES = 128


def _bucket(n: int, minimum: int = LANES) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class ShardedLatticePlan:
    """Host-computed routing for one (lattice, n_shards) pair.

    Every array carries a leading shard axis D so ``shard_map`` hands each
    device exactly its slice. Indices marked "pool" address the per-device
    vertex pool ``[0, m_loc) local | [m_loc, m_loc+h) halo | m_loc+h zero``.
    """

    n_shards: int
    d1: int
    n: int  # real point count
    n_loc: int  # padded points per shard
    m: int  # real vertex count (pre-bucketing)
    m_loc: int  # padded local vertices per shard
    point_order: np.ndarray  # [N] original index of sorted-position i
    # Local splat stream (sorted by dest local vertex).
    src_l: np.ndarray  # [D, S_l] local point index
    w_l: np.ndarray  # [D, S_l]
    seg_l: np.ndarray  # [D, 2, m_loc] start/end rows into the stream
    # Boundary splat stream (sorted by dest global id), reduced to one
    # partial per distinct remote destination before the exchange.
    src_b: np.ndarray  # [D, S_b]
    w_b: np.ndarray  # [D, S_b]
    seg_b: np.ndarray  # [D, 2, B] start/end per distinct remote dest
    # Receiver side: indices into the flattened [D*B] exchanged partials
    # (D*B = zero pad), sorted by local dest, with per-vertex ranges.
    recv_idx: np.ndarray  # [D, R]
    seg_r: np.ndarray  # [D, 2, m_loc]
    # Halo machinery: each shard publishes pub_idx of its locals; each
    # shard reads its halo from the flattened [D*U] publish pool.
    pub_idx: np.ndarray  # [D, U] local vertex ids to publish
    halo_idx: np.ndarray  # [D, H] indices into the publish pool
    # Blur + slice tables in pool coordinates.
    blur_n1: np.ndarray  # [D, d1, m_loc]
    blur_n2: np.ndarray  # [D, d1, m_loc]
    offsets: np.ndarray  # [D, d1, n_loc]
    barycentric: np.ndarray  # [D, d1, n_loc]

    @property
    def comms_per_filter(self) -> int:
        """Exchanged values per filter application (per channel)."""
        d = self.n_shards
        return d * self.seg_b.shape[2] + (self.d1 + 1) * d * self.pub_idx.shape[1]

    @property
    def replicated_comms_per_filter(self) -> int:
        """What the replicated-vertex design would move (per channel).

        Uses the REAL vertex count M (the replicated psum moves [C, M+1]
        per filter), not ``d * m_loc`` — the pow2 bucket of the max
        per-shard ownership can overstate M+1 by 2x or more and would skew
        the halo-vs-psum comparison.
        """
        return self.n_shards * (self.m + 1)


def plan_sharded_lattice(
    lattice: PermutohedralLattice, n_shards: int
) -> ShardedLatticePlan:
    n, d1 = lattice.offsets.shape
    m = lattice.num_vertices
    d = n_shards

    # ------------------------------------------------------------------
    # Points: order by corner-0 vertex for spatial locality, contiguous
    # blocks per shard.
    order = np.argsort(lattice.offsets[:, 0], kind="stable").astype(np.int64)
    n_loc = _bucket(-(-n // d))
    shard_of_point = np.minimum(np.arange(d * n_loc) // n_loc, d - 1)

    # offsets/barycentric in sorted-point order, padded with zero-weight
    # rows pointing at the (future) zero slot.
    offs_s = np.full((d * n_loc, d1), m, np.int64)
    bary_s = np.zeros((d * n_loc, d1), np.float32)
    offs_s[:n] = lattice.offsets[order]
    bary_s[:n] = lattice.barycentric[order]

    # ------------------------------------------------------------------
    # Vertex ownership: majority splat mass (count of contributions).
    counts = np.zeros((m, d), np.int64)
    for j in range(d1):
        np.add.at(counts, (offs_s[:n, j], shard_of_point[:n]), 1)
    owner = np.argmax(counts, axis=1).astype(np.int64)

    m_per = np.bincount(owner, minlength=d)
    m_loc = _bucket(int(m_per.max()))
    local_id = np.zeros(m, np.int64)
    for s in range(d):
        mine = np.flatnonzero(owner == s)
        local_id[mine] = np.arange(len(mine))
    gid = owner * m_loc + local_id  # owner-contiguous renumbering

    # ------------------------------------------------------------------
    # Splat streams per shard.
    src_l_all, w_l_all, seg_l_all = [], [], []
    src_b_all, w_b_all, seg_b_all = [], [], []
    partial_dest = []  # per shard: [B_s] global ids of its outgoing partials
    for s in range(d):
        rows = np.arange(s * n_loc, min((s + 1) * n_loc, d * n_loc))
        rows = rows[rows < d * n_loc]
        pt_local = np.tile(np.arange(n_loc)[:, None], (1, d1)).reshape(-1)
        dest = offs_s[rows].reshape(-1)
        w = bary_s[rows].reshape(-1)
        realc = dest < m  # padded points carry dest == m
        pt_local, dest, w = pt_local[realc], dest[realc], w[realc]
        own = owner[dest] == s

        # Local: sort by local dest id.
        dl, pl, wl = local_id[dest[own]], pt_local[own], w[own]
        perm = np.argsort(dl, kind="stable")
        dl, pl, wl = dl[perm], pl[perm], wl[perm]
        starts = np.searchsorted(dl, np.arange(m_loc), side="left")
        ends = np.searchsorted(dl, np.arange(m_loc), side="right")
        src_l_all.append(pl)
        w_l_all.append(wl)
        seg_l_all.append(np.stack([starts, ends]))

        # Boundary: sort by global dest id, one partial per distinct dest.
        db, pb, wb = gid[dest[~own]], pt_local[~own], w[~own]
        perm = np.argsort(db, kind="stable")
        db, pb, wb = db[perm], pb[perm], wb[perm]
        uniq, first = np.unique(db, return_index=True)
        bstarts = first.astype(np.int64)
        bends = (
            np.append(first[1:], len(db)).astype(np.int64)
            if len(first)
            else np.zeros(0, np.int64)
        )
        src_b_all.append(pb)
        w_b_all.append(wb)
        seg_b_all.append(np.stack([bstarts, bends]))
        partial_dest.append(uniq)

    s_l = _bucket(max(len(a) for a in src_l_all))
    s_b = _bucket(max((len(a) for a in src_b_all), default=1) or 1)
    b_max = _bucket(max((len(u) for u in partial_dest), default=1) or 1, 8)

    src_l = np.zeros((d, s_l), np.int32)
    w_l = np.zeros((d, s_l), np.float32)
    seg_l = np.zeros((d, 2, m_loc), np.int32)
    src_b = np.zeros((d, s_b), np.int32)
    w_b = np.zeros((d, s_b), np.float32)
    seg_b = np.zeros((d, 2, b_max), np.int32)
    for s in range(d):
        src_l[s, : len(src_l_all[s])] = src_l_all[s]
        w_l[s, : len(w_l_all[s])] = w_l_all[s]
        seg_l[s] = seg_l_all[s]
        src_b[s, : len(src_b_all[s])] = src_b_all[s]
        w_b[s, : len(w_b_all[s])] = w_b_all[s]
        seg_b[s, :, : seg_b_all[s].shape[1]] = seg_b_all[s]

    # Receiver routing: partial slot (s, b) lands at flat index s*B + b.
    recv_lists = [[] for _ in range(d)]  # (local dest, flat index)
    for s in range(d):
        for b, g in enumerate(partial_dest[s]):
            o = int(g // m_loc)
            recv_lists[o].append((int(g % m_loc), s * b_max + b))
    r_max = _bucket(max((len(r) for r in recv_lists), default=1) or 1, 8)
    recv_idx = np.full((d, r_max), d * b_max, np.int32)  # pad -> zero slot
    seg_r = np.zeros((d, 2, m_loc), np.int32)
    for s in range(d):
        rl = sorted(recv_lists[s])
        dests = np.array([x[0] for x in rl], np.int64)
        recv_idx[s, : len(rl)] = [x[1] for x in rl]
        seg_r[s, 0] = np.searchsorted(dests, np.arange(m_loc), side="left")
        seg_r[s, 1] = np.searchsorted(dests, np.arange(m_loc), side="right")

    # ------------------------------------------------------------------
    # Halo: per shard, the remote vertices referenced by its blur
    # neighbors or its points' slice corners.
    n1g = np.where(lattice.blur_n1 < m, gid[np.minimum(lattice.blur_n1, m - 1)], -1)
    n2g = np.where(lattice.blur_n2 < m, gid[np.minimum(lattice.blur_n2, m - 1)], -1)

    halo_sets = []
    for s in range(d):
        mine = np.flatnonzero(owner == s)  # original vertex ids
        need = []
        for tbl in (n1g, n2g):
            t = tbl[:, mine].reshape(-1)
            need.append(t[t >= 0])
        # Slice corners of this shard's points.
        rows = np.arange(s * n_loc, (s + 1) * n_loc)
        dest = offs_s[rows].reshape(-1)
        dest = dest[dest < m]
        need.append(gid[dest])
        need = np.unique(np.concatenate(need)) if need else np.zeros(0, np.int64)
        need = need[need // m_loc != s]  # remote only
        halo_sets.append(need)

    # Publish lists: union over receivers of what they need from owner o.
    pub_sets = [[] for _ in range(d)]
    for s in range(d):
        for g in halo_sets[s]:
            pub_sets[int(g // m_loc)].append(int(g % m_loc))
    pub_lists = [np.unique(np.array(p, np.int64)) for p in pub_sets]
    u_max = _bucket(max((len(p) for p in pub_lists), default=1) or 1, 8)
    h_max = _bucket(max((len(h) for h in halo_sets), default=1) or 1, 8)

    pub_idx = np.zeros((d, u_max), np.int32)
    for s in range(d):
        pub_idx[s, : len(pub_lists[s])] = pub_lists[s]

    # halo entry (shard r needs global g): find g in owner's publish list.
    pub_pos = {}  # global id -> flat publish-pool index
    for o in range(d):
        for u, l in enumerate(pub_lists[o]):
            pub_pos[o * m_loc + int(l)] = o * u_max + u
    halo_idx = np.zeros((d, h_max), np.int32)
    halo_pos = [dict() for _ in range(d)]  # global id -> pool index
    for s in range(d):
        for k, g in enumerate(halo_sets[s]):
            halo_idx[s, k] = pub_pos[int(g)]
            halo_pos[s][int(g)] = m_loc + k

    # ------------------------------------------------------------------
    # Blur + slice tables in pool coordinates.
    zero_slot = m_loc + h_max

    def to_pool(s: int, g: np.ndarray) -> np.ndarray:
        """Global renumbered ids (or -1 = missing) -> pool indices."""
        out = np.full(g.shape, zero_slot, np.int64)
        local = (g >= 0) & (g // m_loc == s)
        out[local] = g[local] % m_loc
        remote = (g >= 0) & ~local
        if remote.any():
            lut = halo_pos[s]
            out[remote] = [lut[int(x)] for x in g[remote]]
        return out

    blur_n1 = np.full((d, d1, m_loc), zero_slot, np.int32)
    blur_n2 = np.full((d, d1, m_loc), zero_slot, np.int32)
    offsets_p = np.full((d, d1, n_loc), zero_slot, np.int32)
    bary_p = np.zeros((d, d1, n_loc), np.float32)
    for s in range(d):
        mine = np.flatnonzero(owner == s)
        li = local_id[mine]
        blur_n1[s, :, li] = to_pool(s, n1g[:, mine]).T
        blur_n2[s, :, li] = to_pool(s, n2g[:, mine]).T
        rows = np.arange(s * n_loc, (s + 1) * n_loc)
        dest = offs_s[rows]  # [n_loc, d1], == m for padded points
        g = np.where(dest < m, gid[np.minimum(dest, m - 1)], -1)
        offsets_p[s] = to_pool(s, g).T
        bary_p[s] = bary_s[rows].T

    return ShardedLatticePlan(
        n_shards=d, d1=d1, n=n, n_loc=n_loc, m=m, m_loc=m_loc,
        point_order=order.astype(np.int64),
        src_l=src_l, w_l=w_l, seg_l=seg_l,
        src_b=src_b, w_b=w_b, seg_b=seg_b,
        recv_idx=recv_idx, seg_r=seg_r,
        pub_idx=pub_idx, halo_idx=halo_idx,
        blur_n1=blur_n1, blur_n2=blur_n2,
        offsets=offsets_p, barycentric=bary_p,
    )


# ----------------------------------------------------------------------
# Device side
# ----------------------------------------------------------------------


def _seg_sum(contrib: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """[C, S] stream (sorted by segment) -> [C, len] via prefix diffs."""
    return segment_sum_sorted_t(contrib, seg[0], seg[1])


class _ShardPlan:
    """This rank's slice of a :class:`ShardedLatticePlan` on its device."""

    _INDEX = ("src_l", "seg_l", "src_b", "seg_b", "recv_idx", "seg_r",
              "pub_idx", "halo_idx", "blur_n1", "blur_n2", "offsets")
    _WEIGHT = ("w_l", "w_b", "barycentric")

    def __init__(self, plan: "ShardedLatticePlan", s: int, device: torch.device):
        for name in self._INDEX:
            a = np.ascontiguousarray(getattr(plan, name)[s])
            setattr(self, name, torch.from_numpy(a).long().to(device))
        for name in self._WEIGHT:
            a = np.ascontiguousarray(getattr(plan, name)[s])
            setattr(self, name, torch.from_numpy(a).to(device))
        self.d1 = plan.d1


def _filter_shard(mesh: DeviceMesh, axis: str, values_t: torch.Tensor,
                  sp: _ShardPlan, reverse: bool = False) -> torch.Tensor:
    """One permutohedral filter of this rank's ``[C, n_loc]`` values."""
    c = values_t.shape[0]
    d1 = sp.d1
    alpha = 1.0 / (1.0 + 2.0 ** (-(d1 - 1)))
    zero = values_t.new_zeros((c, 1))

    def pool_of(verts):
        pub = verts[:, sp.pub_idx]  # [C, U]
        allu = axis_all_gather(mesh, pub, axis)  # [D, C, U]
        flat = allu.transpose(0, 1).reshape(c, -1)
        return torch.cat([verts, flat[:, sp.halo_idx], zero], dim=1)

    # Splat: local segment sums + exchanged boundary partials.
    verts = _seg_sum(values_t[:, sp.src_l] * sp.w_l, sp.seg_l)
    partials = _seg_sum(values_t[:, sp.src_b] * sp.w_b, sp.seg_b)
    allp = axis_all_gather(mesh, partials, axis)  # [D, C, B]
    flat = torch.cat([allp.transpose(0, 1).reshape(c, -1), zero], dim=1)
    verts = verts + _seg_sum(flat[:, sp.recv_idx], sp.seg_r)

    # Blur: a halo exchange per pass (each pass reads the previous pass's
    # values, remote ones included).
    for j in (range(d1 - 1, -1, -1) if reverse else range(d1)):
        pool = pool_of(verts)
        verts = verts + 0.5 * (pool[:, sp.blur_n1[j]] + pool[:, sp.blur_n2[j]])

    # Slice (the halo once more for remote corners).
    pool = pool_of(verts)
    gathered = pool[:, sp.offsets]  # [C, d1, n_loc]
    return (gathered * sp.barycentric).sum(dim=1) * alpha


def vertex_sharded_potts_mean_field(
    mesh: DeviceMesh,
    axis: str,
    unary,  # [N, Ctot] energies (all layers concatenated)
    lattice: PermutohedralLattice,
    weight: float,
    blocks: Sequence[int],
    n_iterations: int,
    plan: "ShardedLatticePlan | None" = None,
) -> torch.Tensor:  # [N, Ctot]
    """Mean-field marginals with points and vertices sharded.

    The same math as ``potts_mean_field_multi_t`` (the ``[C, N]`` layout,
    the symmetric normalisation from a filtered ones-vector); float32 sums
    differ in order only.
    """
    d = mesh.shape[axis]
    if plan is None:
        plan = plan_sharded_lattice(lattice, d)
    s = mesh.coords[axis]
    dev = mesh.device
    n_loc = plan.n_loc
    sp = _ShardPlan(plan, s, dev)

    # This shard's unaries, in sorted-point order, transposed and padded.
    unary = torch.as_tensor(unary, dtype=torch.float32, device=dev)
    order = torch.from_numpy(plan.point_order).to(dev)
    rows = order[s * n_loc : min((s + 1) * n_loc, plan.n)]
    u_t = unary.new_zeros((unary.shape[1], n_loc))
    u_t[:, : rows.shape[0]] = unary[rows].T

    raw = _filter_shard(mesh, axis, u_t.new_ones((1, n_loc)), sp)[0]
    norm = 1.0 / torch.sqrt(raw + 1e-20)
    q = normalize_blocks(-u_t, blocks)
    for _ in range(n_iterations):
        filtered = _filter_shard(mesh, axis, q * norm, sp) * norm
        q = normalize_blocks(-u_t + weight * filtered, blocks)

    q_all = axis_all_gather(mesh, q, axis)  # [D, Ctot, n_loc], sorted order
    q_sorted = q_all.transpose(1, 2).reshape(d * n_loc, -1)[: plan.n]
    out = torch.empty_like(q_sorted)
    out[order] = q_sorted
    return out


# ----------------------------------------------------------------------
# Variant selection (per map, at load time)
# ----------------------------------------------------------------------


def choose_crf_variant(plan: ShardedLatticePlan) -> str:
    """``'vertex'`` when the halo design moves fewer values per filter.

    The plan carries both designs' measured comm volumes: the vertex-sharded
    halo exchange moves O(boundary) surface terms, the replicated design
    psums the whole [C, M+1] vertex table. High-locality clouds (surfaces,
    scan lines) have small boundaries and flip to ``'vertex'`` once M grows;
    low-locality clouds (near-random feature spreads) stay ``'replicated'``
    (see SCALING.md for the measured crossover).
    """
    if plan.comms_per_filter < plan.replicated_comms_per_filter:
        return "vertex"
    return "replicated"


def auto_sharded_potts_mean_field(
    mesh: DeviceMesh,
    axis: str,
    unary,  # [N, Ctot] energies (all layers concatenated)
    lattice: PermutohedralLattice,
    weight: float,
    blocks: Sequence[int],
    n_iterations: int,
    plan: "ShardedLatticePlan | None" = None,
    force: "str | None" = None,
) -> "Tuple[torch.Tensor, str]":
    """Sharded mean field with the variant that moves fewer values per
    filter (:func:`choose_crf_variant`), or ``force`` ('replicated' |
    'vertex'). -> ``(marginals [N, Ctot], variant used)``; both variants
    match the single-device ``potts_mean_field_multi_t``."""
    d = mesh.shape[axis]
    if plan is None:
        plan = plan_sharded_lattice(lattice, d)
    variant = force or choose_crf_variant(plan)
    if variant == "vertex":
        q = vertex_sharded_potts_mean_field(
            mesh, axis, unary, lattice, weight, blocks, n_iterations,
            plan=plan,
        )
    elif variant == "replicated":
        from .sharded_crf import sharded_potts_mean_field_t

        q = sharded_potts_mean_field_t(
            mesh, axis, unary, lattice, weight, blocks, n_iterations
        )
    else:
        raise ValueError(f"unknown CRF sharding variant {variant!r}")
    return q, variant
