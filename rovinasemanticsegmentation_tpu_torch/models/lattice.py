"""Permutohedral lattice: build and filter for the dense CRF of the map path.

Counterpart of ``rovinasemanticsegmentation_tpu/models/lattice.py``, after
the reference lattice (``permutohedral.cpp:323-527``). Two builds give the
same lattice:

- :func:`build_lattice` on the host: the native hash-table builder
  (``rovinasemanticsegmentation_tpu/native``, vertex ids in insertion order)
  or its NumPy fallback (lexicographic ids), then :func:`pad_lattice` and
  :func:`attach_sorted_stream`;
- :func:`build_lattice_device` on the tensors' device with static shapes: a
  lexicographic sort of the packed vertex keys, run detection, and one
  sort-merge of every blur-neighbour query against the unique keys. Vertex
  ids are lexicographic, so it equals the NumPy build index for index.

The filter (:func:`lattice_filter_t`) works in the transposed ``[C, N]``
layout on the build's sorted splat stream: the splat is a float32 prefix sum
with per-vertex range differences, so no float atomics decide its summation
order and a GPU gives the same sums on every run. The points-major
:func:`lattice_filter` of the JAX package (a scatter-add splat) is its
``[N, C]`` face: the port keeps one filter.

Semantics kept from the reference: elevation with
``scale[i] = inv_std_dev / sqrt((i+1)(i+2))``; nearest-remainder rounding and
the rank's tie-breaking; barycentric weights with the wrap-around term; the
blur ``new = old + 0.5 (n1 + n2)`` along each of the d+1 axes with a zero
slot for missing neighbours; ``alpha = 1/(1+2^-d)`` at slice time; ``reverse``
order for the transposed filter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_SENTINEL = 0x7FFFFFFF  # packed key of a padded vertex: sorts after every real key


@dataclass
class PermutohedralLattice:
    """Host-built lattice for N points in d dimensions."""

    offsets: np.ndarray  # [N, d+1] int32 vertex index per simplex corner
    barycentric: np.ndarray  # [N, d+1] float32
    blur_n1: np.ndarray  # [d+1, M] int32 neighbour index, M = missing
    blur_n2: np.ndarray  # [d+1, M] int32
    num_vertices: int  # M
    dim: int  # d
    # Sorted splat stream (attach_sorted_stream): contributions sorted by
    # vertex id, and per-vertex [start, end) row ranges into that stream.
    sorted_points: Optional[np.ndarray] = None  # [Spad] int32
    sorted_weights: Optional[np.ndarray] = None  # [Spad] float32
    seg_starts: Optional[np.ndarray] = None  # [M] int32
    seg_ends: Optional[np.ndarray] = None  # [M] int32


def _embedding_scale(d: int) -> np.ndarray:
    """Per-axis elevation scale ``inv_std_dev / sqrt((i+1)(i+2))`` (float64)."""
    inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
    return (1.0 / np.sqrt((np.arange(d) + 2.0) * (np.arange(d) + 1.0))) * inv_std_dev


def build_lattice(
    features: np.ndarray, use_native: bool = True
) -> PermutohedralLattice:
    """Host build for features [N, d] (permutohedral.cpp:323-474).

    The C++ hash-table builder first (insertion-order vertex ids); without a
    toolchain, the vectorised NumPy sort/unique path below (lexicographic
    ids), a copy of the JAX package's fallback.
    """
    features = np.asarray(features, dtype=np.float32)
    n, d = features.shape

    if use_native:
        from ..native import native_lattice_build

        built = native_lattice_build(features)
        if built is not None:
            offsets, bary, blur_n1, blur_n2, m = built
            return PermutohedralLattice(offsets, bary, blur_n1, blur_n2, m, d)

    scale = _embedding_scale(d)
    # Elevation y = E p: elevated[j] = sum_{k>=j} c_k - j*c_{j-1}, c = f*scale.
    c = features * scale[None, :]
    suffix = np.concatenate(
        [np.cumsum(c[:, ::-1], axis=1)[:, ::-1], np.zeros((n, 1), np.float32)], axis=1
    )
    elevated = np.empty((n, d + 1), dtype=np.float32)
    elevated[:, 0] = suffix[:, 0]
    js = np.arange(1, d + 1)
    elevated[:, 1:] = suffix[:, 1:] - js[None, :] * c

    # Round to the nearest multiple of (d+1) (permutohedral.cpp:372-390).
    down_factor = 1.0 / (d + 1)
    v = down_factor * elevated
    up = np.ceil(v) * (d + 1)
    down = np.floor(v) * (d + 1)
    rem0 = np.where(up - elevated < elevated - down, up, down).astype(np.float32)
    rem_sum = (rem0.sum(axis=1) * down_factor).astype(np.int32)

    # Rank: descending order of (elevated - rem0), ties by original index.
    di = elevated - rem0
    order = np.argsort(-di, axis=1, kind="stable")
    rank = np.empty((n, d + 1), dtype=np.int32)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(d + 1), (n, d + 1)), axis=1)

    # Wrap ranks/remainders so the point lies on the plane (:404-415).
    rank = rank + rem_sum[:, None]
    low = rank < 0
    rank = np.where(low, rank + (d + 1), rank)
    rem0 = np.where(low, rem0 + (d + 1), rem0)
    high = rank > d
    rank = np.where(high, rank - (d + 1), rank)
    rem0 = np.where(high, rem0 - (d + 1), rem0)

    # Barycentric coordinates (:417-426).
    bary = np.zeros((n, d + 2), dtype=np.float32)
    vbar = (elevated - rem0) * down_factor
    rows = np.repeat(np.arange(n), d + 1)
    idx = (d - rank).reshape(-1)
    np.add.at(bary, (rows, idx), vbar.reshape(-1))
    np.add.at(bary, (rows, idx + 1), -vbar.reshape(-1))
    bary[:, 0] += 1.0 + bary[:, d + 1]
    barycentric = bary[:, : d + 1]

    # Vertex keys per remainder (:428-435): canonical simplex coordinates.
    canonical = np.empty((d + 1, d + 1), dtype=np.int32)
    for r in range(d + 1):
        canonical[r, : d + 1 - r] = r
        canonical[r, d + 1 - r :] = r - (d + 1)
    keys = (
        rem0[:, None, :d].astype(np.int32)
        + canonical[np.arange(d + 1)[None, :, None], rank[:, None, :d]]
    )  # [N, d+1, d]
    unique_keys, inverse = np.unique(
        keys.reshape(n * (d + 1), d), axis=0, return_inverse=True
    )
    m = len(unique_keys)
    offsets = inverse.reshape(n, d + 1).astype(np.int32)

    # Blur neighbours (:446-471): for axis j, n1 = key - 1 except +d at j.
    uview = np.ascontiguousarray(unique_keys).view([("", unique_keys.dtype)] * d).ravel()

    def lookup(query: np.ndarray) -> np.ndarray:
        """Rows of query -> vertex index or M (missing)."""
        qview = np.ascontiguousarray(query).view([("", query.dtype)] * d).ravel()
        pos = np.clip(np.searchsorted(uview, qview), 0, m - 1)
        return np.where(uview[pos] == qview, pos, m).astype(np.int32)

    blur_n1 = np.empty((d + 1, m), dtype=np.int32)
    blur_n2 = np.empty((d + 1, m), dtype=np.int32)
    for j in range(d + 1):
        n1 = unique_keys - 1
        n2 = unique_keys + 1
        if j < d:
            n1[:, j] = unique_keys[:, j] + d
            n2[:, j] = unique_keys[:, j] - d
        blur_n1[j] = lookup(n1)
        blur_n2[j] = lookup(n2)

    return PermutohedralLattice(
        offsets, barycentric.astype(np.float32), blur_n1, blur_n2, m, d
    )


def pad_lattice(
    lattice: PermutohedralLattice, bucket: int = 1 << 14
) -> PermutohedralLattice:
    """Pad the vertex count to ``bucket``, doubled until it holds M.

    Padded vertices have no splat contributions and their blur neighbours
    are the zero slot (the new ``M``), so they stay zero and never touch a
    real vertex.
    """
    m = lattice.num_vertices
    m_pad = bucket
    while m_pad < m:
        m_pad *= 2
    if m_pad == m:
        return lattice
    d1 = lattice.blur_n1.shape[0]

    def pad_tbl(t: np.ndarray) -> np.ndarray:
        t = np.where(t == m, m_pad, t)  # "missing" moves to the new zero slot
        return np.concatenate([t, np.full((d1, m_pad - m), m_pad, t.dtype)], axis=1)

    return PermutohedralLattice(
        lattice.offsets, lattice.barycentric, pad_tbl(lattice.blur_n1),
        pad_tbl(lattice.blur_n2), m_pad, lattice.dim,
    )


def attach_sorted_stream(lattice: PermutohedralLattice) -> PermutohedralLattice:
    """Add the sorted splat stream for :func:`lattice_filter_t`: the N*(d+1)
    contributions sorted (stably) by vertex id, padded to a multiple of 128,
    and each vertex's [start, end) rows. Call after :func:`pad_lattice`."""
    if lattice.sorted_points is not None:
        return lattice
    n, d1 = lattice.offsets.shape
    flat = lattice.offsets.reshape(-1)
    perm = np.argsort(flat, kind="stable")
    sorted_ids = flat[perm]
    s = n * d1
    spad = -(-s // 128) * 128
    vertices = np.arange(lattice.num_vertices)
    lattice.sorted_points = np.pad((perm // d1).astype(np.int32), (0, spad - s))
    lattice.sorted_weights = np.pad(
        lattice.barycentric.reshape(-1)[perm].astype(np.float32), (0, spad - s)
    )
    lattice.seg_starts = np.searchsorted(sorted_ids, vertices, "left").astype(np.int32)
    lattice.seg_ends = np.searchsorted(sorted_ids, vertices, "right").astype(np.int32)
    return lattice


def lattice_tensors(
    lattice: PermutohedralLattice, device: torch.device
) -> Tuple[torch.Tensor, ...]:
    """A padded host lattice with its sorted stream as the eight tensors of
    :func:`build_lattice_device`'s result (without ``m``), on ``device``."""
    arrays = (
        lattice.sorted_points, lattice.sorted_weights, lattice.seg_starts,
        lattice.seg_ends, lattice.offsets.T, lattice.barycentric.T,
        lattice.blur_n1, lattice.blur_n2,
    )
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.long() if t.dtype == torch.int32 else t)
    return tuple(t.to(device) for t in out)


# ----------------------------------------------------------------------
# Device build (static shapes, no synchronisation)
# ----------------------------------------------------------------------


def _fused_sub(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """``a - b * c`` rounded once to float32, as a fused multiply-add.

    XLA on the CPU contracts the elevation's ``suffix - j * c`` into FMAs,
    and the vertex keys depend on the last bit of the elevation (rounding to
    the nearest remainder point, ranking the residuals). The float64
    product of two float32 numbers is exact, so one float64 subtraction
    rounded to float32 gives the fused result on every device (``c`` is a
    float32 value held in a Python float).
    """
    return (a.double() - b.double() * c).float()


def _embed_simplex(features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed, round, rank and weight each point (permutohedral.cpp:352-426).

    Returns ``(keys [N, d+1, d] int64 simplex-corner coordinates,
    bary [N, d+1] float32)``, bit-equal to the JAX package's
    ``_embed_simplex`` on the CPU: the suffix sums run right to left, and
    ``suffix_j - j * c_{j-1}`` is fused, with the product ``f_0 * scale_0``
    itself fused for j = 1 (XLA drops the multiply by one there).
    """
    n, d = features.shape
    d1 = d + 1
    dev = features.device
    scale_np = _embedding_scale(d).astype(np.float32)
    c = features * torch.from_numpy(scale_np).to(dev)
    suffix = [torch.zeros(n, dtype=torch.float32, device=dev)]  # suffix_d = 0
    for j in range(d - 1, -1, -1):
        suffix.append(suffix[-1] + c[:, j])
    suffix.reverse()  # suffix[j] = c_j + ... + c_{d-1}
    elevated = [suffix[0], _fused_sub(suffix[1], features[:, 0], float(scale_np[0]))]
    elevated += [_fused_sub(suffix[j], c[:, j - 1], float(j)) for j in range(2, d1)]
    elevated = torch.stack(elevated, dim=1)  # [N, d+1]

    down = 1.0 / d1
    v = elevated * down
    up = torch.ceil(v) * d1
    dn = torch.floor(v) * d1
    rem0 = torch.where(up - elevated < elevated - dn, up, dn)
    rem_sum = (rem0.sum(dim=1) * down).to(torch.int64)  # trunc, as astype(int32)

    # Descending stable rank of the residuals (ties by index):
    # rank[i] = #{j > i : d_i < d_j} + #{j < i : d_j >= d_i}.
    diff = elevated - rem0
    i_idx = torch.arange(d1, device=dev)
    later = i_idx[None, :] > i_idx[:, None]  # [i, j]: j > i
    di, dj = diff[:, :, None], diff[:, None, :]
    cond = torch.where(later, di < dj, dj >= di) & (i_idx[None, :] != i_idx[:, None])
    rank = cond.sum(dim=2) + rem_sum[:, None]

    low = rank < 0
    rank = torch.where(low, rank + d1, rank)
    rem0 = torch.where(low, rem0 + d1, rem0)
    high = rank > d
    rank = torch.where(high, rank - d1, rank)
    rem0 = torch.where(high, rem0 - d1, rem0)

    # Barycentric weights without a scatter: slot d - rank[i] takes +vbar[i]
    # and the next slot -vbar[i]; slot 0 absorbs the wrap-around term.
    vbar = (elevated - rem0) * down
    slots = d - rank
    cols = [
        torch.where(slots == k, vbar, 0.0).sum(dim=1)
        - torch.where(slots == k - 1, vbar, 0.0).sum(dim=1)
        for k in range(d + 2)
    ]
    cols[0] = cols[0] + (1.0 + cols[d + 1])
    bary = torch.stack(cols[:d1], dim=1)

    # Simplex corner r: coordinate i steps by r, wrapping past d - r.
    r_idx = torch.arange(d1, device=dev)[None, :, None]
    step = torch.where(rank[:, None, :d] <= d - r_idx, r_idx, r_idx - d1)
    keys = rem0[:, None, :d].to(torch.int64) + step
    return keys, bary


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 range with two's-complement wrap."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _pack_pair16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two signed 16-bit coordinates -> one int32 word (held in int64) that
    keeps lexicographic order: ``hi * 2^16 + lo + 2^15``, wrapped like the
    JAX package's int32 arithmetic. Real vertices' coordinates stay far
    inside 16 bits; only queries from padded vertices (masked later) wrap."""
    return _wrap_int32(hi * 65536 + lo + (1 << 15))


def _pack_keys16(coords: Sequence[torch.Tensor], d: int) -> List[torch.Tensor]:
    """d coordinate columns -> ceil(d/2) packed sort words."""
    words = []
    for i in range((d + 1) // 2):
        hi = coords[2 * i]
        lo = coords[2 * i + 1] if 2 * i + 1 < d else torch.full_like(hi, -(1 << 15))
        words.append(_pack_pair16(hi, lo))
    return words


def _lexsort(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by ``words`` lexicographically (first
    word most significant), as ``jax.lax.sort(..., num_keys=len(words))``.

    Each word holds an int32 value; pairs are joined into one int64 key,
    and stable sorts run from the least significant key to the most.
    """
    keys = []
    for i in range(0, len(words), 2):
        if i + 1 < len(words):
            keys.append(words[i] * (1 << 32) + (words[i + 1] + (1 << 31)))
        else:
            keys.append(words[i])
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _dedup_sorted(packs, bary, n: int, d: int, m_bucket: int, spad: int):
    """Vertex dedup by a lexicographic key sort, the sorted splat stream and
    the point offsets.

    Returns ``(sorted_points, sorted_weights, seg_starts, seg_ends,
    offsets_t, m, uq, ucoord)``; ``uq``/``ucoord`` are the per-vertex packed
    words and coordinates for the blur-neighbour merge. The sort is stable,
    as ``jax.lax.sort`` is by default, so within a vertex the splat stream
    keeps point order and equals the JAX package's stream.
    """
    d1 = d + 1
    s = n * d1
    dev = bary.device
    pos_sorted = _lexsort(packs)
    sp = [p[pos_sorted] for p in packs]

    prev_eq = torch.ones(s, dtype=torch.bool, device=dev)
    for p in sp:
        prev_eq &= p == torch.cat([p[:1] - 1, p[:-1]])
    is_new = ~prev_eq  # row 0 is always new
    vid_sorted = torch.cumsum(is_new, dim=0) - 1
    m = vid_sorted[-1] + 1  # device scalar: the caller checks m <= m_bucket

    # Offsets back in point order, ids clamped into the bucket so indexing
    # stays in range on overflow (the caller rejects such a build via m).
    # The inverse permutation is a sort, as in the JAX package.
    vid_c = torch.clamp(vid_sorted, max=m_bucket - 1)
    offsets_t = vid_c[torch.argsort(pos_sorted)].reshape(n, d1).T.contiguous()

    sorted_points = F.pad(pos_sorted // d1, (0, spad - s))
    sorted_weights = F.pad(bary.reshape(-1)[pos_sorted], (0, spad - s))
    # Segment bounds by a max-scatter (order-free); rows that start or end
    # no segment go to a trailing slot that is cut off. Padded vertices keep
    # empty [0, 0) segments.
    idx_s = torch.arange(s, device=dev)
    nxt_new = torch.cat([is_new[1:], torch.ones(1, dtype=torch.bool, device=dev)])

    def bound(mask, value):
        out = torch.zeros(m_bucket + 1, dtype=torch.int64, device=dev)
        tgt = torch.where(mask, vid_c, m_bucket)
        return out.scatter_reduce_(0, tgt, torch.where(mask, value, 0), "amax")[:-1]

    seg_starts = bound(is_new, idx_s)
    seg_ends = bound(nxt_new, idx_s + 1)

    # Per-vertex packed words from each vertex's first row, the sentinel
    # past m; coordinates by unpacking (hi = w >> 16 arithmetic,
    # lo = (w & 0xFFFF) - 2^15).
    real = torch.arange(m_bucket, device=dev) < m
    uq = [torch.where(real, p[seg_starts], _SENTINEL) for p in sp]
    ucoord = []
    for i, w in enumerate(uq):
        ucoord.append(w >> 16)
        if 2 * i + 1 < d:
            ucoord.append((w & 0xFFFF) - (1 << 15))
    return (sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
            m, uq, ucoord)


def _blur_neighbor_queries(ucoord, d: int) -> List[List[torch.Tensor]]:
    """Packed keys of each vertex's neighbour along axis j in the +1
    direction, one set per axis (permutohedral.cpp:434-474): coordinate j
    steps by +d, every other coordinate by -1 (axis d: all -1)."""
    sets = []
    for j in range(d + 1):
        coords = [ucoord[i] + (d if i == j else -1) for i in range(d)]
        sets.append(_pack_keys16(coords, d))
    return sets


def _blur_neighbors_sort(uq, ucoord, m, m_bucket: int, d: int):
    """Blur neighbours of every vertex by ONE sort-merge.

    The unique keys (payload = slot id < m_bucket) and every +1 query
    (payload = (j+1) * m_bucket + slot) sort together with the payload as
    the final key, so each equal-key run starts with its unique row, if
    any. Unique slot ids rise with key order, so a cummax of masked slot
    ids carries the most recent unique row, and a query matches when that
    row lies inside its own run (cummax of run starts). A payload sort
    routes the results back. The -1 direction inverts the +1 map
    (n1_j(u) = v <=> n2_j(v) = u; collision-free), misses to a cut-off
    trailing slot.
    """
    d1 = d + 1
    dev = uq[0].device
    real = torch.arange(m_bucket, device=dev) < m
    queries = _blur_neighbor_queries(ucoord, d)
    keys = [torch.cat([uq[i]] + [q[i] for q in queries]) for i in range(len(uq))]
    t_rows = keys[0].shape[0]
    payload = torch.arange(t_rows, device=dev)  # slot + set * m_bucket
    spay = _lexsort(keys + [payload])  # == payload[order]
    iota = torch.arange(t_rows, device=dev)
    is_u = spay < m_bucket
    run_start = torch.zeros(t_rows, dtype=torch.bool, device=dev)
    run_start[0] = True
    for k in keys:
        ks = k[spay]
        run_start[1:] |= ks[1:] != ks[:-1]
    rs_idx = torch.cummax(torch.where(run_start, iota, -1), dim=0).values
    u_idx = torch.cummax(torch.where(is_u, iota, -1), dim=0).values
    u_slot = torch.cummax(torch.where(is_u, spay, -1), dim=0).values
    match = (u_idx >= rs_idx) & (u_slot >= 0) & (u_slot < m)
    result = torch.where(match, u_slot, m_bucket)
    back = result[torch.argsort(spay)]
    blur_n1 = torch.where(real, back[m_bucket:].reshape(d1, m_bucket), m_bucket)

    src = torch.arange(m_bucket, device=dev).repeat(d1)
    tgt = (torch.arange(d1, device=dev)[:, None] * m_bucket + blur_n1).reshape(-1)
    tgt = torch.where(blur_n1.reshape(-1) < m_bucket, tgt, d1 * m_bucket)
    blur_n2 = torch.full((d1 * m_bucket + 1,), m_bucket, dtype=torch.int64,
                         device=dev)
    blur_n2 = blur_n2.scatter_reduce_(0, tgt, src, "amin")[:-1].reshape(d1, m_bucket)
    blur_n2 = torch.where(real, blur_n2, m_bucket)
    return blur_n1, blur_n2


def build_lattice_device(features: torch.Tensor, m_bucket: int = 1 << 14):
    """The whole lattice build on the features' device, without a sync.

    ``features`` is [N, d] float32. Vertices pad to ``m_bucket`` with empty
    splat segments and missing-slot blur neighbours (the zero slot is index
    ``m_bucket``), the :func:`pad_lattice` contract. Returns
    ``(sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
    barycentric_t, blur_n1, blur_n2, m)``: int64 indices, float32 weights,
    and ``m`` the real vertex count as a device scalar. ``m > m_bucket``
    means overflow: the shapes hold, the contents are wrong, and the caller
    must rebuild with a larger bucket.
    """
    n, d = features.shape
    s = n * (d + 1)
    spad = -(-s // 128) * 128
    keys, bary = _embed_simplex(features.float())
    kflat = keys.reshape(s, d)
    packs = _pack_keys16([kflat[:, i] for i in range(d)], d)
    (sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t, m, uq,
     ucoord) = _dedup_sorted(packs, bary, n, d, m_bucket, spad)
    blur_n1, blur_n2 = _blur_neighbors_sort(uq, ucoord, m, m_bucket, d)
    return (sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
            bary.T.contiguous(), blur_n1, blur_n2, m)


# ----------------------------------------------------------------------
# Filter
# ----------------------------------------------------------------------


def segment_sum_sorted_t(
    contrib: torch.Tensor,  # [C, S] stream sorted by segment
    starts: torch.Tensor,  # [M] first row of each segment
    ends: torch.Tensor,  # [M] one past the last row
) -> torch.Tensor:  # [C, M]
    """Per-segment sums over a sorted stream, in the input's dtype: a
    two-level prefix (cumsum within rows of 128, plus the exclusive prefix
    of row totals; both short scans, so both parallel), then range
    differences. Deterministic: no atomics.

    The prefix runs in float64. A float32 prefix grows with the stream, and
    its rounding (an ulp of the running total) swamps the sums of small
    segments: on a 64x80 image's bilateral lattice, where most vertices
    hold one point, mean-field marginals moved by up to 1.8e-2.
    """
    c, s = contrib.shape
    spad = -(-s // 128) * 128
    x = F.pad(contrib.double(), (0, spad - s)).reshape(c, spad // 128, 128)
    within = torch.cumsum(x, dim=2)
    rowtot = within[:, :, -1]
    carry = torch.cumsum(rowtot, dim=1) - rowtot
    prefix = (within + carry[:, :, None]).reshape(c, spad)[:, :s]
    prefix = torch.cat([prefix.new_zeros((c, 1)), prefix], dim=1)
    return (prefix[:, ends] - prefix[:, starts]).to(contrib.dtype)


def lattice_filter_t(
    values_t: torch.Tensor,  # [C, N]
    sorted_points: torch.Tensor,  # [Spad]
    sorted_weights: torch.Tensor,  # [Spad]
    seg_starts: torch.Tensor,  # [M]
    seg_ends: torch.Tensor,  # [M]
    offsets_t: torch.Tensor,  # [d+1, N]
    barycentric_t: torch.Tensor,  # [d+1, N]
    blur_n1: torch.Tensor,  # [d+1, M]
    blur_n2: torch.Tensor,  # [d+1, M]
    num_vertices: int,
    reverse: bool = False,
) -> torch.Tensor:  # [C, N]
    """Splat -> blur -> slice in the [C, N] layout (permutohedral.cpp:476-527).

    The splat is :func:`segment_sum_sorted_t` over the sorted stream; the
    blur runs d+1 passes (reversed with ``reverse``), missing neighbours
    reading the zero slot at index ``num_vertices``.
    """
    c = values_t.shape[0]
    d1 = offsets_t.shape[0]
    m = num_vertices
    alpha = 1.0 / (1.0 + 2.0 ** (-(d1 - 1)))

    contrib = values_t[:, sorted_points] * sorted_weights
    verts = segment_sum_sorted_t(contrib, seg_starts, seg_ends)  # [C, M]
    zero = values_t.new_zeros((c, 1))
    verts = torch.cat([verts, zero], dim=1)
    for j in (range(d1 - 1, -1, -1) if reverse else range(d1)):
        blurred = verts[:, :m] + 0.5 * (verts[:, blur_n1[j]] + verts[:, blur_n2[j]])
        verts = torch.cat([blurred, zero], dim=1)
    gathered = verts[:, offsets_t]  # [C, d+1, N]
    return (gathered * barycentric_t).sum(dim=1) * alpha


def lattice_filter(
    values: torch.Tensor,  # [N, C]
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    num_vertices: int,
    reverse: bool = False,
) -> torch.Tensor:  # [N, C]
    """Points-major splat -> blur -> slice: :func:`lattice_filter_t` on the
    transposed values, on the lattice's sorted stream (the eight tensors of
    :func:`lattice_tensors` or :func:`build_lattice_device`)."""
    return lattice_filter_t(
        values.T, sorted_points, sorted_weights, seg_starts, seg_ends,
        offsets_t, barycentric_t, blur_n1, blur_n2, num_vertices, reverse,
    ).T


def filter_ones_norm(lattice: PermutohedralLattice) -> np.ndarray:
    """The normalisation vector, the filter of all-ones (pairwise.cpp:44),
    of a host lattice, computed on the CPU."""
    lattice = attach_sorted_stream(lattice)
    ones = torch.ones((lattice.offsets.shape[0], 1), dtype=torch.float32)
    out = lattice_filter(ones, *lattice_tensors(lattice, torch.device("cpu")),
                         lattice.num_vertices)
    return out[:, 0].numpy()
