"""Roofline bounds of the port's kernels on one NVIDIA H100.

The least time the card could take for a kernel's work: the larger of the
bytes it must move (each input read once, each output written once; for a
descent, only what this data's paths read) over the memory rate, and its
32-bit instructions on the busiest issue pipe over that pipe's rate.
``chip_smoke.py`` counts its kernels' bytes and instructions through these
functions; ``port_bench/roofline.py`` is the benchmark's frozen copy.
"""

from __future__ import annotations

import torch

# H100 SXM data sheet (700 W): device memory at 3.35 TB/s. Integer work is
# counted as 32-bit instructions per issue pipe: the FMA pipe (IMUL, IMAD)
# and the ALU pipe (shifts, logic, compares, IADD3) each issue 64 per SM per
# clock and run at the same time (the CUDA programming guide's throughput
# table for compute capability 9.0), 132 SMs at the 1.98 GHz boost clock of
# the data sheet's float32 peak of 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PIPE_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit instructions per output byte of a bilinear 8U resample, by pipe:
# four multiplies and two multiply-adds with the rounding term, one shift.
RESAMPLE_OPS = {"fma": 6, "alu": 1}
# Per descent level: field shift and mask, the compare, the child add.
LEVEL_OPS = {"alu": 4}
# Per pixel of the Lab pack: two shifts and two ors.
PACK_OPS = {"alu": 4}


def bound(nbytes: float, ops: dict, count: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the busiest pipe's instructions (``ops`` per unit times
    ``count`` units) over its rate."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    pipe_ops = max(ops.values()) * count
    by_ops = 1e3 * pipe_ops / PIPE_OPS_PER_S
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(pipe_ops))


def descent_reads(feats, forest):
    """What the descent must read on ``feats``, from the plain descent on
    the card: a [P, D] mask of the (point, feature) pairs it compares, the
    number of distinct (tree, node) records it loads, the distinct (tree,
    leaf) histograms it sums, its levels, and its leaf ids."""
    records = forest.records
    num_trees, n_nodes, _ = records.shape
    p, d = feats.shape
    dev = feats.device
    fmask = (1 << forest.feat_bits) - 1
    trees = torch.arange(num_trees, device=dev)[None, :]
    points = torch.arange(p, device=dev)[:, None].expand(p, num_trees)
    node = torch.zeros((p, num_trees), dtype=torch.int64, device=dev)
    touched = torch.zeros((p, d), dtype=torch.bool, device=dev)
    visited = torch.zeros((num_trees, n_nodes), dtype=torch.bool, device=dev)
    levels = 0
    for _ in range(forest.max_depth):
        meta = records[..., 0][trees, node]
        visited[trees.expand(p, num_trees), node] = True
        left = meta >> forest.feat_bits
        active = left != 0
        n_active = int(active.sum())
        if n_active == 0:
            break
        levels += n_active
        f = (meta & fmask).long()
        touched[points[active], f[active]] = True
        x = feats[points, f]
        thr = records[..., 1].view(torch.float32)[trees, node]
        node = torch.where(active, left.long() + (x >= thr).long(), node)
    reached = torch.zeros_like(visited)
    reached[trees.expand(p, num_trees), node] = True
    return dict(touched=touched, records=int(visited.sum()),
                leaves=int(reached.sum()), levels=levels,
                leaf_ids=node.to(torch.int32))


def descent_bound(reads, forest, layout, with_histograms=True) -> dict:
    """Kernel B's (or C''s, without histograms) bound on rows in ``layout``:
    each compared feature once (a patch byte, or 4 bytes), each loaded node
    record (8 B) and summed leaf histogram once, the outputs once."""
    touched = reads["touched"]
    p, d = touched.shape
    pc = layout.patch_bytes
    feature_bytes = (int(touched[:, :pc].sum())
                     + 4 * int(touched[:, pc:].sum()))
    num_trees, _, num_layers, c_max = forest.leaf_hist.shape
    nbytes = feature_bytes + 8 * reads["records"] + 4 * p * num_trees
    if with_histograms:
        lc = num_layers * c_max
        nbytes += 4 * lc * reads["leaves"] + 4 * p * lc
    return dict(bound(nbytes, LEVEL_OPS, reads["levels"]),
                feature_bytes=feature_bytes)


def resample_bound(image_bytes, depth_grid, patch_bytes, row_bytes) -> dict:
    """Kernel A's (and D''s) bound: the image and depth grid read once,
    every output row written once, ``RESAMPLE_OPS`` per patch byte of a
    point with depth."""
    points = depth_grid.numel()
    valid = int((depth_grid > 0).sum())
    nbytes = image_bytes + 4 * points + row_bytes * points
    return bound(nbytes, RESAMPLE_OPS, patch_bytes * valid)


def split_search_bound(k: int, ns: int, active: int, valid: int, f: int,
                       c: int) -> dict:
    """The exact split search after the sort (``csrc/split_search.cu``) over
    ``k`` slots of ``ns`` positions, ``active`` of them on the searched
    frontier, ``valid`` (slot, position) candidates, ``f`` segments, ``c``
    classes: each slot's sorted keys and order read once over the active
    positions (8 B each), the unsorted segments and classes once (8 B each),
    the four [K, F] float32 results written; the entropies' float work at
    the valid candidates on the FMA pipe (each class's two terms, a multiply
    and an add each; both masses' terms and the children's sum)."""
    nbytes = 16 * k * active + 16 * ns + 16 * k * f
    return bound(nbytes, {"fma": 4 * c + 5}, valid)
