"""Stage split of the lattice's neighbour phase and of the CRF filter on the card.

Usage (from the repository root; on the card unless ``--device cpu``):

    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_filter \
        [--points 30000] [--reps 3] [--device cuda|cpu]

The port's counterpart of ``scripts/exp_filter.py``, on the CRF features of
the bench's map (``--points`` points, d = 6) and C = 9 channels of values.
Stages:

  dedup             embed + key pack + vertex dedup (``exp_lattice.dedup``)
  neigh 1-4         the neighbour phase cumulatively: 1 the queries and the
                    merge sort (``_neighbor_merge_sort``), 2 + the cummax
                    match (``_neighbor_match``), 3 + the payload sort back
                    (``_neighbor_route_back``), 4 the whole
                    ``_blur_neighbors_sort`` (+ both tables, the -1
                    direction by inversion)
  filter (whole)    ``lattice_filter_t`` on [C, N] values
  splat, blur, slice  its parts alone: ``_splat_t``, ``_blur_t`` (the d + 1
                    passes, each reading both neighbours), ``_slice_t``

Call i's input: features + ``i * 1e-5`` (dedup); every real vertex's
coordinates shifted by i (neighbour steps: the packed keys keep their order
and every match, so the tables are those of the build); values + ``i *
1e-6`` (filter and its parts). The summary gives each neighbour step's
share as the difference of cumulative wall slopes, the sum of splat, blur
and slice beside the whole filter (glue sits between the parts, so the sum
is not checked against the whole), m and the bucket. Checks: the dedup stage
and the neighbour steps composed equal ``build_lattice_device`` bit for bit; splat, blur and slice composed agree
with ``lattice_filter_t`` within rtol 2e-4 / atol 2e-5; m fits the bucket.
The JAX script's bfloat16 filter is not ported: the port's splat keeps a
float64 prefix, and bfloat16 values are another numeric contract. Timing
method: ``stage_timing``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.lattice import (
    _SENTINEL,
    _blur_neighbors_sort,
    _blur_t,
    _neighbor_match,
    _neighbor_merge_sort,
    _neighbor_route_back,
    _neighbor_tables,
    _pack_keys16,
    _slice_t,
    _splat_t,
    build_lattice_device,
    lattice_filter_t,
)
from .exp_lattice import dedup
from .stage_timing import (
    MAP_BUCKET,
    Stage,
    arguments,
    finish,
    map_features,
    measure,
    same,
    start,
    wall,
)

K1, K2 = 4, 16
CHANNELS = 9
RTOL, ATOL = 2e-4, 2e-5  # the filter's contract (f32 summation order)
NEIGH = ("neigh 1: merge sort", "neigh 2: + cummax/match",
         "neigh 3: + back sort", "neigh 4: whole")


def shifted_keys(uq, ucoord, m, shift: int):
    """Every real vertex's coordinates plus ``shift``, repacked; padded
    slots keep the sentinel and its coordinates."""
    real = torch.arange(uq[0].shape[0], device=uq[0].device) < m
    coords = [torch.where(real, c + shift, c) for c in ucoord]
    words = _pack_keys16(coords, len(coords))
    return [torch.where(real, w, _SENTINEL) for w in words], coords


def neighbor_steps(uq, ucoord, m, m_bucket: int, upto: int):
    """The neighbour phase up to step ``upto`` (1-3; 4 is the whole)."""
    d = len(ucoord)
    keys, spay = _neighbor_merge_sort(uq, ucoord, m_bucket, d)
    if upto == 1:
        return keys, spay
    result = _neighbor_match(keys, spay, m, m_bucket)
    if upto == 2:
        return result
    return _neighbor_route_back(spay, result)


def filter_parts(values, geometry, m_bucket: int):
    """Splat, blur and slice composed: ``lattice_filter_t``'s work."""
    sp, sw, ss, se, offsets_t, bary_t, n1, n2 = geometry
    verts = _blur_t(_splat_t(values, sp, sw, ss, se), n1, n2, m_bucket, False)
    return _slice_t(verts, offsets_t, bary_t)


def stages(features, values, verts, built, m_bucket: int) -> List[Stage]:
    (_, _, _, _, _, m, uq, ucoord, _), _ = dedup(features, m_bucket)
    sp, sw, ss, se, offsets_t, bary_t, n1, n2 = built[:8]

    def keys(i):
        return (*shifted_keys(uq, ucoord, m, i), m)

    def neigh(upto):
        return lambda q, c, mm: neighbor_steps(q, c, mm, m_bucket, upto)

    def vals(i):
        return (values + i * 1e-6,)

    def vs(i):
        return (verts + i * 1e-6,)

    return [
        Stage("dedup", lambda i: (features + i * 1e-5,),
              lambda f: dedup(f, m_bucket), (K1, K2)),
        Stage(NEIGH[0], keys, neigh(1), (K1, K2)),
        Stage(NEIGH[1], keys, neigh(2), (K1, K2)),
        Stage(NEIGH[2], keys, neigh(3), (K1, K2)),
        Stage(NEIGH[3], keys,
              lambda q, c, mm: _blur_neighbors_sort(q, c, mm, m_bucket,
                                                    len(c)), (K1, K2)),
        Stage("filter (whole)", vals,
              lambda v: lattice_filter_t(v, *built[:8], m_bucket), (K1, K2)),
        Stage("splat", vals, lambda v: _splat_t(v, sp, sw, ss, se), (K1, K2)),
        Stage("blur (7 passes)", vs,
              lambda v: _blur_t(v, n1, n2, m_bucket, False), (K1, K2)),
        Stage("slice", vs, lambda v: _slice_t(v, offsets_t, bary_t), (K1, K2)),
    ]


def inputs(points: int, dev: torch.device):
    """-> (features [N, 6], values [C, N], vertex values [C, M + 1] with the
    zero slot last), from seed 0."""
    rng = np.random.default_rng(0)
    values = rng.uniform(0, 1, (CHANNELS, points)).astype(np.float32)
    verts = rng.uniform(0, 1, (CHANNELS, MAP_BUCKET)).astype(np.float32)
    verts = np.concatenate([verts, np.zeros((CHANNELS, 1), np.float32)], 1)
    return (map_features(points, dev), torch.from_numpy(values).to(dev),
            torch.from_numpy(verts).to(dev))


def checks_of(features, values, built, m_bucket: int) -> dict:
    (sp, sw, ss, se, offsets_t, m, uq, ucoord, _), bary = dedup(
        features, m_bucket)
    back = neighbor_steps(uq, ucoord, m, m_bucket, 3)
    n1, n2 = _neighbor_tables(back, m, m_bucket, len(ucoord))
    stepped = (sp, sw, ss, se, offsets_t, bary.T.contiguous(), n1, n2, m)
    parts = filter_parts(values, built[:8], m_bucket)
    whole = lattice_filter_t(values, *built[:8], m_bucket)
    return {
        "dedup + neighbour steps == build_lattice_device": same(stepped, built),
        "splat, blur, slice == lattice_filter_t (rtol 2e-4, atol 2e-5)":
            bool(torch.allclose(parts, whole, rtol=RTOL, atol=ATOL)),
        f"m <= bucket {m_bucket}": int(built[-1]) <= m_bucket,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = arguments(__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=30000)
    args = ap.parse_args(argv)
    dev = start(args)
    features, values, verts = inputs(args.points, dev)
    built = build_lattice_device(features, MAP_BUCKET)
    checks = checks_of(features, values, built, MAP_BUCKET)
    lines, derived = [], {}
    if all(checks.values()):
        lines = measure("exp_filter",
                        stages(features, values, verts, built, MAP_BUCKET),
                        args.reps, dev)
        steps = [0.0] + [wall(lines, name) for name in NEIGH]
        derived = {
            **{f"neigh step {k}": steps[k] - steps[k - 1] for k in (1, 2, 3, 4)},
            "splat + blur + slice": sum(
                wall(lines, s) for s in ("splat", "blur (7 passes)", "slice")),
            "filter (whole)": wall(lines, "filter (whole)"),
        }
    return finish("exp_filter", lines, checks, dev, points=args.points,
                  m=int(built[-1]), bucket=MAP_BUCKET, derived_wall_ms=derived)


if __name__ == "__main__":
    raise SystemExit(main())
