"""Stage split of the device lattice build on the card.

Usage (from the repository root; on the card unless ``--device cpu``):

    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_lattice \
        [--points 30000] [--reps 3] [--device cuda|cpu]

The port's counterpart of ``scripts/exp_lattice.py``. The features are the
CRF features ``[xyz * 0.5 ; rgb * 4]`` (d = 6) of the bench's map
(``bench.py::make_workload``, ``--points`` points, the JAX script's
``EL_N``); call i builds over them plus ``i * 1e-5``. Stages, cumulative:

  embed   ``_embed_simplex``: elevation, rounding, rank, barycentric weights
  dedup   + the key pack and the vertex dedup by a key sort
          (``_pack_keys16``, ``_dedup_sorted``)
  full    the plain build (``_build_device_plain``): + the blur neighbours
          (``_blur_neighbors_sort``)
  kernels on the card only: ``build_lattice_device``, which takes the
          lattice-build kernels there (``csrc/lattice_build.cu``)

The summary gives the phases as differences of the wall slopes (dedup -
embed, full - dedup), the kernels' speed-up over the plain build on the
card, the vertex count m and the bucket (``stage_timing.MAP_BUCKET``, the
port's; the JAX script's is twice that). Checks: the stages composed (the
plain build) equal ``build_lattice_device`` bit for bit, and m fits the
bucket. The JAX script's ``hash`` variant (retired with
``_blur_neighbors_hash``; on the card the kernels' table is its successor)
and its tuning record are not ported. Timing method: ``stage_timing``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.lattice import (
    _blur_neighbors_sort,
    _build_device_plain,
    _dedup_sorted,
    _embed_simplex,
    _pack_keys16,
    build_lattice_device,
)
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


def dedup(features: torch.Tensor, m_bucket: int):
    """Embed, pack and dedup: -> (``_dedup_sorted``'s nine results, the
    barycentric weights [N, d+1])."""
    n, d = features.shape
    s = n * (d + 1)
    keys, bary, _, _ = _embed_simplex(features)
    kflat = keys.reshape(s, d)
    packs = _pack_keys16([kflat[:, i] for i in range(d)], d)
    return _dedup_sorted(packs, bary, n, d, m_bucket, -(-s // 128) * 128), bary


def chain(features: torch.Tensor, m_bucket: int):
    """The stages composed: ``build_lattice_device``'s nine results."""
    (sp, sw, ss, se, offsets_t, m, uq, ucoord, _), bary = dedup(
        features, m_bucket)
    n1, n2 = _blur_neighbors_sort(uq, ucoord, m, m_bucket, features.shape[1])
    return sp, sw, ss, se, offsets_t, bary.T.contiguous(), n1, n2, m


def stages(features: torch.Tensor, m_bucket: int) -> List[Stage]:
    def perturbed(i):
        return (features + i * 1e-5,)

    out = [
        Stage("embed", perturbed, _embed_simplex, (K1, K2)),
        Stage("dedup", perturbed, lambda f: dedup(f, m_bucket), (K1, K2)),
        Stage("full", perturbed,
              lambda f: _build_device_plain(f, m_bucket)[:9], (K1, K2)),
    ]
    if features.is_cuda:
        out.append(Stage("kernels", perturbed,
                         lambda f: build_lattice_device(f, m_bucket), (K1, K2)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = arguments(__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=30000)
    args = ap.parse_args(argv)
    dev = start(args)
    features = map_features(args.points, dev)
    built = build_lattice_device(features, MAP_BUCKET)
    m = int(built[-1])
    checks = {
        "stages composed == build_lattice_device":
            same(chain(features, MAP_BUCKET), built),
        f"m <= bucket {MAP_BUCKET}": m <= MAP_BUCKET,
    }
    lines, phases = [], {}
    if all(checks.values()):
        lines = measure("exp_lattice", stages(features, MAP_BUCKET),
                        args.reps, dev)
        phases = {"dedup - embed": wall(lines, "dedup") - wall(lines, "embed"),
                  "full - dedup": wall(lines, "full") - wall(lines, "dedup")}
        if features.is_cuda:
            phases["full / kernels"] = wall(lines, "full") / wall(lines, "kernels")
    return finish("exp_lattice", lines, checks, dev, points=args.points, m=m,
                  bucket=MAP_BUCKET, phase_wall_ms=phases)


if __name__ == "__main__":
    raise SystemExit(main())
