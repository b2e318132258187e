"""The least time one NVIDIA H100 could take for the path's work.

The table of peaks and the arithmetic of bytes and operations, frozen here
from the port's ``utils/roofline.py`` so that the yardstick does not move
with the program. A stage's least time is the larger of its bytes (each
input read once, each output written once) over the memory rate and its
operations over the rate of the unit that runs them: float32 operations at
the published 67 TFLOP/s, integer work as 32-bit instructions on the busiest
issue pipe. Every count here comes from the configuration's shapes and from
what the plain reference reads on this data (the forest's paths, the
lattice's vertices), never from how the program lays its data out, so the
same work reads the same whatever implements it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# H100 SXM data sheet at 700 W: HBM3 at 3.35 TB/s, float32 (non-tensor)
# 67 TFLOP/s. Integer work: the FMA pipe (IMUL, IMAD) and the ALU pipe
# (shifts, logic, compares, IADD3) each issue 64 instructions per SM per
# clock (CUDA programming guide, compute capability 9.0), 132 SMs at the
# 1.98 GHz boost clock of the float32 peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
PIPE_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit instructions per output byte of an 8U bilinear resample, by pipe:
# four multiplies and two multiply-adds with the rounding term, one shift.
RESAMPLE_OPS = {"fma": 6, "alu": 1}
# Per (point, tree, level) of a descent: field shift and mask, the compare,
# the child add.
LEVEL_OPS = {"alu": 4}


def least_s(nbytes: float, flops: float = 0.0, pipe_ops: float = 0.0) -> float:
    """The larger of the bytes' time and the operations' time, in s."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S,
               pipe_ops / PIPE_OPS_PER_S)


def patches_bound_s(padded_pixels: int, points: int, valid: int,
                    patch_bytes: int) -> float:
    """Kernel A: the padded 8-bit Lab image (3 B a pixel) and the depth grid
    (4 B a point) read once, every point's patch bytes written once;
    ``RESAMPLE_OPS`` on the busiest pipe per patch byte of a point with
    depth."""
    nbytes = 3 * padded_pixels + 4 * points + patch_bytes * points
    return least_s(nbytes, pipe_ops=max(RESAMPLE_OPS.values()) * patch_bytes * valid)


def descent_bound_s(compared_patch: int, compared_float: int, records: int,
                    leaves: int, points: int, layer_classes: int,
                    levels: int) -> float:
    """Kernel B with the histogram sum: each compared feature once (a patch
    byte, or a float32), each visited node once (an 8-byte record: feature,
    child and threshold), each reached leaf's histograms once, each point's
    posterior written once; ``LEVEL_OPS`` per (point, tree, level)."""
    nbytes = (compared_patch + 4 * compared_float + 8 * records
              + 4 * layer_classes * leaves + 4 * layer_classes * points)
    return least_s(nbytes, pipe_ops=max(LEVEL_OPS.values()) * levels)


def keyframe_stages(h: int, w: int, stride: int, patch: int, reduce: int,
                    classes: int, layers: int, valid: int,
                    descent_s: float) -> List[Tuple[str, float]]:
    """The least time of each stage of one keyframe, in s."""
    gh, gw = -(-h // stride), -(-w // stride)
    p, hw = gh * gw, h * w
    padded = (h + 2 * patch) * (w + 2 * patch)
    pb = 3 * reduce * reduce
    return [
        # Lab: three table reads, a 3x3 integer matrix, three cube-root
        # reads and the scaling per pixel (~25 instructions); the RGB read,
        # the padded Lab written.
        ("lab_pad", least_s(3 * hw + 3 * padded, pipe_ops=25 * hw)),
        ("patches", patches_bound_s(padded, p, valid, pb)),
        # Normals: per pixel the change map (~10), ten chamfer rounds of 8
        # neighbours (~160), gradients and integral images (~30); per grid
        # point the box sums, cross product, norm and angle (~60). Depth
        # read once (uint16), angles written once.
        ("normals", least_s(2 * hw + 4 * p, flops=200 * hw + 60 * p)),
        # Depth and height features: ~10 flops a point, two floats written.
        ("backprojection", least_s(2 * p + 8 * p, flops=10 * p)),
        ("descent", descent_s),
        # Resize and argmax: stride posteriors read, full-resolution
        # posteriors (what fusion reads) and labels written; 6 flops per
        # resized value, one compare per class.
        ("resize_argmax", least_s(4 * classes * p + 4 * classes * hw + layers * hw,
                                  flops=7 * classes * hw)),
    ]


def map_stages(points: int, nodes: int, classes: int, dims: int,
               vertices: int, iterations: int) -> List[Tuple[str, float]]:
    """The least time of each stage of one local map, in s."""
    n, d1, c = points, dims + 1, classes
    return [
        # Fusion: points read, each node's posteriors at the points read,
        # unaries written; ~30 flops of projection and c adds per node.
        ("fusion", least_s(12 * n + 4 * c * n * nodes + 4 * c * n,
                           flops=(30 + c) * n * nodes)),
        # Lattice build: features read; corners, weights and the blur
        # tables written; elevation, rounding and rank ~3 d^2 a point, and a
        # sort of the N (d+1) keys (~2 log2 of their count each).
        ("lattice_build", least_s(4 * dims * n + 8 * d1 * n + 8 * d1 * vertices,
                                  flops=3 * dims * dims * n,
                                  pipe_ops=2 * 18 * d1 * n)),
    ] + [
        # One mean-field iteration: marginals and the lattice's corners and
        # weights read, marginals written; splat and slice 2 flops per
        # (point, corner, class), blur 3 per (axis, vertex, class), the
        # softmax ~5 per value.
        (f"mean_field_{i}", least_s(8 * c * n + 8 * d1 * n + 8 * d1 * vertices,
                                    flops=4 * d1 * c * n + 3 * d1 * c * vertices
                                    + 5 * c * n))
        for i in range(iterations)
    ]


def step_least_s(key_stages: Sequence[Tuple[str, float]],
                 map_stages_: Sequence[Tuple[str, float]],
                 keyframes_per_map: int) -> Dict[str, float]:
    """One keyframe's step: its own stages plus its share of a map."""
    out = dict(key_stages)
    for name, s in map_stages_:
        out[name] = s / keyframes_per_map
    return out
