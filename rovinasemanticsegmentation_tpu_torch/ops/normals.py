"""Integral-image surface normals (PCL AVERAGE_3D_GRADIENT).

Counterpart of ``rovinasemanticsegmentation_tpu/ops/normals.py``:
:func:`normal_angles` at full resolution, :func:`normal_angles_grid` at the
stride-grid samples, and :func:`chamfer_distance_map`. The reference runs
``pcl::IntegralImageNormalEstimation`` (AVERAGE_3D_GRADIENT,
``maxDepthChangeFactor = 0.02``, ``normalSmoothingSize = 10``,
``feature_extractor.h:254-262``) and keeps only ``acos(|n_z|)``, NaN -> -2
(``feature_extractor.h:275-284``):

1. central-difference 3D gradients ``p(x+1) - p(x-1)`` and ``p(y+1) - p(y-1)``;
2. a depth-change map: right/lower neighbour pairs with
   ``|dz| > 0.02 * (|z| + 1) * 2`` or a non-finite depth mark both pixels;
3. a chamfer distance (axial 1.0, diagonal 1.4) to the nearest change:
   saturated at the smoothing size for integral sizes, the exact two-pass
   scan otherwise;
4. ``smoothing = min(distance, size)``; the averaging window is
   ``rect = int(smoothing)`` wide, ``[pos - rect/2, pos - rect/2 + rect)``;
   pixels with ``smoothing <= 2``, non-finite depth, or inside the
   ``int(size)``-pixel border frame are invalid;
5. box sums of both gradients (and of their validity) from integral images;
6. ``normal = cross(sum_gy, sum_gx)``.

The gradients, integral images, box sums, cross product and ``acos`` run in
float64, as PCL's own integral images do
(``IntegralImageTypeTraits<float>::IntegralType`` is ``double``); only the
angle is rounded to float32. A float32 running total over a VGA frame carries
a relative error of ~3e-4 into a 10x10 box sum, and ``acos`` near 1 turns
that into ~0.02 rad: the JAX package's float32 function is up to 0.016 rad
from its own float64 run on the recipe's VGA frames, on 1.0-1.7% of the
valid grid points beyond 2e-3 rad. In float64 the angles are within one
float32 rounding of that run, and a parallel scan on the card rounds the same
way as a sequential one on the CPU.

On a CUDA tensor, :func:`normal_angles_grid` at an integral smoothing size up
to ``ops/normals_cuda.py::MAX_SIZE`` runs as three kernel launches
(``csrc/normals.cu``), bit-equal to the PyTorch operators below on the card;
they stay the CPU path and the kernels' yardstick.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import normals_cuda


def _shift_nan(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[y, x] = a[y - dy, x - dx]`` over the last two axes, NaN outside."""
    out = torch.roll(a, shifts=(dy, dx), dims=(-2, -1))
    h, w = a.shape[-2], a.shape[-1]
    ys = torch.arange(h, device=a.device)[:, None]
    xs = torch.arange(w, device=a.device)[None, :]
    bad = (ys - dy < 0) | (ys - dy >= h) | (xs - dx < 0) | (xs - dx >= w)
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def _row_chain_min(cand: torch.Tensor, reverse: bool) -> torch.Tensor:
    """In-row relaxation by +1.0 steps, ``out[x] = min_{j<=x} cand[j] + (x - j)``
    (right to left with ``reverse``): PCL's sequential
    ``cur[x] = min(base[x], cur[x-1] + 1)`` as a cumulative minimum."""
    if reverse:
        return torch.flip(_row_chain_min(torch.flip(cand, (-1,)), False), (-1,))
    x = torch.arange(cand.shape[-1], dtype=cand.dtype, device=cand.device)
    return torch.cummin(cand - x, dim=-1).values + x


def _chamfer_passes(d0: torch.Tensor, big: float) -> torch.Tensor:
    """PCL's two restricted chamfer passes over an [R, W] seed, one row at a
    time. Columns 0 and w-1 are never relaxed (PCL loops x in [1, w-2]); the
    first row is only touched by the backward pass, the last only by the
    forward pass."""
    r, w = d0.shape
    cols = torch.arange(w, device=d0.device)
    inner = (cols >= 1) & (cols <= w - 2)
    edge = torch.full((1,), big, dtype=d0.dtype, device=d0.device)

    def relax(prev: torch.Tensor, cur0: torch.Tensor, reverse: bool) -> torch.Tensor:
        left = torch.cat([edge, prev[:-1]])  # prev[x - 1]
        right = torch.cat([prev[1:], edge])  # prev[x + 1]
        vert = torch.minimum(prev + 1.0, torch.minimum(left + 1.4, right + 1.4))
        base = torch.minimum(cur0, vert)
        feed = cols == (w - 1 if reverse else 0)
        cand = torch.where(inner, base, torch.where(feed, cur0, big))
        chained = _row_chain_min(cand, reverse)
        return torch.where(inner, torch.minimum(base, chained), cur0)

    rows = [d0[0]]
    for i in range(1, r):
        rows.append(relax(rows[-1], d0[i], False))
    out = [rows[-1]]
    for i in range(r - 2, -1, -1):
        out.append(relax(out[-1], rows[i], True))
    return torch.stack(out[::-1])


def _chamfer_iter(change: torch.Tensor, saturation: float) -> torch.Tensor:
    """Saturated chamfer by ``ceil(s)`` rounds of 3x3 min-plus relaxation.

    Only values below ``s`` at pixels at least ``ceil(s)`` from every edge
    are consumed, and each path of cost below ``s`` has at most ``ceil(s) - 1``
    steps, so ``ceil(s)`` rounds resolve them exactly. Columns 0 and w-1 are
    re-pinned to their seed every round, as PCL's restricted passes never
    relax them.
    """
    h, w = change.shape
    sat = float(saturation)
    seed = torch.where(
        change,
        torch.zeros((), dtype=torch.float32, device=change.device),
        torch.full((), sat, dtype=torch.float32, device=change.device),
    )
    cols = torch.arange(w, device=change.device)
    edge_col = ((cols == 0) | (cols == w - 1))[None, :]

    def shifted(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
        # Out-of-image neighbours count as >= sat (they never win).
        out = torch.roll(a, shifts=(dy, dx), dims=(0, 1))
        if dy:
            out[0 if dy > 0 else h - 1] = sat
        if dx:
            out[:, 0 if dx > 0 else w - 1] = sat
        return out

    d = seed
    for _ in range(int(math.ceil(sat))):
        relaxed = torch.minimum(
            torch.minimum(
                torch.minimum(shifted(d, 0, 1), shifted(d, 0, -1)),
                torch.minimum(shifted(d, 1, 0), shifted(d, -1, 0)),
            )
            + 1.0,
            torch.minimum(
                torch.minimum(shifted(d, 1, 1), shifted(d, 1, -1)),
                torch.minimum(shifted(d, -1, 1), shifted(d, -1, -1)),
            )
            + 1.4,
        )
        d = torch.where(edge_col, seed, torch.minimum(d, relaxed))
    return d


def chamfer_distance_map(
    change: torch.Tensor,  # [H, W] bool
    saturation: Optional[float] = None,
    variant: str = "iter",
) -> torch.Tensor:  # [H, W] float32
    """PCL's two-pass chamfer (1.0/1.4) distance to the change pixels.

    ``saturation=None`` runs the exact sequential passes. With
    ``saturation=s`` only values below ``s`` outside an ``int(s)`` border
    frame are exact (the consumer clamps at ``s``), which the ``"iter"``
    variant computes in ``ceil(s)`` parallel rounds. The JAX package's
    ``"banded"`` variant is not part of the port.
    """
    if saturation is None:
        h, w = change.shape
        big = float(h + w)
        d0 = torch.where(
            change,
            torch.zeros((), dtype=torch.float32, device=change.device),
            torch.full((), big, dtype=torch.float32, device=change.device),
        )
        return _chamfer_passes(d0, big)
    if variant != "iter":
        raise ValueError(f"chamfer variant {variant!r}: the port has 'iter' only")
    return _chamfer_iter(change, saturation)


def normal_angles(
    points: torch.Tensor,  # [H, W, 3] float32, NaN where invalid
    max_depth_change_factor: float = 0.02,
    normal_smoothing_size: float = 10.0,
) -> torch.Tensor:  # [H, W] float32 angles, -2 where invalid
    """Angles at every pixel (see :func:`normal_angles_grid`)."""
    return _normal_angles(points, None, max_depth_change_factor,
                          normal_smoothing_size)


def normal_angles_grid(
    points: torch.Tensor,  # [H, W, 3] float32, NaN where invalid
    stride: int,
    max_depth_change_factor: float = 0.02,
    normal_smoothing_size: float = 10.0,
) -> torch.Tensor:  # [ceil(H/s), ceil(W/s)] float32 angles, -2 where invalid
    """Angles at the stride-grid samples only: the integral images and the
    distance transform run at full resolution (their windows span full-res
    data), the box sums and everything per point at the grid pixels. The
    kernels take it where ``normals_cuda.engages``."""
    if normals_cuda.engages(points.device, normal_smoothing_size):
        return normals_cuda.normal_angles_grid(
            points, int(stride), max_depth_change_factor,
            normal_smoothing_size)
    return _normal_angles(points, int(stride), max_depth_change_factor,
                          normal_smoothing_size)


def _normal_angles(points, stride: Optional[int], max_depth_change_factor,
                   normal_smoothing_size) -> torch.Tensor:
    z = points[..., 2]
    change = _depth_change_map(z, max_depth_change_factor)
    # Integral sizes take the saturated chamfer (its border agrees with the
    # consumer's int(size) frame); other sizes the exact full-height scan.
    integral_size = float(normal_smoothing_size) == int(normal_smoothing_size)
    distance = chamfer_distance_map(
        change, saturation=normal_smoothing_size if integral_size else None)
    integ = _gradient_integral(points)
    return _box_normals(integ, distance, torch.isnan(z), stride,
                        normal_smoothing_size)


def _depth_change_map(z: torch.Tensor, max_depth_change_factor) -> torch.Tensor:
    """[H, W] bool: pixels of a right or lower neighbour pair inside the
    image whose depth jumps, or where either depth is missing."""
    dev = z.device
    h, w = z.shape
    invalid = torch.isnan(z)
    ys_full = torch.arange(h, device=dev)[:, None]
    xs_full = torch.arange(w, device=dev)[None, :]
    thresh = max_depth_change_factor * (torch.abs(z) + 1.0) * 2.0
    z_r = _shift_nan(z, 0, -1)
    z_d = _shift_nan(z, -1, 0)
    change_x = (xs_full < w - 1) & (
        invalid | torch.isnan(z_r) | (torch.abs(z - z_r) > thresh)
    )
    change_y = (ys_full < h - 1) & (
        invalid | torch.isnan(z_d) | (torch.abs(z - z_d) > thresh)
    )
    return (
        change_x
        | change_y
        | torch.roll(change_x, 1, dims=1)
        | torch.roll(change_y, 1, dims=0)
    )


def _gradient_integral(points: torch.Tensor) -> torch.Tensor:
    """The zero-padded float64 integral image [8, H+1, W+1] of the
    channel-leading stack grad_x (3), grad_y (3), valid_x, valid_y."""
    pts_t = points.permute(2, 0, 1).double()
    gx_t = _shift_nan(pts_t, 0, -1) - _shift_nan(pts_t, 0, 1)
    gy_t = _shift_nan(pts_t, -1, 0) - _shift_nan(pts_t, 1, 0)
    stack = torch.cat(
        [
            torch.nan_to_num(gx_t),
            torch.nan_to_num(gy_t),
            (~torch.isnan(gx_t[0]))[None].double(),
            (~torch.isnan(gy_t[0]))[None].double(),
        ],
        dim=0,
    )
    integ = torch.cumsum(torch.cumsum(stack, dim=1), dim=2)
    return torch.nn.functional.pad(integ, (1, 0, 1, 0))


def _box_normals(integ, distance, invalid, stride: Optional[int],
                 normal_smoothing_size) -> torch.Tensor:
    """Box sums of the integral image over each sample's own smoothing window
    (at the stride-grid samples, or everywhere with ``stride=None``), their
    cross product, and the angle, -2 where invalid."""
    dev = integ.device
    h, w = distance.shape
    border = int(normal_smoothing_size)
    s = 1 if stride is None else stride
    smoothing = torch.clamp(distance[::s, ::s], max=normal_smoothing_size)
    invalid = invalid[::s, ::s]
    ys = (torch.arange(smoothing.shape[0], device=dev) * s)[:, None]
    xs = (torch.arange(smoothing.shape[1], device=dev) * s)[None, :]
    # The window [pos - rect/2, pos - rect/2 + rect) as corners of the
    # zero-padded integral image. Where rect < 2 the box is no window, and
    # the smoothing > 2 gate below masks it.
    rect = smoothing.to(torch.int64)  # int() truncation
    r2 = rect // 2
    y0, y1 = torch.clamp(ys - r2, 0, h), torch.clamp(ys - r2 + rect, 0, h)
    x0, x1 = torch.clamp(xs - r2, 0, w), torch.clamp(xs - r2 + rect, 0, w)
    flat = integ.reshape(8, -1)

    def at(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:  # [8, gh, gw]
        return flat[:, yi * (w + 1) + xi]

    acc = at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)
    sum_gx = acc[0:3].permute(1, 2, 0)
    sum_gy = acc[3:6].permute(1, 2, 0)
    cnt_x, cnt_y = acc[6], acc[7]
    normal = torch.linalg.cross(sum_gy, sum_gx, dim=-1)
    norm = torch.linalg.vector_norm(normal, dim=-1)
    ok = (
        (smoothing > 2.0)  # PCL's minimum-window gate
        & ~invalid
        & (cnt_x > 0)
        & (cnt_y > 0)
        & (norm > 0)
        & (ys >= border)
        & (ys < h - border)
        & (xs >= border)
        & (xs < w - border)
    )
    nz = torch.abs(normal[..., 2]) / torch.clamp(norm, min=1e-20)
    angle = torch.arccos(torch.clamp(nz, 0.0, 1.0)).float()
    return torch.where(ok, angle, torch.full_like(angle, -2.0))
