"""Integral-image surface normals (PCL AVERAGE_3D_GRADIENT), stride grid only.

Counterpart of ``rovinasemanticsegmentation_tpu/ops/normals.py``:
``normal_angles_grid`` with the ``iter`` chamfer. The reference runs
``pcl::IntegralImageNormalEstimation`` (AVERAGE_3D_GRADIENT,
``maxDepthChangeFactor = 0.02``, ``normalSmoothingSize = 10``,
``feature_extractor.h:254-262``) and keeps only ``acos(|n_z|)``, NaN -> -2
(``feature_extractor.h:275-284``):

1. central-difference 3D gradients ``p(x+1) - p(x-1)`` and ``p(y+1) - p(y-1)``;
2. a depth-change map: right/lower neighbour pairs with
   ``|dz| > 0.02 * (|z| + 1) * 2`` or a non-finite depth mark both pixels;
3. a chamfer distance (axial 1.0, diagonal 1.4) to the nearest change,
   saturated at the smoothing size;
4. ``smoothing = min(distance, 10)``; the averaging window is
   ``rect = int(smoothing)`` wide, ``[pos - rect/2, pos - rect/2 + rect)``;
   pixels with ``smoothing <= 2``, non-finite depth, or inside the
   ``int(10)``-pixel border frame are invalid;
5. box sums of both gradients (and of their validity) from integral images,
   read at the grid pixels only;
6. ``normal = cross(sum_gy, sum_gx)``.

The integral images are float32 prefix sums; their summation order differs
from XLA's, so angles agree with the reference package to about 1e-4 rad.
"""

from __future__ import annotations

import math

import torch


def _shift_nan(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[y, x] = a[y - dy, x - dx]`` over the last two axes, NaN outside."""
    out = torch.roll(a, shifts=(dy, dx), dims=(-2, -1))
    h, w = a.shape[-2], a.shape[-1]
    ys = torch.arange(h, device=a.device)[:, None]
    xs = torch.arange(w, device=a.device)[None, :]
    bad = (ys - dy < 0) | (ys - dy >= h) | (xs - dx < 0) | (xs - dx >= w)
    return torch.where(bad, torch.full_like(out, float("nan")), out)


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


def normal_angles_grid(
    points: torch.Tensor,  # [H, W, 3] float32, NaN where invalid
    stride: int,
    max_depth_change_factor: float = 0.02,
    normal_smoothing_size: float = 10.0,
) -> torch.Tensor:  # [ceil(H/s), ceil(W/s)] float32 angles, -2 where invalid
    if float(normal_smoothing_size) != int(normal_smoothing_size):
        raise NotImplementedError(
            "only integral normal_smoothing_size is ported (the reference's "
            "non-integral sizes take an exact full-height chamfer scan)"
        )
    dev = points.device
    h, w = points.shape[0], points.shape[1]
    s = int(stride)
    z = points[..., 2]
    invalid = torch.isnan(z)
    ys_full = torch.arange(h, device=dev)[:, None]
    xs_full = torch.arange(w, device=dev)[None, :]

    # Depth-change map: pairs (x, x+1) and (y, y+1) inside the image.
    thresh = max_depth_change_factor * (torch.abs(z) + 1.0) * 2.0
    z_r = _shift_nan(z, 0, -1)
    z_d = _shift_nan(z, -1, 0)
    change_x = (xs_full < w - 1) & (
        invalid | torch.isnan(z_r) | (torch.abs(z - z_r) > thresh)
    )
    change_y = (ys_full < h - 1) & (
        invalid | torch.isnan(z_d) | (torch.abs(z - z_d) > thresh)
    )
    change = (
        change_x
        | change_y
        | torch.roll(change_x, 1, dims=1)
        | torch.roll(change_y, 1, dims=0)
    )
    distance = _chamfer_iter(change, normal_smoothing_size)

    border = int(normal_smoothing_size)
    rect_max = int(normal_smoothing_size)  # rects take values 2..rect_max
    smoothing = torch.clamp(distance[::s, ::s], max=normal_smoothing_size)
    invalid_g = invalid[::s, ::s]
    rect = smoothing.to(torch.int32)  # int() truncation
    gh, gw = rect.shape

    # Channel-leading [8, H, W]: grad_x (3), grad_y (3), valid_x, valid_y.
    pts_t = points.permute(2, 0, 1)
    gx_t = _shift_nan(pts_t, 0, -1) - _shift_nan(pts_t, 0, 1)
    gy_t = _shift_nan(pts_t, -1, 0) - _shift_nan(pts_t, 1, 0)
    stack = torch.cat(
        [
            torch.nan_to_num(gx_t),
            torch.nan_to_num(gy_t),
            (~torch.isnan(gx_t[0]))[None].to(torch.float32),
            (~torch.isnan(gy_t[0]))[None].to(torch.float32),
        ],
        dim=0,
    )
    integ = torch.cumsum(torch.cumsum(stack, dim=1), dim=2)
    integ = torch.nn.functional.pad(integ, (1, 0, 1, 0))  # [8, H+1, W+1]
    gys = torch.arange(gh, device=dev) * s
    gxs = torch.arange(gw, device=dev) * s

    def corner(dy: int, dx: int) -> torch.Tensor:  # [8, gh, gw]
        yi = torch.clamp(gys + dy, 0, h)
        xi = torch.clamp(gxs + dx, 0, w)
        return integ[:, yi][:, :, xi]

    acc = torch.zeros((8, gh, gw), dtype=torch.float32, device=dev)
    for r in range(2, rect_max + 1):
        d0 = -(r // 2)
        d1 = d0 + r  # exclusive end -> integral corner offset
        box = corner(d1, d1) - corner(d0, d1) - corner(d1, d0) + corner(d0, d0)
        acc = torch.where((rect == r)[None], box, acc)
    sum_gx = acc[0:3].permute(1, 2, 0)
    sum_gy = acc[3:6].permute(1, 2, 0)
    cnt_x, cnt_y = acc[6], acc[7]
    ys_g = gys[:, None]
    xs_g = gxs[None, :]

    normal = torch.linalg.cross(sum_gy, sum_gx, dim=-1)
    norm = torch.linalg.vector_norm(normal, dim=-1)
    ok = (
        (smoothing > 2.0)  # PCL's minimum-window gate
        & ~invalid_g
        & (cnt_x > 0)
        & (cnt_y > 0)
        & (norm > 0)
        & (ys_g >= border)
        & (ys_g < h - border)
        & (xs_g >= border)
        & (xs_g < w - border)
    )
    nz = torch.abs(normal[..., 2]) / torch.clamp(norm, min=1e-20)
    angle = torch.arccos(torch.clamp(nz, 0.0, 1.0))
    return torch.where(ok, angle, torch.full_like(angle, -2.0))
