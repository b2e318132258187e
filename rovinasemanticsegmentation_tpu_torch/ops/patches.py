"""Depth-adaptive colour patches: reflect padding, tap tables, plain version.

Counterpart of ``rovinasemanticsegmentation_tpu/ops/patches.py`` (padding and
the gather formulation) and ``ops/patches_scan.py::_tap_tables`` (copied as
numpy: that module imports jax). For every stride-grid point with depth
``d > 0`` the reference (``feature_extractor.h:125-175``) crops a
``(2h+1)``-pixel window, ``h = min(floor(B / (2 d)), B)``, around the pixel
of the reflect-padded Lab image and resizes it to ``R x R`` with OpenCV's
8U ``INTER_LINEAR`` rule: ``src = (dst + 0.5) * scale - 0.5``, border-clamped
taps, weights in 1/2048ths, rounding ``(acc + 2^21) >> 22``.

:func:`extract_patches_plain` is the plain version of the CUDA kernel in
``csrc/patches.cu`` (wrapper: ``ops/patches_cuda.py``), and
:func:`extract_patches_separable_plain` that of ``csrc/patches_planar.cu``
(wrapper: ``ops/patches_planar_cuda.py``); all four read the same tap tables
and are bit-identical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_COEF_SCALE = 2048


def _symmetric_index(n: int, border: int, device) -> torch.Tensor:
    """numpy ``mode="symmetric"`` source index for ``[-border, n + border)``."""
    i = torch.arange(-border, n + border, device=device)
    m = torch.remainder(i, 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def reflect_pad_image(image: torch.Tensor, border: int) -> torch.Tensor:
    """cv::copyMakeBorder BORDER_REFLECT (edge pixel duplicated) on [H, W, ...]."""
    h, w = image.shape[0], image.shape[1]
    rows = _symmetric_index(h, border, image.device)
    cols = _symmetric_index(w, border, image.device)
    return image[rows][:, cols]


@functools.lru_cache(maxsize=None)
def tap_tables(patch_size: int, reduce_size: int):
    """Per-half-size tap offsets and weights, four int32 arrays [B + 1, R].

    The offset is absolute in padded coordinates relative to the grid pixel:
    ``B - h + tap`` (window origin ``pixel - h`` plus the border ``B``). Rows
    and columns share the tables because windows are square. Cached: the
    arrays are read-only.
    """
    nh = patch_size + 1
    r = reduce_size
    t0 = np.zeros((nh, r), np.int32)
    t1 = np.zeros((nh, r), np.int32)
    w0 = np.zeros((nh, r), np.int32)
    w1 = np.zeros((nh, r), np.int32)
    for h in range(nh):
        w = 2 * h + 1
        for j in range(r):
            fx = (j + 0.5) * w / r - 0.5
            sx = int(np.floor(fx))
            frac = fx - sx
            if sx < 0:
                sx, frac = 0, 0.0
            if sx >= w - 1:
                sx, frac = w - 1, 0.0
            sx1 = min(sx + 1, w - 1)
            t0[h, j] = patch_size - h + sx
            t1[h, j] = patch_size - h + sx1
            w0[h, j] = int(round((1 - frac) * _COEF_SCALE))
            w1[h, j] = int(round(frac * _COEF_SCALE))
    for a in (t0, t1, w0, w1):
        a.setflags(write=False)
    return t0, t1, w0, w1


def patch_half_sizes(depth_grid: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Window half-size per grid point (feature_extractor.h:140), -1 if masked."""
    safe = torch.clamp(depth_grid, min=1e-6)
    # Tensor / tensor: a Python number over a tensor becomes
    # reciprocal(x) * n in PyTorch, which rounds twice; the kernel and the
    # reference divide once (IEEE), and floor() exposes the last bit.
    numer = torch.full_like(safe, float(patch_size))
    half = torch.floor(numer / (2.0 * safe)).to(torch.int64)
    half = torch.clamp(half, max=patch_size)
    return torch.where(depth_grid > 0, half, torch.full_like(half, -1))


def check_patch_inputs(
    padded_lab: torch.Tensor, depth_grid: torch.Tensor, patch_size: int,
    stride: int,
) -> None:
    """Shapes and types both versions need; every tap must land in the image."""
    if padded_lab.dtype != torch.uint8 or padded_lab.dim() != 3 \
            or padded_lab.shape[2] != 3:
        raise ValueError(
            f"padded_lab must be [Hp, Wp, 3] uint8, got "
            f"{tuple(padded_lab.shape)} {padded_lab.dtype}"
        )
    if depth_grid.dtype != torch.float32 or depth_grid.dim() != 2:
        raise ValueError(
            f"depth_grid must be [gh, gw] float32, got "
            f"{tuple(depth_grid.shape)} {depth_grid.dtype}"
        )
    if padded_lab.device != depth_grid.device:
        raise ValueError("padded_lab and depth_grid on different devices")
    if stride < 1 or patch_size < 0:
        raise ValueError(f"bad stride {stride} or patch size {patch_size}")
    gh, gw = depth_grid.shape
    need_h = (gh - 1) * stride + 2 * patch_size + 1
    need_w = (gw - 1) * stride + 2 * patch_size + 1
    if padded_lab.shape[0] < need_h or padded_lab.shape[1] < need_w:
        raise ValueError(
            f"padded image {tuple(padded_lab.shape[:2])} too small for a "
            f"{gh}x{gw} grid at stride {stride} and border {patch_size}"
        )


@functools.lru_cache(maxsize=None)
def tap_tensors(patch_size: int, reduce_size: int, device: torch.device):
    """:func:`tap_tables` as int32 tensors on ``device``, uploaded once."""
    return tuple(
        torch.from_numpy(np.array(a)).to(device)
        for a in tap_tables(patch_size, reduce_size)
    )


def extract_patches_plain(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
) -> torch.Tensor:  # [gh, gw, R, R, 3] uint8
    """Gather formulation: four taps per output pixel, exact integer math."""
    check_patch_inputs(padded_lab, depth_grid, patch_size, stride)
    dev = padded_lab.device
    gh, gw = depth_grid.shape
    wp = padded_lab.shape[1]
    t0, t1, w0, w1 = (
        a.long() for a in tap_tensors(patch_size, reduce_size, dev)
    )
    half = patch_half_sizes(depth_grid, patch_size)
    hc = half.clamp(min=0)  # [gh, gw]
    gy = (torch.arange(gh, device=dev) * stride)[:, None, None]
    gx = (torch.arange(gw, device=dev) * stride)[None, :, None]
    ry0, ry1 = gy + t0[hc], gy + t1[hc]  # [gh, gw, R] padded rows (index i)
    cx0, cx1 = gx + t0[hc], gx + t1[hc]  # [gh, gw, R] padded cols (index j)
    wy0, wy1 = w0[hc][..., :, None, None], w1[hc][..., :, None, None]
    wx0, wx1 = w0[hc][..., None, :, None], w1[hc][..., None, :, None]
    flat = padded_lab.reshape(-1, 3).to(torch.int64)

    def tap(rows, cols):  # -> [gh, gw, R, R, 3]
        return flat[rows[..., :, None] * wp + cols[..., None, :]]

    row0 = tap(ry0, cx0) * wx0 + tap(ry0, cx1) * wx1
    row1 = tap(ry1, cx0) * wx0 + tap(ry1, cx1) * wx1
    acc = row0 * wy0 + row1 * wy1
    out = torch.clamp((acc + (1 << 21)) >> 22, 0, 255).to(torch.uint8)
    masked = (half < 0)[..., None, None, None]
    return torch.where(masked, torch.zeros_like(out), out)


def extract_patches_separable_plain(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
) -> torch.Tensor:  # [gh, gw, R, R, 3] uint8
    """Row stage, then column stage, on planar channels (kernel D's order).

    The plain version of ``csrc/patches_planar.cu``: unpack to planar int32,
    ``ri = wy0 img[y0_i, x_k] + wy1 img[y1_i, x_k]`` at the 2R column taps
    ``x_k`` (x0_j, x1_j interleaved), then ``(wx0 ri[x0_j] + wx1 ri[x1_j] +
    2^21) >> 22``. Every sum is exact in int32 (< 255 * 2^22), so it is
    bit-identical to :func:`extract_patches_plain`.
    """
    check_patch_inputs(padded_lab, depth_grid, patch_size, stride)
    dev = padded_lab.device
    gh, gw = depth_grid.shape
    r = reduce_size
    wp = padded_lab.shape[1]
    t0, t1, w0, w1 = tap_tensors(patch_size, r, dev)
    half = patch_half_sizes(depth_grid, patch_size)
    hc = half.clamp(min=0)  # [gh, gw]
    img = padded_lab.permute(2, 0, 1).reshape(3, -1).to(torch.int32)
    gy = (torch.arange(gh, device=dev) * stride)[:, None, None]
    gx = (torch.arange(gw, device=dev) * stride)[None, :, None, None]
    cols = (gx + torch.stack([t0[hc], t1[hc]], dim=-1)).reshape(gh, gw, 2 * r)
    wy0, wy1 = w0[hc][..., :, None], w1[hc][..., :, None]  # [gh, gw, R, 1]

    def rows(oy):  # [gh, gw, R] int32 offsets -> [3, gh, gw, R, 2R]
        idx = (gy + oy.long())[..., :, None] * wp + cols[..., None, :]
        return img[:, idx]

    ri = wy0 * rows(t0[hc]) + wy1 * rows(t1[hc])  # [3, gh, gw, R(i), 2R]
    ri = ri.reshape(3, gh, gw, r, r, 2)
    wx0, wx1 = w0[hc][:, :, None, :], w1[hc][:, :, None, :]  # [gh, gw, 1, R(j)]
    acc = wx0 * ri[..., 0] + wx1 * ri[..., 1]  # [3, gh, gw, R, R]
    out = torch.clamp((acc + (1 << 21)) >> 22, 0, 255).to(torch.uint8)
    out = out.permute(1, 2, 3, 4, 0)
    masked = (half < 0)[..., None, None, None]
    return torch.where(masked, torch.zeros_like(out), out).contiguous()
