"""Calibrated backprojection of depth images to world coordinates.

Counterpart of ``rovinasemanticsegmentation_tpu/ops/geometry.py``: build
``[d*x, d*y, d]`` per pixel (depth in metres), map it through ``R @ K^-1`` and
add ``t`` (``feature_extractor.h:200-232``, ``segmenter.cpp:466-488``);
pixels with depth outside ``[d_min, d_max]`` become NaN.

The 3x3 transforms are written as float32 multiply-adds, not matmuls, so no
TF32 or reduced-precision path can reach them: world coordinates must stay
float32 (the reference pins ``precision=HIGHEST`` for the same reason).
"""

from __future__ import annotations

import torch


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def backproject(
    depth_mm: torch.Tensor,  # [H, W] depth in millimetres (any real dtype)
    intrinsic_inverse,  # [3, 3]
    rotation,  # [3, 3]
    translation,  # [3]
    d_min,  # metres
    d_max,  # metres
) -> torch.Tensor:  # [H, W, 3] float32 world coordinates, NaN where invalid
    dev = depth_mm.device
    h, w = depth_mm.shape
    kinv = _f32(intrinsic_inverse, dev)
    rot = _f32(rotation, dev)
    t = _f32(translation, dev)
    depth = millimetres_to_metres(depth_mm)  # feature_extractor.h:209
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    # Strict range on the cloud path (feature_extractor.h:210).
    valid = (depth >= _f32(d_min, dev)) & (depth <= _f32(d_max, dev))
    pix = (depth * xs, depth * ys, depth)
    m = (rot[:, :, None] * kinv[None, :, :]).sum(dim=1)  # R @ K^-1
    world = [
        pix[0] * m[c, 0] + pix[1] * m[c, 1] + pix[2] * m[c, 2] + t[c]
        for c in range(3)
    ]
    out = torch.stack(world, dim=-1)
    return torch.where(valid[..., None], out, torch.full_like(out, float("nan")))


def millimetres_to_metres(depth_mm: torch.Tensor) -> torch.Tensor:
    """``depth / 1000`` as the reference computes it: XLA compiles a float32
    division by a constant into a multiply by the float32 reciprocal, and the
    patch window size ``floor(B / (2 d))`` depends on the last bit of ``d``.
    """
    return depth_mm.to(torch.float32) * 0.001


def depth_valid_mask(depth_mm: torch.Tensor, d_min, d_max) -> torch.Tensor:
    """Point-selection mask in millimetres (feature_extractor.h:43-62).

    ``d_min`` and ``d_max`` are scaled to millimetres in float32, as the
    reference does on its float32 scalars.
    """
    d = depth_mm.to(torch.float32)
    lo = _f32(d_min, d.device) * 1000.0
    hi = _f32(d_max, d.device) * 1000.0
    return (d >= lo) & (d <= hi)
