"""Bilinear resize with cv::resize(INTER_LINEAR) semantics.

Counterpart of ``rovinasemanticsegmentation_tpu/ops/resize.py``: the float
path brings stride-resolution posterior maps to full resolution
(``test_multi.cpp:199``, ``segmenter.cpp:380-382``); the uint8 fixed-point
path is OpenCV's 8U resize (``feature_extractor.h:142``'s patch reduction).
OpenCV's mapping: ``src = (dst + 0.5) * scale - 0.5`` with the left tap
clamped into the image and its fraction zeroed at both borders.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _tap_coords(
    dst_size: int, src_size: int, device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Left tap, right tap and right-tap fraction (float32) for one axis.
    ``csrc/resize_argmax.cu`` repeats this arithmetic, and the float path's
    roundings below, bit for bit: change them together."""
    scale = torch.tensor(src_size / dst_size, dtype=torch.float32, device=device)
    fx = (torch.arange(dst_size, dtype=torch.float32, device=device) + 0.5) \
        * scale - 0.5
    ix = torch.floor(fx).to(torch.int64)
    frac = fx - ix.to(torch.float32)
    zero = torch.zeros_like(frac)
    frac = torch.where(ix < 0, zero, frac)
    ix = torch.clamp(ix, min=0)
    frac = torch.where(ix >= src_size - 1, zero, frac)
    ix = torch.clamp(ix, max=src_size - 1)
    ix1 = torch.clamp(ix + 1, max=src_size - 1)
    return ix, ix1, frac


def resize_bilinear(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Float bilinear resize of [H, W] or [H, W, C] tensors."""
    h, w = image.shape[0], image.shape[1]
    img = image.to(torch.float32)
    y0, y1, fy = _tap_coords(out_h, h, img.device)
    x0, x1, fx = _tap_coords(out_w, w, img.device)
    tail = (None,) * (img.dim() - 2)
    fy_b = fy[(slice(None), None) + tail]
    fx_b = fx[(None, slice(None)) + tail]
    vert = img[y0] * (1.0 - fy_b) + img[y1] * fy_b
    return vert[:, x0] * (1.0 - fx_b) + vert[:, x1] * fx_b


_COEF_SCALE = 2048  # 1 << INTER_RESIZE_COEF_BITS (11)


def resize_bilinear_u8(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 bilinear resize of [H, W] or [H, W, C] tensors in OpenCV's 8U
    fixed point (``resize.cpp``'s generic path): both taps' weights rounded
    to 1/2048ths independently, the horizontal pass first, then
    ``(acc + 2^21) >> 22``. Integer arithmetic in int32, so every device
    gives the same bytes."""
    h, w = image.shape[0], image.shape[1]
    img = image.to(torch.int32)
    y0, y1, fy = _tap_coords(out_h, h, img.device)
    x0, x1, fx = _tap_coords(out_w, w, img.device)
    wy1 = torch.round(fy * _COEF_SCALE).to(torch.int32)
    wy0 = torch.round((1.0 - fy) * _COEF_SCALE).to(torch.int32)
    wx1 = torch.round(fx * _COEF_SCALE).to(torch.int32)
    wx0 = torch.round((1.0 - fx) * _COEF_SCALE).to(torch.int32)
    tail = (None,) * (img.dim() - 2)
    col = (slice(None), None) + tail
    row = (None, slice(None)) + tail
    horiz = img[:, x0] * wx0[row] + img[:, x1] * wx1[row]
    acc = horiz[y0] * wy0[col] + horiz[y1] * wy1[col]
    return torch.clamp((acc + (1 << 21)) >> 22, 0, 255).to(torch.uint8)
