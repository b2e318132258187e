"""Bilinear resize with cv::resize(INTER_LINEAR) semantics, float path.

Counterpart of ``rovinasemanticsegmentation_tpu/ops/resize.py::resize_bilinear``,
used to bring stride-resolution posterior maps to full resolution
(``test_multi.cpp:199``, ``segmenter.cpp:380-382``). OpenCV's mapping:
``src = (dst + 0.5) * scale - 0.5`` with the left tap clamped into the image
and its fraction zeroed at both borders.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _tap_coords(
    dst_size: int, src_size: int, device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Left tap, right tap and right-tap fraction (float32) for one axis."""
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
