"""8-bit Lab conversion, bit-exact with OpenCV's fixed-point BGR2Lab.

Counterpart of ``rovinasemanticsegmentation_tpu/ops/color.py`` (gather path
only). The reference converts keyframes with ``cv::cvtColor(.., CV_BGR2Lab)``
on RGB-ordered 8-bit images (``feature_extractor.h:129`` on the RGB image of
``train.cpp:123``), so red and blue swap roles. OpenCV's 8U pipeline
(``color_lab.cpp``) is a 256-entry sRGB-gamma table scaled by ``255 << 3``, a
12-bit integer XYZ matrix with the white point folded in, a 3072-entry cube
root table scaled by ``1 << 15``, and ``CV_DESCALE`` round-half-up shifts.
The tables are built in float32 as OpenCV builds them (copied from the
reference package, whose module imports jax).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_LAB_SHIFT = 12  # color_lab.cpp lab_shift
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT

# OpenCV D65 RGB->XYZ matrix (modules/imgproc/src/color_lab.cpp).
_XYZ_FROM_RGB = np.array(
    [
        (0.412453, 0.357580, 0.180423),
        (0.212671, 0.715160, 0.072169),
        (0.019334, 0.119193, 0.950227),
    ]
)
_D65 = np.array([0.950456, 1.0, 1.088754])


def _build_tables():
    """OpenCV initLabTabs() in float32 (softfloat single precision)."""
    f255 = np.float32(255.0)
    i = (np.arange(256, dtype=np.float32) / f255).astype(np.float32)
    thresh = np.float32(809.0 / 20000.0)  # 0.04045 as OpenCV spells it
    lo = (i / np.float32(12.92)).astype(np.float32)
    hi = np.power(
        (i + np.float32(0.055)) / np.float32(1.055), np.float32(2.4),
        dtype=np.float32,
    )
    gamma = np.rint(np.float32(255 << _GAMMA_SHIFT) * np.where(i <= thresh, lo, hi))

    n = (255 * 3 // 2 + 1) * (1 << _GAMMA_SHIFT)  # 3072
    x = (np.arange(n, dtype=np.float32) / np.float32(255 << _GAMMA_SHIFT)).astype(
        np.float32
    )
    flo = (x * np.float32(7.787) + np.float32(16.0 / 116.0)).astype(np.float32)
    fhi = np.cbrt(x, dtype=np.float32)
    cbrt = np.rint(
        np.float32(1 << _LAB_SHIFT2)
        * np.where(x < np.float32(0.008856), flo, fhi)
    )

    coeffs = np.zeros((3, 3), np.int32)
    for row in range(3):
        for col in range(3):
            coeffs[row, col] = np.rint(
                (1 << _LAB_SHIFT)
                * np.float32(
                    np.float32(_XYZ_FROM_RGB[row, col]) / np.float32(_D65[row])
                )
            )
    return gamma.astype(np.int32), cbrt.astype(np.int32), coeffs


_GAMMA_TAB, _CBRT_TAB, _COEFFS = _build_tables()
_L_SCALE = (116 * 255 + 50) // 100
_L_SHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    return (
        torch.from_numpy(_GAMMA_TAB).to(device),
        torch.from_numpy(_CBRT_TAB).to(device),
    )


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    """CV_DESCALE: round-half-up arithmetic shift."""
    return (v + (1 << (n - 1))) >> n


def rgb_to_lab8(image: torch.Tensor, swap: bool = True) -> torch.Tensor:
    """[..., 3] uint8 -> [..., 3] uint8 Lab (L*255/100, a+128, b+128).

    With ``swap=True`` channel 0 goes to OpenCV's blue slot, reproducing the
    reference's BGR2Lab-on-RGB behaviour. Bit-exact with
    ``cv2.cvtColor(..., COLOR_BGR2Lab)``.
    """
    gamma, cbrt = _device_tables(image.device)
    idx = image.to(torch.int64)
    if swap:
        b8, g8, r8 = idx[..., 0], idx[..., 1], idx[..., 2]
    else:
        r8, g8, b8 = idx[..., 0], idx[..., 1], idx[..., 2]
    r, g, b = gamma[r8], gamma[g8], gamma[b8]  # int32

    c = _COEFFS.tolist()

    def take_cbrt(v: torch.Tensor) -> torch.Tensor:
        return cbrt[v.to(torch.int64)]

    fx = take_cbrt(_descale(r * c[0][0] + g * c[0][1] + b * c[0][2], _LAB_SHIFT))
    fy = take_cbrt(_descale(r * c[1][0] + g * c[1][1] + b * c[1][2], _LAB_SHIFT))
    fz = take_cbrt(_descale(r * c[2][0] + g * c[2][1] + b * c[2][2], _LAB_SHIFT))

    l_val = _descale(_L_SCALE * fy + _L_SHIFT, _LAB_SHIFT2)
    a_val = _descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    b_val = _descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    out = torch.stack([l_val, a_val, b_val], dim=-1)
    return torch.clamp(out, 0, 255).to(torch.uint8)
