"""Depth-adaptive patch resampling: CUDA kernel wrapper (kernel A).

Replaces ``rovinasemanticsegmentation_tpu/ops/patches_pallas.py``
(``_kernel`` via ``extract_patches_pallas``). On a CUDA tensor
:func:`extract_patches` launches ``csrc/patches.cu`` at any stride; on a CPU
tensor it runs the plain version, ``ops/patches.py::extract_patches_plain``.
The two are bit-identical.
"""

from __future__ import annotations

import torch

from ..csrc.build import LaunchCounter, check_launch, load_kernels
from .patches import check_patch_inputs, extract_patches_plain, tap_tensors

launches = LaunchCounter()


def pack_lab(padded_lab: torch.Tensor) -> torch.Tensor:
    """[Hp, Wp, 3] uint8 -> [Hp, Wp] int32 ``c0 | c1 << 8 | c2 << 16``."""
    img = padded_lab.to(torch.int32)
    return (img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)).contiguous()


def extract_patches(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
) -> torch.Tensor:  # [gh, gw, R, R, 3] uint8
    if padded_lab.device.type == "cpu":
        return extract_patches_plain(
            padded_lab, depth_grid, patch_size, reduce_size, stride
        )
    if padded_lab.device.type != "cuda":
        raise ValueError(f"unsupported device {padded_lab.device}")
    check_patch_inputs(padded_lab, depth_grid, patch_size, stride)
    dev = padded_lab.device
    gh, gw = depth_grid.shape
    packed = pack_lab(padded_lab)
    depth = depth_grid.contiguous()
    t0, t1, w0, w1 = tap_tensors(patch_size, reduce_size, dev)
    r = reduce_size
    out = torch.empty((gh, gw, r, r, 3), dtype=torch.uint8, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rovina_patches(
            packed.data_ptr(), packed.shape[0], packed.shape[1],
            depth.data_ptr(), gh, gw,
            t0.data_ptr(), t1.data_ptr(), w0.data_ptr(), w1.data_ptr(),
            patch_size, r, stride, out.data_ptr(), stream,
        )
    check_launch("rovina_patches", err)
    launches.add()
    return out
