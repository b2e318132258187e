"""Depth-adaptive patch resampling: CUDA kernel wrapper (kernel A).

Replaces ``rovinasemanticsegmentation_tpu/ops/patches_pallas.py``
(``_kernel`` via ``extract_patches_pallas``). The kernel writes each grid
point's ``R*R*3`` bytes at the start of an output row and zeros the rest of
the row:

- :func:`extract_patches` returns the ``[gh, gw, R, R, 3]`` patch tensor
  (rows of ``R*R*3`` bytes);
- :func:`extract_patches_into` writes a frame's patches into rows
  ``[row0, row0 + gh*gw)`` of a packed feature-row buffer
  (``ops/feature_rows.py``), whose float32 tail is written afterwards.

On a CUDA tensor both pack the padded Lab image into int32
(:func:`pack_lab`, one launch of ``pack_lab_kernel``) and launch
``csrc/patches.cu`` at any stride; on a CPU tensor they run the plain
versions (``ops/patches.py::extract_patches_plain``, :func:`pack_lab_plain`).
Kernel and plain version are bit-identical.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..csrc.build import LaunchCounter, check_launch, load_kernels
from .patches import check_patch_inputs, extract_patches_plain, tap_tensors

launches = LaunchCounter()
pack_launches = LaunchCounter()


def pack_lab_plain(padded_lab: torch.Tensor) -> torch.Tensor:
    """[Hp, Wp, 3] uint8 -> [Hp, Wp] int32 ``c0 | c1 << 8 | c2 << 16``."""
    img = padded_lab.to(torch.int32)
    return (img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)).contiguous()


def pack_launcher(
    padded_lab: torch.Tensor,
) -> Tuple[Callable[[], None], torch.Tensor]:
    """``pack_lab_kernel`` on a CUDA tensor, split in two: allocate the
    output now, and return the function that launches the kernel (and counts
    the launch) with that output, so that the launch alone can be timed."""
    hp, wp, _ = padded_lab.shape
    if hp * wp >= 2**31:
        raise ValueError("the kernel's int32 pixel offsets need Hp * Wp < 2^31")
    lab = padded_lab.contiguous()
    out = torch.empty((hp, wp), dtype=torch.int32, device=lab.device)
    lib = load_kernels()

    def launch() -> None:
        with torch.cuda.device(lab.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_pack_lab(lab.data_ptr(), hp * wp, out.data_ptr(),
                                      stream)
        check_launch("rovina_pack_lab", err)
        pack_launches.add()

    return launch, out


def pack_lab(padded_lab: torch.Tensor) -> torch.Tensor:
    """:func:`pack_lab_plain` in one kernel launch on a CUDA tensor."""
    if padded_lab.device.type == "cpu":
        return pack_lab_plain(padded_lab)
    if padded_lab.device.type != "cuda":
        raise ValueError(f"unsupported device {padded_lab.device}")
    launch, out = pack_launcher(padded_lab)
    launch()
    return out


def launcher(padded_lab, depth_grid, patch_size, reduce_size, stride, out,
             row0: int, row_bytes: int) -> Callable[[], None]:
    """Kernel A on CUDA tensors, split in two: pack the image and make the
    tap tables now, and return the function that launches the kernel (and
    counts the launch), so that the launch alone can be timed."""
    dev = padded_lab.device
    gh, gw = depth_grid.shape
    if gh * gw >= 2**31 or padded_lab.shape[0] * padded_lab.shape[1] >= 2**31:
        raise ValueError("the kernel's int32 offsets need fewer than 2^31 "
                         "grid points and pixels")
    packed = pack_lab(padded_lab)
    depth = depth_grid.contiguous()
    t0, t1, w0, w1 = tap_tensors(patch_size, reduce_size, dev)
    lib = load_kernels()

    def launch() -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_patches(
                packed.data_ptr(), packed.shape[1], depth.data_ptr(), gh, gw,
                t0.data_ptr(), t1.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                patch_size, reduce_size, stride, out.data_ptr(), row0,
                row_bytes, stream,
            )
        check_launch("rovina_patches", err)
        launches.add()

    return launch


def _device_of(padded_lab: torch.Tensor) -> str:
    if padded_lab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {padded_lab.device}")
    return padded_lab.device.type


def extract_patches(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
) -> torch.Tensor:  # [gh, gw, R, R, 3] uint8
    if _device_of(padded_lab) == "cpu":
        return extract_patches_plain(
            padded_lab, depth_grid, patch_size, reduce_size, stride
        )
    check_patch_inputs(padded_lab, depth_grid, patch_size, stride)
    gh, gw = depth_grid.shape
    r = reduce_size
    out = torch.empty((gh, gw, r, r, 3), dtype=torch.uint8,
                      device=padded_lab.device)
    launcher(padded_lab, depth_grid, patch_size, r, stride, out, 0, 3 * r * r)()
    return out


def _check_rows_out(rows: torch.Tensor, row0: int, num_points: int,
                    patch_bytes: int) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous [N, row_bytes] uint8, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.shape[1] < patch_bytes:
        raise ValueError(f"rows of {rows.shape[1]} B cannot hold {patch_bytes} "
                         "patch bytes")
    if row0 < 0 or row0 + num_points > rows.shape[0]:
        raise ValueError(f"rows [{row0}, {row0 + num_points}) outside a buffer "
                         f"of {rows.shape[0]} rows")


def extract_patches_into_plain(
    padded_lab, depth_grid, patch_size, reduce_size, stride,
    rows: torch.Tensor, row0: int,
) -> None:
    """The plain version of :func:`extract_patches_into`."""
    patches = extract_patches_plain(
        padded_lab, depth_grid, patch_size, reduce_size, stride
    )
    gh, gw = depth_grid.shape
    pc = 3 * reduce_size * reduce_size
    _check_rows_out(rows, row0, gh * gw, pc)
    block = rows[row0 : row0 + gh * gw]
    block[:, :pc] = patches.reshape(gh * gw, pc)
    block[:, pc:] = 0


def extract_patches_into(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
    rows: torch.Tensor,  # [N, row_bytes] uint8
    row0: int,
) -> None:
    """Write point p's patch to ``rows[row0 + p, :R*R*3]`` and zeros after it."""
    if _device_of(padded_lab) == "cpu":
        extract_patches_into_plain(
            padded_lab, depth_grid, patch_size, reduce_size, stride, rows, row0
        )
        return
    check_patch_inputs(padded_lab, depth_grid, patch_size, stride)
    gh, gw = depth_grid.shape
    _check_rows_out(rows, row0, gh * gw, 3 * reduce_size * reduce_size)
    if rows.device != padded_lab.device:
        raise ValueError(f"rows on {rows.device}, image on {padded_lab.device}")
    launcher(padded_lab, depth_grid, patch_size, reduce_size, stride, rows,
             row0, rows.shape[1])()
