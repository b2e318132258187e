"""Separable patch resampling on planar channels: CUDA kernel wrapper (D').

Replaces ``scripts/exp_patches.py`` (``_kernel_e`` via
``extract_patches_e``), which computes kernel A's function in two stages.
On a CUDA tensor :func:`extract_patches_planar` makes the image planar once
(``[3, Hp, Wp]`` uint8, the counterpart of the TPU kernel's pre-unpack) and
launches ``csrc/patches_planar.cu``, a vertical row stage and a horizontal
column stage through shared memory with coalesced stores; on a CPU tensor it
runs the plain version of the same stage order,
``ops/patches.py::extract_patches_separable_plain``. Both are bit-identical
to kernel A and to ``extract_patches_plain``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..csrc.build import (
    MAX_SHARED_BYTES,
    LaunchCounter,
    check_launch,
    load_kernels,
)
from .patches import (
    check_patch_inputs,
    extract_patches_separable_plain,
    tap_tensors,
)

launches = LaunchCounter()

GROUP = 8  # grid points per block
_MAX_GRID_ROWS = 65535  # CUDA's limit on gridDim.y


def planar_shared_bytes(reduce_size: int, group: int = GROUP) -> int:
    """Per point: R row taps (int4), the half-size, 2R column taps, the
    row-stage sums [3, R, 2R] int32 and the R x R x 3 output bytes."""
    r = reduce_size
    return group * (16 * r + 4 + 4 * 2 * r + 4 * 6 * r * r + 3 * r * r)


def extract_patches_planar(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
) -> torch.Tensor:  # [gh, gw, R, R, 3] uint8
    check_patch_inputs(padded_lab, depth_grid, patch_size, stride)
    r = reduce_size
    if r < 1:
        raise ValueError(f"reduce_size must be >= 1, got {r}")
    smem = planar_shared_bytes(r)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"reduce_size {r} needs {smem} B of shared memory per block, more "
            f"than {MAX_SHARED_BYTES} B"
        )
    gh, gw = depth_grid.shape
    if gh > _MAX_GRID_ROWS:
        raise ValueError(f"at most {_MAX_GRID_ROWS} grid rows, got {gh}")
    if padded_lab.shape[0] * padded_lab.shape[1] >= 2**31:
        raise ValueError("the kernel's int32 pixel offsets need Hp * Wp < 2^31")
    if padded_lab.device.type == "cpu":
        return extract_patches_separable_plain(
            padded_lab, depth_grid, patch_size, r, stride
        )
    launch, out = launcher(padded_lab, depth_grid, patch_size, r, stride)
    launch()
    return out


def launcher(
    padded_lab: torch.Tensor, depth_grid: torch.Tensor, patch_size: int,
    reduce_size: int, stride: int,
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Kernel D' on CUDA tensors, split in two: make the image planar, the
    tap tables and the output now, and return (the function that launches
    the kernel and counts the launch, output), so that the launch alone can
    be timed."""
    if padded_lab.device.type != "cuda":
        raise ValueError(f"unsupported device {padded_lab.device}")
    dev = padded_lab.device
    r = reduce_size
    gh, gw = depth_grid.shape
    planar = padded_lab.permute(2, 0, 1).contiguous()
    depth = depth_grid.contiguous()
    t0, t1, w0, w1 = tap_tensors(patch_size, r, dev)
    out = torch.empty((gh, gw, r, r, 3), dtype=torch.uint8, device=dev)
    lib = load_kernels()

    def launch() -> None:
        if gh * gw == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_patches_planar(
                planar.data_ptr(), planar.shape[1], planar.shape[2],
                depth.data_ptr(), gh, gw,
                t0.data_ptr(), t1.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                patch_size, r, stride, GROUP, out.data_ptr(), stream,
            )
        check_launch("rovina_patches_planar", err)
        launches.add()

    return launch, out
