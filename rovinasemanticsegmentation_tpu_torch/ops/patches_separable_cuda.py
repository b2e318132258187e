"""Separable patch resampling on a staged image footprint: CUDA kernel
wrapper (D'').

Replaces ``scripts/exp_patches.py`` (``_kernel_e`` via
``extract_patches_e``), which computes kernel A's function in two stages on
a band of the packed image. On CUDA tensors :func:`extract_patches_separable_into`
packs the padded Lab image into int32 as kernel A does
(``patches_cuda.pack_lab``) and launches ``csrc/patches_separable.cu``: each
block copies its 4 x 8 grid points' image footprint into shared memory, runs
a vertical row stage and a horizontal column stage from it, and writes the
points' packed feature rows (``ops/feature_rows.py``) from ``row0``, zeros
after each patch. A block whose footprint exceeds ``FOOTPRINT_CAP`` bytes
reads its taps from device memory in the same kernel and is counted. On CPU
tensors it runs the plain version of the same stage order,
``ops/patches.py::extract_patches_separable_into_plain``.
:func:`extract_patches_separable` is the ``[gh, gw, R, R, 3]`` view (rows of
``R*R*3`` bytes). All are bit-identical to kernel A and to
``extract_patches_plain``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..csrc.build import (
    MAX_SHARED_BYTES,
    check_launch,
    load_kernels,
)
from .patches import (
    check_patch_inputs,
    check_rows_out,
    extract_patches_separable_into_plain,
    tap_tensors,
)
from ..utils.profiling import counter
from .patches_cuda import pack_lab

launches = counter("patches_separable_cuda.launches")

TILE_ROWS, TILE_COLS = 4, 8  # grid points per block (csrc TY, TX)
# Shared memory for a block's image footprint: hmax <= 33 at stride 2
# (d >= 1.17 m) and ~42 KB per block in all, so five blocks fit an SM.
FOOTPRINT_CAP = 24 * 1024


def separable_shared_bytes(reduce_size: int, row_bytes: int) -> int:
    """Per block: R taps per point (int4), the footprint, the tile's rows
    (16-byte aligned), its half-sizes and their maximum."""
    tile = TILE_ROWS * TILE_COLS
    return (16 * tile * reduce_size + FOOTPRINT_CAP
            + -(-tile * row_bytes // 16) * 16 + 4 * tile + 16)


def _check(padded_lab, depth_grid, patch_size, reduce_size, stride, rows,
           row0) -> None:
    """Inputs both versions take; the block must fit the card."""
    check_patch_inputs(padded_lab, depth_grid, patch_size, stride)
    r = reduce_size
    if r < 1:
        raise ValueError(f"reduce_size must be >= 1, got {r}")
    gh, gw = depth_grid.shape
    check_rows_out(rows, row0, gh * gw, 3 * r * r)
    smem = separable_shared_bytes(r, rows.shape[1])
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"reduce_size {r} with {rows.shape[1]}-B rows needs {smem} B of "
            f"shared memory per block, more than {MAX_SHARED_BYTES} B"
        )
    if padded_lab.shape[0] * padded_lab.shape[1] >= 2**31:
        raise ValueError("the kernel's int32 pixel offsets need Hp * Wp < 2^31")


def extract_patches_separable_into(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
    rows: torch.Tensor,  # [N, row_bytes] uint8
    row0: int,
) -> None:
    """Write point p's patch to ``rows[row0 + p, :R*R*3]`` and zeros after it."""
    _check(padded_lab, depth_grid, patch_size, reduce_size, stride, rows, row0)
    if padded_lab.device.type == "cpu":
        extract_patches_separable_into_plain(
            padded_lab, depth_grid, patch_size, reduce_size, stride, rows, row0
        )
        return
    if rows.device != padded_lab.device:
        raise ValueError(f"rows on {rows.device}, image on {padded_lab.device}")
    launch, _ = launcher(padded_lab, depth_grid, patch_size, reduce_size,
                         stride, rows, row0)
    launch()


def extract_patches_separable(
    padded_lab: torch.Tensor,  # [Hp, Wp, 3] uint8, border = patch_size
    depth_grid: torch.Tensor,  # [gh, gw] float32 metres (<= 0 masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
) -> torch.Tensor:  # [gh, gw, R, R, 3] uint8
    """:func:`extract_patches_separable_into` rows of ``R*R*3`` bytes."""
    gh, gw = depth_grid.shape
    r = reduce_size
    out = torch.empty((gh * gw, 3 * r * r), dtype=torch.uint8,
                      device=padded_lab.device)
    extract_patches_separable_into(padded_lab, depth_grid, patch_size, r, stride,
                                out, 0)
    return out.reshape(gh, gw, r, r, 3)


def launcher(
    padded_lab: torch.Tensor, depth_grid: torch.Tensor, patch_size: int,
    reduce_size: int, stride: int, rows: torch.Tensor, row0: int,
) -> Tuple[Callable[[], None], torch.Tensor]:
    """Kernel D'' on CUDA tensors, split in two: pack the image and make the
    tap tables now, and return (the function that launches the kernel and
    counts the launch, the [1] int32 count of blocks over the footprint cap,
    which each launch adds to), so that the launch alone can be timed."""
    if padded_lab.device.type != "cuda":
        raise ValueError(f"unsupported device {padded_lab.device}")
    _check(padded_lab, depth_grid, patch_size, reduce_size, stride, rows, row0)
    gh, gw = depth_grid.shape
    dev = padded_lab.device
    packed = pack_lab(padded_lab)
    depth = depth_grid.contiguous()
    t0, t1, w0, w1 = tap_tensors(patch_size, reduce_size, dev)
    over_cap = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = load_kernels()

    def launch() -> None:
        if gh * gw == 0:
            return
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_patches_separable(
                packed.data_ptr(), packed.shape[1], depth.data_ptr(), gh, gw,
                t0.data_ptr(), t1.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                patch_size, reduce_size, stride, rows.data_ptr(), row0,
                rows.shape[1], FOOTPRINT_CAP, over_cap.data_ptr(), stream,
            )
        check_launch("rovina_patches_separable", err)
        launches.add()

    return launch, over_cap
