"""Surface-normal angles at the stride grid: CUDA kernel wrapper.

``csrc/normals.cu`` computes ``ops/normals.py::normal_angles_grid`` in three
launches a frame (column prefix and distance tiles, row scan, box sums and
angle), bit for bit as the plain version computes it on the card. It
replaces no TPU kernel: the JAX package's normals are XLA ops. The kernels
take an integral smoothing size (the saturated chamfer) of at most
:data:`MAX_SIZE`, whose halo sets a tile's shared memory;
:func:`normal_angles_grid` in ``ops/normals.py`` sends a CUDA tensor here
when :func:`engages` says so and keeps the plain version for everything else
(CPU tensors, ``stride=None``, other sizes).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..csrc.build import check_launch, load_kernels
from ..utils.profiling import counter

launches = counter("normals_cuda.launches")

# The largest smoothing size the kernels take (csrc/normals.cu's MAX_ROUNDS):
# a 32-pixel tile with a halo of MAX_SIZE + 1 pixels holds 38.2 KB of shared
# memory.
MAX_SIZE = 16
CHANNELS = 8  # grad_x (3), grad_y (3), valid_x, valid_y


def engages(device: torch.device, normal_smoothing_size: float) -> bool:
    """Whether ``normal_angles_grid`` on ``device`` with this size takes the
    kernels: a CUDA device and an integral size in ``[1, MAX_SIZE]``."""
    size = float(normal_smoothing_size)
    return (device.type == "cuda" and size == int(size)
            and 1 <= size <= MAX_SIZE)


def inner_scan_log_threads(num_rows: int, row_size: int) -> int:
    """log2 of the threads a row that PyTorch's CUDA ``cumsum`` along the
    last dimension gives each row (``get_log_num_threads_x_inner_scan`` in
    ``ATen/native/cuda/ScanUtils.cuh``, in its uint32 arithmetic): a row is
    summed in chunks of twice that many values, which fixes its rounding."""
    lx = (row_size - 1).bit_length()  # the least lx with 2^lx >= row_size
    ly = (num_rows - 1).bit_length()
    return min(max(4, ((9 + lx - ly) & 0xFFFFFFFF) // 2), 9)


def launcher(
    points: torch.Tensor, stride: int, max_depth_change_factor: float,
    normal_smoothing_size: float,
) -> Tuple[Callable[[], None], torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels on a CUDA tensor, split in two: allocate the outputs now,
    and return the function that launches the three kernels (and counts the
    frame) -> (launch, angles [gh, gw] float32, integral image [8, H, W]
    float64 without its zero row and column, distance at the grid [gh, gw]
    float32), so that the launches alone can be timed and the intermediate
    results compared."""
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be [H, W, 3], got {tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise ValueError(f"points must be float32, got {points.dtype}")
    if not engages(points.device, normal_smoothing_size):
        raise ValueError(
            f"the kernels take a CUDA tensor and an integral smoothing size in "
            f"[1, {MAX_SIZE}], got {points.device} and {normal_smoothing_size}")
    s = int(stride)
    if s < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    h, w, _ = points.shape
    if CHANNELS * h * w >= 2**31:
        raise ValueError("the kernels' int32 offsets need 8 * H * W < 2^31")
    gh, gw = -(-h // s), -(-w // s)
    size = int(normal_smoothing_size)
    pts = points.contiguous()
    dev = pts.device
    out = torch.empty((gh, gw), dtype=torch.float32, device=dev)
    dist = torch.empty((gh, gw), dtype=torch.float32, device=dev)
    integ = torch.empty((CHANNELS, h, w), dtype=torch.float64, device=dev)
    log_nx = inner_scan_log_threads(CHANNELS * h, w)
    lib = load_kernels()

    def launch() -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_normals(
                pts.data_ptr(), h, w, s, gh, gw,
                float(max_depth_change_factor), size, log_nx,
                integ.data_ptr(), dist.data_ptr(), out.data_ptr(), stream,
            )
        check_launch("rovina_normals", err)
        launches.add()

    return launch, out, integ, dist


def normal_angles_grid(
    points: torch.Tensor,  # [H, W, 3] float32 on the card, NaN where invalid
    stride: int,
    max_depth_change_factor: float = 0.02,
    normal_smoothing_size: float = 10.0,
) -> torch.Tensor:  # [ceil(H/s), ceil(W/s)] float32 angles, -2 where invalid
    """``ops/normals.py::normal_angles_grid`` in three kernel launches."""
    launch, out, _, _ = launcher(points, stride, max_depth_change_factor,
                                 normal_smoothing_size)
    launch()
    return out
