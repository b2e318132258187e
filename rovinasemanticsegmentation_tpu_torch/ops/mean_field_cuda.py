"""The map path's mean field on the card: CUDA kernel wrapper.

``csrc/mean_field.cu`` runs the permutohedral filter of the dense CRF
(splat, blur, slice) fused with the Potts update and the block softmax, one
launch a phase: 1 + (d+1) + 1 an iteration, 9 at d = 6, and the same 9 for
the symmetric normalisation's filter of ones. It replaces no TPU kernel: the
JAX package's mean field is XLA ops. The splat sums each vertex's segment of
the sorted stream in float64 in a fixed order (no atomics), so two runs give
the same bits; the blur, slice and softmax are float32, ``expf``, as the
plain version rounds them up to the order of its sums.

``models/crf.py::potts_mean_field_multi_t`` and ``symmetric_norm`` send a
call here when :func:`engages` says so; the plain PyTorch version stays the
CPU path and the path of tensors that require grad. On a CUDA tensor the
kernels take at most :data:`MAX_D1` simplex corners a point and
:data:`MAX_CHANNELS` channels; :func:`engages` raises beyond them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..csrc.build import check_launch, load_kernels
from ..utils.profiling import counter

#: mean-field calls through the kernels (one a CRF map)
launches = counter("mean_field_cuda.launches")

# csrc/mean_field.cu's limits: corners a point (the slice keeps them in
# registers), channels (a splat lane's float64 sums and a slice thread's
# float32 sums sit in registers; the softmax holds a point's energies in 32 KB
# of shared memory), softmax blocks.
MAX_D1 = 16
MAX_CHANNELS = 64
MAX_BLOCKS = 64
# The float4s a row of C channels takes in the kernels (csrc/mean_field.cu's
# FOR_WIDTHS): the least of these that holds C, the rest zero.
ROW_WIDTHS = (1, 5, 16)
_MODE_FILTER, _MODE_NORM = 0, 1


def row_width(c: int) -> int:
    """The float4s of the kernels' rows of ``c`` channels."""
    return next(v for v in ROW_WIDTHS if 4 * v >= c)


def engages(values: Optional[torch.Tensor], barycentric_t: torch.Tensor) -> bool:
    """Whether a filter or mean field of ``values`` ([C, N], or None for the
    filter of ones) on a lattice with these ``barycentric_t`` ([d+1, N])
    takes the kernels: both on a CUDA device, neither requiring grad. On a
    CUDA device, d+1 over :data:`MAX_D1` or C over :data:`MAX_CHANNELS`
    raise ``ValueError``."""
    tensors = [barycentric_t] + ([values] if values is not None else [])
    if any(t.device.type != "cuda" or t.requires_grad for t in tensors):
        return False
    d1 = barycentric_t.shape[0]
    c = 1 if values is None else values.shape[0]
    if not 1 <= d1 <= MAX_D1 or not 1 <= c <= MAX_CHANNELS:
        raise ValueError(
            f"the mean-field kernels take 1 to {MAX_D1} simplex corners and 1 "
            f"to {MAX_CHANNELS} channels, got {d1} and {c}")
    return True


def _alpha(d1: int) -> float:
    """``models/lattice.py::_alpha``, the slice scale 1 / (1 + 2^-d)."""
    return 1.0 / (1.0 + 2.0 ** (-(d1 - 1)))


def _check_lattice(lattice: Sequence[torch.Tensor], n: int,
                   num_vertices: int) -> torch.device:
    """The eight tensors of ``build_lattice_device`` / ``lattice_tensors``:
    device, dtypes, contiguity and shapes -> their device."""
    names = ("sorted_points", "sorted_weights", "seg_starts", "seg_ends",
             "offsets_t", "barycentric_t", "blur_n1", "blur_n2")
    dev = lattice[0].device
    for name, t in zip(names, lattice):
        want = torch.float32 if name in ("sorted_weights", "barycentric_t") \
            else torch.int64
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sp, sw, starts, ends, offsets_t, bary_t, n1, n2 = lattice
    d1 = bary_t.shape[0] if bary_t.dim() == 2 else 0
    m = int(num_vertices)
    shapes = {"sorted_points": (sp.shape, (sw.shape[0],)),
              "sorted_weights": (sw.shape, sp.shape),
              "seg_starts": (starts.shape, (m,)), "seg_ends": (ends.shape, (m,)),
              "offsets_t": (offsets_t.shape, (d1, n)),
              "barycentric_t": (bary_t.shape, (d1, n)),
              "blur_n1": (n1.shape, (d1, m)), "blur_n2": (n2.shape, (d1, m))}
    for name, (got, want) in shapes.items():
        if tuple(got) != tuple(want):
            raise ValueError(f"{name} must be {tuple(want)}, got {tuple(got)}")
    if not 1 <= d1 <= MAX_D1:
        raise ValueError(f"the kernels take 1 to {MAX_D1} simplex corners, "
                         f"got {d1}")
    if max(sp.shape[0], d1 * n, (m + 1) * MAX_CHANNELS) >= 2**31:
        raise ValueError("the kernels' int32 offsets need the stream, the "
                         "corners and the vertices under 2^31")
    return dev


def _vertex_buffers(vec: int, m: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blur's two ping-pong [M+1, 4 vec] buffers (every slot is
    written)."""
    return (torch.empty((m + 1, 4 * vec), dtype=torch.float32, device=dev),
            torch.empty((m + 1, 4 * vec), dtype=torch.float32, device=dev))


def lattice_filter_t(
    values_t: torch.Tensor,  # [C, N] float32
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    num_vertices: int,
    reverse: bool = False,
) -> torch.Tensor:  # [C, N]
    """``models/lattice.py::lattice_filter_t`` in 1 + (d+1) + 1 launches."""
    lattice = (sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
               barycentric_t, blur_n1, blur_n2)
    if values_t.dim() != 2 or values_t.dtype != torch.float32:
        raise ValueError(f"values must be [C, N] float32, got "
                         f"{tuple(values_t.shape)} {values_t.dtype}")
    c, n = values_t.shape
    dev = _check_lattice(lattice, n, num_vertices)
    if values_t.device != dev or not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"values must be on {dev} with 1 to {MAX_CHANNELS} "
                         f"channels, got {values_t.device} and {c}")
    vec = row_width(c)
    # the splat's points-major stream, zero-padded to whole float4s
    rows = F.pad(values_t.T, (0, 4 * vec - c)).contiguous()
    a, b = _vertex_buffers(vec, int(num_vertices), dev)
    out = torch.empty((c, n), dtype=torch.float32, device=dev)
    _filter(rows, c, vec, n, _MODE_FILTER, lattice, num_vertices, reverse, a,
            b, out)
    return out


def symmetric_norm(
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    num_vertices: int,
) -> torch.Tensor:  # [N]
    """``1 / sqrt(filter(ones) + 1e-20)`` (pairwise.cpp:54-56) in 1 + (d+1)
    + 1 launches."""
    lattice = (sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
               barycentric_t, blur_n1, blur_n2)
    n = barycentric_t.shape[-1]
    dev = _check_lattice(lattice, n, num_vertices)
    a, b = _vertex_buffers(1, int(num_vertices), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    _filter(None, 1, 1, n, _MODE_NORM, lattice, num_vertices, False, a, b, out)
    return out


def _filter(rows, c, vec, n, mode, lattice, num_vertices, reverse, a, b, out):
    d1 = lattice[5].shape[0]
    lib = load_kernels()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rovina_lattice_filter(
            None if rows is None else rows.data_ptr(), n, c, vec, mode,
            *(t.data_ptr() for t in lattice), int(num_vertices), d1,
            int(bool(reverse)), _alpha(d1), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), stream)
    check_launch("rovina_lattice_filter", err)


def launcher(
    unary_t: torch.Tensor,  # [sum(blocks), N] float32, any strides
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    norm: torch.Tensor,  # [N] float32
    weight: float,
    blocks: Sequence[int],
    num_vertices: int,
    n_iterations: int,
) -> Tuple[Callable[[], None], torch.Tensor]:
    """The mean field on CUDA tensors, split in two: check the inputs and
    allocate the marginals and scratch now, and return the function that
    launches the 1 + 9 n_iterations kernels (and counts the call) -> (launch,
    marginals [sum(blocks), N] float32), so that the launches alone can be
    timed."""
    lattice = (sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
               barycentric_t, blur_n1, blur_n2)
    if unary_t.dim() != 2 or unary_t.dtype != torch.float32:
        raise ValueError(f"unary must be [C, N] float32, got "
                         f"{tuple(unary_t.shape)} {unary_t.dtype}")
    c, n = unary_t.shape
    dev = _check_lattice(lattice, n, num_vertices)
    blocks = [int(k) for k in blocks]
    if (sum(blocks) != c or min(blocks) < 1 or len(blocks) > MAX_BLOCKS
            or c > MAX_CHANNELS):
        raise ValueError(f"blocks {blocks} must be 1 to {MAX_BLOCKS} positive "
                         f"sizes summing to the unary's {c} <= {MAX_CHANNELS} "
                         f"channels")
    if unary_t.device != dev:
        raise ValueError(f"unary must be on {dev}, got {unary_t.device}")
    if (norm.shape != (n,) or norm.dtype != torch.float32
            or norm.device != dev or not norm.is_contiguous()):
        raise ValueError(f"norm must be a contiguous [{n}] float32 tensor on "
                         f"{dev}, got {tuple(norm.shape)} {norm.dtype} on "
                         f"{norm.device}")
    if n_iterations < 0:
        raise ValueError(f"n_iterations must be >= 0, got {n_iterations}")
    m = int(num_vertices)
    d1 = barycentric_t.shape[0]
    vec = row_width(c)
    a, b = _vertex_buffers(vec, m, dev)
    # q * norm, points-major and zero-padded: the splat's input
    qn = torch.empty((n, 4 * vec), dtype=torch.float32, device=dev)
    q = torch.empty((c, n), dtype=torch.float32, device=dev)
    ends = (ctypes.c_int * len(blocks))(*np.cumsum(blocks).tolist())
    u_sc, u_sp = unary_t.stride()
    lib = load_kernels()

    def launch() -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rovina_mean_field(
                unary_t.data_ptr(), u_sc, u_sp, n, c, vec, ends, len(blocks),
                *(t.data_ptr() for t in lattice), m, d1, _alpha(d1),
                norm.data_ptr(), float(weight), int(n_iterations),
                qn.data_ptr(), a.data_ptr(), b.data_ptr(), q.data_ptr(),
                stream)
        check_launch("rovina_mean_field", err)
        launches.add()

    return launch, q


def potts_mean_field_multi_t(*args, **kwargs) -> torch.Tensor:
    """``models/crf.py::potts_mean_field_multi_t`` (same arguments) in
    1 + 9 n_iterations launches."""
    launch, q = launcher(*args, **kwargs)
    launch()
    return q
