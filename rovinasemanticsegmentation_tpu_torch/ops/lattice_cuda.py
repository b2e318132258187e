"""The dense CRF's lattice build on the card: CUDA kernel wrapper.

``csrc/lattice_build.cu`` builds the permutohedral lattice of features
``[N, d]`` in a fill and 8 launches at a 30000-point map's 210000 (point,
corner) rows, a few more merge and radix passes for larger inputs: the
embedding with a hash-table insert of every corner key, a sort of the
distinct keys (bitonic tiles, then 16-way merge passes), a stable radix sort
of the (vertex, row) stream, and the blur neighbours by direct lookups. It
replaces no TPU kernel: the JAX package's device build is XLA ops. Its
results are :func:`models.lattice._build_device`'s twelve, bit-equal to the
plain PyTorch build (``_build_device_plain``) on any device, an overflowing
build included, and it reads nothing back to the host.

``models/lattice.py::_build_device`` sends every CUDA tensor here; the plain
build stays the path of every other device. On a CUDA tensor the kernels take
1 to :data:`MAX_D` dimensions and up to :data:`MAX_ROWS` rows, and
:func:`build` raises beyond them: nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..csrc.build import check_launch, load_kernels
from ..utils.profiling import counter

#: lattice builds through the kernels (one a CRF map)
launches = counter("lattice_cuda.launches")

#: feature dimensions the kernels take (d is a template parameter)
MAX_D = 8
#: (point, corner) rows the kernels take: their indices, the table's 2 N (d+1)
#: slots and the merge passes' run widths stay in int32
MAX_ROWS = 1 << 27


def build(features: torch.Tensor, m_bucket: int,
          scale: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """The lattice of CUDA ``features`` [N, d] float32 with ``m_bucket``
    vertex slots, ``scale`` the d float32 elevation scales -> ``(
    sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
    barycentric_t, blur_n1, blur_n2, m, pos_sorted, rem0, rank)``, on the
    features' device and stream, without a synchronisation; counts one
    build."""
    if features.device.type != "cuda":
        raise ValueError(f"features must be a CUDA tensor, got {features.device}")
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = _launch(load_kernels(), features, m_bucket, scale, stream)
    launches.add()
    return out


def _launch(lib, features: torch.Tensor, m_bucket: int, scale: np.ndarray,
            stream) -> Tuple[torch.Tensor, ...]:
    """Check the inputs, allocate the results and the scratch on the
    features' device, and call ``lib.rovina_lattice_build`` on ``stream``."""
    if features.dim() != 2 or features.dtype != torch.float32:
        raise ValueError(f"features must be [N, d] float32, got "
                         f"{tuple(features.shape)} {features.dtype}")
    n, d = features.shape
    d1 = d + 1
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the lattice kernels take 1 to {MAX_D} dimensions, "
                         f"got {d}")
    if not 1 <= n * d1 <= MAX_ROWS:
        raise ValueError(f"the lattice kernels take 1 to {MAX_ROWS} (point, "
                         f"corner) rows, got {n * d1}")
    if not 1 <= m_bucket <= MAX_ROWS:
        raise ValueError(f"m_bucket must be 1 to {MAX_ROWS}, got {m_bucket}")
    scale = np.ascontiguousarray(scale, dtype=np.float32)
    if scale.shape != (d,):
        raise ValueError(f"scale must be [{d}], got {scale.shape}")
    features = features.contiguous()
    s = n * d1
    spad = -(-s // 128) * 128
    dev = features.device

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int64, device=dev)

    def floats(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    nbytes = ctypes.c_longlong()
    check_launch("rovina_lattice_build_scratch",
                 lib.rovina_lattice_build_scratch(n, d, ctypes.addressof(nbytes)))
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    out = (ints(spad), floats(spad), ints(m_bucket), ints(m_bucket), ints(d1, n),
           floats(d1, n), ints(d1, m_bucket), ints(d1, m_bucket), ints(),
           ints(s), floats(n, d1), ints(n, d1))
    err = lib.rovina_lattice_build(
        features.data_ptr(), n, d, scale.ctypes.data, int(m_bucket),
        scratch.data_ptr(), *(t.data_ptr() for t in out), stream)
    check_launch("rovina_lattice_build", err)
    return out
